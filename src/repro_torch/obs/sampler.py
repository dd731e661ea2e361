"""Copy of the reference package's ``obs.sampler`` (pure Python).

Live metric sampling: periodic ``REGISTRY.snapshot()`` into a bounded
ring of timestamped samples, with counter rates derived between ticks.

The registry makes every number *readable* post-mortem; this module makes them
consumable **while the system runs** — the paper's low-latency
worker<->shared-resource feedback (Squire cores polling L2 state) applied
one level up: the scheduler and dispatcher poll their own registry and
feed SLO monitors and controllers (the reference's ``obs.slo`` and
``obs.control``, not ported yet) on the same tick that did the work.

Design constraints, in order:

  * **No background thread.** Sampling is *tick-driven*: the scheduler's
    ``step()``, the kernel service's ``submit()`` and the dispatcher's
    ``run()`` call the module-level :func:`tick` hook, which is a single
    global load + ``None`` check when no sampler is installed (the same
    disabled-cost discipline as the tracer). An optional wall-clock mode
    rate-limits samples to ``min_interval_s`` for long serves.
  * **Bounded memory.** Samples live in a ring (``capacity`` deep);
    steady-state rates survive ring eviction because they only need the
    previous sample.
  * **Counter-reset tolerance.** Registry providers re-register per
    component instance (a benchmark churns through Schedulers), so a
    counter can *decrease* between samples. A negative delta means reset,
    not negative traffic — the rate for that key is skipped for that
    sample (Prometheus counter semantics).

Each :class:`Sample` carries the numeric snapshot (``values``) and the
per-second deltas vs the previous sample (``rates`` — tokens/sec, swap
bytes/sec, compile events/sec...). Listeners (the SLO manager) run
synchronously on every new sample; ``export_jsonl`` writes the ring as a
time-series next to the Chrome trace, and ``counter_tracks`` mirrors
chosen series into the tracer as Perfetto counter ('C') events so the
levels line up with the span tracks in one UI.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


@dataclasses.dataclass
class Sample:
    """One timestamped registry snapshot.

    ``values`` is the numeric subset of ``Registry.snapshot()`` (strings
    dropped — rules index numbers). ``rates`` maps the same keys to
    per-second deltas vs the previous sample; keys whose delta was
    negative (provider re-registration reset the counter) are absent.
    """
    t: float                    # perf_counter stamp
    tick: int                   # ticks seen when this sample was taken
    values: Dict[str, float]
    rates: Dict[str, float]


class Sampler:
    """Tick-driven snapshot ring + rate derivation + listeners."""

    def __init__(self, registry: Optional[_metrics.Registry] = None,
                 every_ticks: int = 1, min_interval_s: float = 0.0,
                 wall_clock: bool = False, capacity: int = 1024,
                 tracer: Optional[_trace.Tracer] = None,
                 counter_tracks: Sequence[Tuple[str, str]] = ()):
        """``every_ticks``: sample every N-th tick (tick mode).
        ``wall_clock=True``: ignore tick counts and sample whenever
        ``min_interval_s`` wall time has passed since the last sample
        (``min_interval_s`` also lower-bounds tick mode when set).
        ``counter_tracks``: ``(key, 'value'|'rate')`` pairs mirrored into
        the tracer as Perfetto counter events on the ``metrics`` track.
        """
        if every_ticks < 1:
            raise ValueError("every_ticks must be >= 1")
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.every_ticks = every_ticks
        self.min_interval_s = min_interval_s
        self.wall_clock = wall_clock
        self.samples: "collections.deque[Sample]" = collections.deque(
            maxlen=capacity)
        self._tracer = tracer
        self.counter_tracks = tuple(counter_tracks)
        self._listeners: List[Callable[[Sample], None]] = []
        self.ticks = 0
        self.sample_count = 0           # monotonic (ring may evict)
        self._last_t: Optional[float] = None
        self._last_tick = 0
        self._prev: Optional[Sample] = None
        self._sampling = False          # re-entrancy guard

    @property
    def tracer(self) -> _trace.Tracer:
        return self._tracer if self._tracer is not None \
            else _trace.get_tracer()

    def add_listener(self, fn: Callable[[Sample], None]):
        """``fn(sample)`` runs synchronously after every new sample (the
        SLO manager's entry point)."""
        self._listeners.append(fn)

    # -- tick / sample ---------------------------------------------------

    def tick(self, source: str = "") -> Optional[Sample]:
        """One unit of work happened (a scheduler step, a bulk submit);
        take a sample if the cadence says so. Returns the new sample or
        None."""
        self.ticks += 1
        now = time.perf_counter()
        if self._last_t is not None:
            if now - self._last_t < self.min_interval_s:
                return None
            if not self.wall_clock and \
                    self.ticks - self._last_tick < self.every_ticks:
                return None
        return self.sample(now)

    def sample(self, now: Optional[float] = None) -> Optional[Sample]:
        """Snapshot unconditionally (ticks aside). Re-entrant calls are
        dropped: a listener that triggers more work (an autotune re-sweep
        dispatching kernels) must not recurse into sampling."""
        if self._sampling:
            return None
        self._sampling = True
        try:
            now = time.perf_counter() if now is None else now
            values = {k: float(v)
                      for k, v in self.registry.snapshot().items()
                      if isinstance(v, (int, float))
                      and not isinstance(v, bool)}
            rates: Dict[str, float] = {}
            prev = self._prev
            if prev is not None and now > prev.t:
                dt = now - prev.t
                for k, v in values.items():
                    v0 = prev.values.get(k)
                    if v0 is not None and v >= v0:
                        rates[k] = (v - v0) / dt
            s = Sample(t=now, tick=self.ticks, values=values, rates=rates)
            self.samples.append(s)
            self.sample_count += 1
            self._prev = s
            self._last_t = now
            self._last_tick = self.ticks
            self._emit_counter_tracks(s)
            for fn in self._listeners:
                fn(s)
            return s
        finally:
            self._sampling = False

    def _emit_counter_tracks(self, s: Sample):
        tr = self.tracer
        if not tr.enabled or not self.counter_tracks:
            return
        for key, mode in self.counter_tracks:
            src = s.rates if mode == "rate" else s.values
            v = src.get(key)
            if v is not None:
                tr.counter(f"{key}/s" if mode == "rate" else key,
                           "metrics", value=v)

    # -- reading the series ----------------------------------------------

    def series(self, key: str, source: str = "value"
               ) -> List[Tuple[float, float]]:
        """``[(t, v)]`` for one key over the retained ring
        (``source='rate'`` reads the derived per-second series)."""
        out = []
        for s in self.samples:
            v = (s.rates if source == "rate" else s.values).get(key)
            if v is not None:
                out.append((s.t, v))
        return out

    def steady_rate(self, key: str, skip: int = 1) -> Optional[float]:
        """Overall per-second rate of a counter between sample ``skip``
        (warmup excluded) and the last retained sample — the steady-state
        number bench_history folds into BENCH_*.json. None when fewer
        than two usable samples or on counter reset."""
        ss = list(self.samples)
        if len(ss) <= skip + 1:
            return None
        a, b = ss[skip], ss[-1]
        va, vb = a.values.get(key), b.values.get(key)
        if va is None or vb is None or vb < va or b.t <= a.t:
            return None
        return (vb - va) / (b.t - a.t)

    # -- export ----------------------------------------------------------

    def export_jsonl(self, path: str):
        """One sample per line: ``{"t", "tick", "values", "rates"}`` —
        the grep/pandas-friendly time-series next to the Chrome trace."""
        with open(path, "w") as f:
            for s in self.samples:
                f.write(json.dumps(
                    {"t": s.t, "tick": s.tick, "values": s.values,
                     "rates": s.rates}, sort_keys=True) + "\n")

    def metrics(self) -> Dict[str, Any]:
        """Registry ``obs.sampler`` provider (the sampler observes
        itself: sample cadence drift is an observability failure too)."""
        return {"ticks": self.ticks, "samples": self.sample_count,
                "retained": len(self.samples)}


# ---------------------------------------------------------------------------
# process-wide hook: components tick the installed sampler, if any
# ---------------------------------------------------------------------------

_SAMPLER: Optional[Sampler] = None


def get_sampler() -> Optional[Sampler]:
    return _SAMPLER


def set_sampler(sampler: Optional[Sampler]) -> Optional[Sampler]:
    """Install ``sampler`` process-wide (None uninstalls); returns the
    previous one. Registers it as the registry's ``obs.sampler``
    provider so snapshots include the sampler's own cadence counters."""
    global _SAMPLER
    prev, _SAMPLER = _SAMPLER, sampler
    if sampler is not None:
        sampler.registry.register_provider("obs.sampler", sampler)
    return prev


def tick(source: str = ""):
    """The hot-path hook (Scheduler.step / KernelService.submit /
    Dispatcher.run): one global load + None check when no sampler is
    installed."""
    s = _SAMPLER
    if s is not None:
        s.tick(source)
