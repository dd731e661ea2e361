"""Copy of the reference package's ``obs.trace`` (pure Python), without
``instrumented_jit``: PyTorch runs eagerly, so there is no jit to wrap.

Structured tracer: a bounded ring of typed span/instant events.

The paper reasons about where *cycles* go (sync overhead vs compute,
Fig. 7); the serving runtime needs the same story for where *ticks* go —
which slot was prefilling, decoding, swapped out or idle at every
moment. Components record events through a context-manager/stamp API
that compiles to a no-op when the tracer is disabled (the hot decode
loop pays one attribute check per event site), into a bounded ring
buffer (oldest events drop, ``dropped`` counts them — tracing never
OOMs a long serve).

Event kinds (``name`` on a ``track``):

  scheduler track  — ``decode-tick``, ``prefill-chunk`` spans; ``admit``
                     instants
  slot<N> tracks   — per-request phase spans ``prefill`` / ``decode``
                     (args carry the rid) bracketed by ``admit`` /
                     ``retire`` / ``preempt`` / ``swap-out`` /
                     ``swap-in`` instants
  dispatcher track — ``bucket-dispatch`` spans

Exporters:

  * ``export_jsonl``  — one event dict per line (grep/pandas-friendly).
  * ``export_chrome`` — Chrome trace-event JSON: open chrome://tracing
    or https://ui.perfetto.dev and drop the file in. One thread (track)
    per slot plus scheduler/dispatcher threads, named and sorted.

``get_tracer()`` returns the process-wide tracer (disabled by default);
benchmarks/examples enable tracing by installing their own with
``set_tracer(Tracer(enabled=True))`` or by passing a Tracer explicitly
to the component (``Scheduler(..., tracer=t)``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs import metrics as _metrics


@dataclasses.dataclass
class Event:
    """One trace event. ``ph`` follows the Chrome trace-event phases:
    'X' = complete span (``dur`` > 0 possible), 'i' = instant,
    'C' = counter sample (args carry the numeric series values)."""
    name: str
    track: str
    ph: str                     # 'X' | 'i' | 'C'
    ts: float                   # perf_counter seconds (span start)
    dur: float = 0.0            # seconds ('X' only)
    args: Optional[Dict[str, Any]] = None


class _Noop:
    """Shared do-nothing context manager — the disabled-tracer fast
    path allocates nothing per span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    """Open span: records a complete event at __exit__."""

    __slots__ = ("tracer", "name", "track", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, track: str, args):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer.complete(self.name, self.track, self.t0,
                             time.perf_counter(), **(self.args or {}))
        return False


class Tracer:
    """Bounded ring buffer of Events; disabled == hard no-op."""

    def __init__(self, enabled: bool = False, capacity: int = 65536):
        self.enabled = enabled
        self.capacity = capacity
        self.events: "collections.deque[Event]" = collections.deque(
            maxlen=capacity)
        self.dropped = 0        # ring overwrites (oldest-first)

    # -- recording -------------------------------------------------------

    def _push(self, ev: Event):
        if len(self.events) == self.capacity:
            # ring overflow is data LOSS, not just recycling: count it
            # both locally (export metadata) and in the registry so a
            # sampler/SLO rule can alarm on a drop rate — a silent ring
            # overwrite would undermine every trace-derived conclusion
            self.dropped += 1
            _metrics.REGISTRY.counter("obs.trace.dropped").inc()
        self.events.append(ev)

    def span(self, name: str, track: str, **args):
        """``with tracer.span("decode-tick", "scheduler", live=3):`` —
        records a complete event at exit; the shared no-op when
        disabled."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, track, args or None)

    def instant(self, name: str, track: str, **args):
        if not self.enabled:
            return
        self._push(Event(name, track, "i", time.perf_counter(),
                         args=args or None))

    def counter(self, name: str, track: str, **values):
        """Counter sample ('C'): Perfetto renders one counter track per
        ``name`` with the numeric ``values`` series stacked — the
        sampler's live metric feeds (``tokens_per_s``, ``blocks_free``)
        next to the span tracks, so a throttling decision lines up with
        the level that triggered it."""
        if not self.enabled:
            return
        self._push(Event(name, track, "C", time.perf_counter(),
                         args={k: float(v) for k, v in values.items()}))

    def complete(self, name: str, track: str, t0: float, t1: float,
                 **args):
        """Record a span whose endpoints the caller stamped (phases that
        straddle many scheduler ticks can't use the context manager)."""
        if not self.enabled:
            return
        self._push(Event(name, track, "X", t0, max(t1 - t0, 0.0),
                         args=args or None))

    def clear(self):
        self.events.clear()
        self.dropped = 0

    # -- export ----------------------------------------------------------

    @staticmethod
    def _track_order(track: str):
        """scheduler, dispatcher, then slots in numeric order."""
        if track == "scheduler":
            return (0, 0, track)
        if track == "dispatcher":
            return (1, 0, track)
        if track.startswith("slot") and track[4:].isdigit():
            return (2, int(track[4:]), track)
        return (3, 0, track)

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto-loadable): one pid,
        one named+sorted tid per track, ts/dur in microseconds relative
        to the first event."""
        evs = list(self.events)
        t_base = min((e.ts for e in evs), default=0.0)
        tracks = sorted({e.track for e in evs}, key=self._track_order)
        tid = {t: i for i, t in enumerate(tracks)}
        out: List[Dict[str, Any]] = []
        for t in tracks:
            out.append({"ph": "M", "pid": 1, "tid": tid[t],
                        "name": "thread_name", "args": {"name": t}})
            out.append({"ph": "M", "pid": 1, "tid": tid[t],
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid[t]}})
        for e in evs:
            d: Dict[str, Any] = {"name": e.name, "ph": e.ph, "pid": 1,
                                 "tid": tid[e.track],
                                 "ts": (e.ts - t_base) * 1e6}
            if e.ph == "X":
                d["dur"] = e.dur * 1e6
            elif e.ph == "i":
                d["s"] = "t"                # instant scope: thread
            # 'C' (counter) carries its series in args, nothing extra
            if e.args:
                d["args"] = dict(e.args)
            out.append(d)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def export_jsonl(self, path: str):
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps({
                    "name": e.name, "track": e.track, "ph": e.ph,
                    "ts": e.ts, "dur": e.dur, "args": e.args or {}},
                    default=str) + "\n")


#: process-wide tracer, disabled by default (every event site is then a
#: single attribute check)
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` process-wide; returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev
