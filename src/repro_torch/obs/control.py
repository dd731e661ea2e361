"""Copy of the reference package's ``obs.control`` (pure Python).

Controllers: pluggable actuators closing the observe -> decide -> act
loop that the sampler + SLO monitors open.

The paper's Squire workers react to shared-resource state at fine grain
instead of being statically scheduled; these controllers give the serving
layer the same reflexes. Each subscribes to an :class:`~repro_torch.obs.slo.
SLOManager` and actuates on alert transitions — and every actuation is
itself observable: a trace instant on the ``control`` track plus
``obs.control.*`` registry counters, so a Perfetto open shows *why* the
scheduler throttled, right next to the SLO alert and the queue levels
that caused it.

Invariant (the forced-overload differential in
``tests/test_torch_obs_loop.py``): controllers may change **timing and
admission only**, never outputs: under greedy sampling the token streams
with a controller engaged are the uncontrolled run's. Both actuators below
satisfy it by construction: capping admissions only delays FCFS admission,
and flipping the preempt policy toward swap takes the resume path that
continues a request where it stopped. (On the card a capped admission
changes the widths of chunk sub-batches, and a GEMM at another width may
round otherwise, so there the streams are held to the uncontrolled run's
up to near-ties.)

  * :class:`BackpressureController` — overload reflex: while the
    queue-wait SLO fires, cap admissions per scheduler tick and prefer
    swap-preemption (preserve work when the pool thrashes); restore the
    configured FCFS behavior when the alert clears.
  * :class:`AutotuneController` — online tuning: a sustained
    compile-vs-execute imbalance on a dispatch bucket triggers a bounded
    ``Autotuner.retune`` re-sweep of that bucket's knob, applied only on
    measured improvement (never a regression by construction).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.slo import Rule


class _ControllerBase:
    def __init__(self, registry: Optional[_metrics.Registry],
                 tracer: Optional[_trace.Tracer]):
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self._tracer = tracer

    @property
    def tracer(self) -> _trace.Tracer:
        return self._tracer if self._tracer is not None \
            else _trace.get_tracer()


class BackpressureController(_ControllerBase):
    """Cap admissions / flip preempt policy while an SLO alert fires.

    Binds to a live :class:`~repro_torch.serve.scheduler.Scheduler` and one
    rule name (default ``'queue_wait'``). On fire it saves the
    scheduler's knobs, installs ``admit_cap`` admissions-per-tick and
    (when the scheduler can swap) a ``'swap'`` preempt override; on
    clear it restores exactly what it saved — the configured behavior
    returns the moment the breach ends.
    """

    def __init__(self, scheduler, rule_name: str = "queue_wait",
                 admit_cap: int = 1, preempt: Optional[str] = "swap",
                 registry: Optional[_metrics.Registry] = None,
                 tracer: Optional[_trace.Tracer] = None):
        super().__init__(registry, tracer)
        if admit_cap < 1:
            raise ValueError("admit_cap must be >= 1 (0 would starve "
                             "the pool and break the progress guarantee)")
        self.scheduler = scheduler
        self.rule_name = rule_name
        self.admit_cap = admit_cap
        self.preempt = preempt
        self.engaged = False
        self._saved = None
        self.registry.counter("obs.control.backpressure.engaged")
        self.registry.counter("obs.control.backpressure.released")
        self.registry.gauge("obs.control.backpressure.active").set(0)

    def on_fire(self, rule: Rule, value: float):
        if rule.name != self.rule_name or self.engaged:
            return
        sched = self.scheduler
        self._saved = (sched.admit_cap, sched.preempt_override)
        sched.admit_cap = self.admit_cap
        # only actuate the preempt flip where swap exists (paged pools);
        # the override is a no-op on contiguous backings anyway but keep
        # the recorded actuation honest
        if self.preempt is not None and sched.slots.paged:
            sched.preempt_override = self.preempt
        self.engaged = True
        self.registry.counter("obs.control.backpressure.engaged").inc()
        self.registry.gauge("obs.control.backpressure.active").set(1)
        self.tracer.instant("backpressure-on", "control", rule=rule.name,
                            value=round(value, 6),
                            admit_cap=self.admit_cap,
                            preempt=sched.preempt_policy)

    def on_clear(self, rule: Rule, value: float):
        if rule.name != self.rule_name or not self.engaged:
            return
        sched = self.scheduler
        sched.admit_cap, sched.preempt_override = self._saved
        self._saved = None
        self.engaged = False
        self.registry.counter("obs.control.backpressure.released").inc()
        self.registry.gauge("obs.control.backpressure.active").set(0)
        self.tracer.instant("backpressure-off", "control", rule=rule.name,
                            value=round(value, 6))


class AutotuneController(_ControllerBase):
    """Bounded online re-sweep of one knob when its bucket's
    compile-vs-execute split goes out of balance.

    ``apply(best_value)`` is the caller's installer (e.g. rebuild a
    ServiceConfig); it runs only when :meth:`~repro_torch.runtime.autotune.
    Autotuner.retune` measured a genuine improvement over the incumbent.
    ``cooldown_s`` rate-limits re-sweeps — a persistent breach must not
    burn the serve's cycles re-measuring every sample.
    """

    def __init__(self, tuner, key: str, candidates,
                 make_thunk: Callable[[Any], Callable[[], Any]],
                 apply: Optional[Callable[[Any], None]] = None,
                 rule_name: str = "dispatch_imbalance",
                 cooldown_s: float = 30.0,
                 registry: Optional[_metrics.Registry] = None,
                 tracer: Optional[_trace.Tracer] = None):
        super().__init__(registry, tracer)
        self.tuner = tuner
        self.key = key
        self.candidates = candidates
        self.make_thunk = make_thunk
        self.apply = apply
        self.rule_name = rule_name
        self.cooldown_s = cooldown_s
        self._last_sweep: Optional[float] = None
        self.resweeps = 0
        self.applied = 0
        self.registry.counter("obs.control.autotune.resweeps")
        self.registry.counter("obs.control.autotune.applied")

    def on_fire(self, rule: Rule, value: float):
        if rule.name != self.rule_name:
            return
        now = time.perf_counter()
        if self._last_sweep is not None and \
                now - self._last_sweep < self.cooldown_s:
            return
        self._last_sweep = now
        t0 = time.perf_counter()
        best, improved = self.tuner.retune(self.key, self.candidates,
                                           self.make_thunk)
        self.resweeps += 1
        self.registry.counter("obs.control.autotune.resweeps").inc()
        if improved:
            self.applied += 1
            self.registry.counter("obs.control.autotune.applied").inc()
            if self.apply is not None:
                self.apply(best)
        self.tracer.complete("autotune-resweep", "control", t0,
                             time.perf_counter(), key=self.key,
                             best=str(best), applied=improved,
                             trigger=round(value, 6))

    def on_clear(self, rule: Rule, value: float):
        pass                    # nothing to undo: retune never regresses


def dispatch_imbalance_rule(bucket_key: str, ratio: float = 1.0,
                            min_execute_ms: float = 1.0,
                            fire_after: int = 2, clear_after: int = 2
                            ) -> Rule:
    """Rule for the AutotuneController: fire when a dispatch bucket's
    cumulative compile wall exceeds ``ratio`` x its execute wall (the
    bucket keeps paying compiles instead of amortizing them — the knob
    choice is wrong for the traffic). ``bucket_key`` is the
    ``runtime.dispatch.bucket`` name, e.g. ``'run[b32]'``; samples where
    the bucket has executed under ``min_execute_ms`` are skipped (no
    signal yet). The port has no compile: its dispatcher records a
    bucket's first-use host ms under the reference's ``compile_ms`` name."""
    c_key = f"runtime.dispatch.bucket.{bucket_key}.compile_ms"
    e_key = f"runtime.dispatch.bucket.{bucket_key}.execute_ms"

    def balance(values: Dict[str, float], rates: Dict[str, float]
                ) -> Optional[float]:
        execute = values.get(e_key, 0.0)
        if execute < min_execute_ms:
            return None
        return values.get(c_key, 0.0) / execute

    return Rule("dispatch_imbalance", op="<=", threshold=ratio,
                value_fn=balance, fire_after=fire_after,
                clear_after=clear_after)


# ---------------------------------------------------------------------------
# one-call wiring: sampler + monitors + backpressure on a scheduler
# ---------------------------------------------------------------------------

def build_serve_loop(scheduler, rules: Optional[List[Rule]] = None,
                     controllers: Optional[Iterable[Any]] = None,
                     sampler_kw: Optional[Dict[str, Any]] = None,
                     install: bool = True, **rule_kw):
    """Wire the standard closed loop onto a scheduler: a Sampler ticking
    off ``Scheduler.step``, the default serve rules (``rule_kw``
    forwards thresholds to :func:`~repro_torch.obs.slo.default_serve_rules`),
    and a :class:`BackpressureController`. Returns ``(sampler, slo,
    controllers)``; with ``install=True`` the sampler is installed
    process-wide (undo with ``set_sampler(prev)`` — the previous sampler
    is NOT returned here, use ``repro_torch.obs.sampler.set_sampler``
    directly for nesting)."""
    from repro_torch.obs import sampler as _sampler
    from repro_torch.obs.slo import SLOManager, default_serve_rules

    if rules is None:
        rules = default_serve_rules(**rule_kw)
    smp = _sampler.Sampler(**(sampler_kw or {}))
    slo = SLOManager(rules)
    if controllers is None:
        controllers = [BackpressureController(scheduler)]
    for c in controllers:
        slo.subscribe(c)
    smp.add_listener(slo.on_sample)
    if install:
        _sampler.set_sampler(smp)
    return smp, slo, list(controllers)
