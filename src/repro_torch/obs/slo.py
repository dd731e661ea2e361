"""Copy of the reference package's ``obs.slo`` (pure Python).

Declarative SLO monitors with hysteresis over sampled metric series.

A :class:`Rule` states an objective over the live registry — ``serve.
ttft_ms.p95 < 500``, ``serve.queue_head_wait_s < 0.25``, a useful-
occupancy floor, a ``paging.swap_rejected`` rate ceiling — and a
:class:`Monitor` tracks it with hysteresis: ``fire_after`` *consecutive*
breaching samples to raise the alert, ``clear_after`` consecutive
conforming samples to clear it. Hysteresis is what makes the alert
*actionable*: a single noisy sample must neither throttle the scheduler
nor flap it back.

The :class:`SLOManager` is a sampler listener (``sampler.add_listener
(mgr.on_sample)``): each new :class:`~repro_torch.obs.sampler.Sample` is
evaluated against every rule, and transitions emit

  * structured trace events — ``slo-fire`` / ``slo-clear`` instants on
    the ``slo`` track (a Perfetto open shows the alert next to the
    scheduler spans that caused it), and
  * registry metrics under ``obs.slo.<rule>.*`` — ``firing`` gauge
    (0/1), ``fired`` / ``cleared`` counters, ``breaches`` counter — so
    alerts are themselves sampled series.

Controllers (``repro_torch.obs.control``) subscribe for ``on_fire(rule,
value)`` / ``on_clear(rule, value)`` callbacks; the manager guarantees
fire/clear strictly alternate per rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.sampler import Sample

#: objective comparators: the SLO HOLDS when ``op(value, threshold)``
_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative objective: ``<key> <op> <threshold>`` must hold.

    ``source`` picks the series: ``'value'`` reads the sampled level,
    ``'rate'`` the derived per-second delta (``swap_rejected`` rate).
    ``value_fn`` is the escape hatch for computed series (e.g. a
    compile-vs-execute ratio over two keys) — it receives ``(values,
    rates)`` and returns the number to test, or None to skip the sample
    (no hysteresis state change). A missing ``key`` likewise skips.
    """
    name: str
    key: str = ""
    op: str = "<"
    threshold: float = 0.0
    source: str = "value"               # 'value' | 'rate'
    fire_after: int = 3                 # N consecutive breaches to fire
    clear_after: int = 2                # M consecutive OKs to clear
    value_fn: Optional[Callable[[Dict[str, float], Dict[str, float]],
                                Optional[float]]] = None

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: op {self.op!r} not in "
                             f"{sorted(_OPS)}")
        if self.source not in ("value", "rate"):
            raise ValueError(f"rule {self.name!r}: source {self.source!r}")
        if self.fire_after < 1 or self.clear_after < 1:
            raise ValueError(f"rule {self.name!r}: fire_after/clear_after "
                             f"must be >= 1")
        if not self.key and self.value_fn is None:
            raise ValueError(f"rule {self.name!r}: need key or value_fn")

    def extract(self, values: Dict[str, float],
                rates: Dict[str, float]) -> Optional[float]:
        if self.value_fn is not None:
            return self.value_fn(values, rates)
        src = rates if self.source == "rate" else values
        return src.get(self.key)

    def holds(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)


class Monitor:
    """Hysteresis state machine for one rule.

    Exactly-per-N/M semantics (the property test pins them): the alert
    fires on the sample completing the ``fire_after``-th *consecutive*
    breach while not firing, and clears on the sample completing the
    ``clear_after``-th consecutive OK while firing. Any conforming
    sample resets the breach streak and vice versa.
    """

    def __init__(self, rule: Rule):
        self.rule = rule
        self.firing = False
        self.breach_streak = 0
        self.ok_streak = 0
        self.last_value: Optional[float] = None

    def observe(self, value: float) -> Optional[str]:
        """Feed one sample's value; returns 'fire' | 'clear' | None."""
        self.last_value = value
        if self.rule.holds(value):
            self.ok_streak += 1
            self.breach_streak = 0
            if self.firing and self.ok_streak >= self.rule.clear_after:
                self.firing = False
                return "clear"
            return None
        self.breach_streak += 1
        self.ok_streak = 0
        if not self.firing and self.breach_streak >= self.rule.fire_after:
            self.firing = True
            return "fire"
        return None


class SLOManager:
    """Evaluate rules per sample; emit events, metrics and callbacks."""

    def __init__(self, rules: List[Rule],
                 registry: Optional[_metrics.Registry] = None,
                 tracer: Optional[_trace.Tracer] = None):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.monitors: Dict[str, Monitor] = {r.name: Monitor(r)
                                             for r in rules}
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self._tracer = tracer
        self._subscribers: List[Any] = []
        # pre-declare so the alert namespace is stable from construction
        for name in self.monitors:
            self.registry.gauge(f"obs.slo.{name}.firing").set(0)
            self.registry.counter(f"obs.slo.{name}.fired")
            self.registry.counter(f"obs.slo.{name}.cleared")
            self.registry.counter(f"obs.slo.{name}.breaches")

    @property
    def tracer(self) -> _trace.Tracer:
        return self._tracer if self._tracer is not None \
            else _trace.get_tracer()

    def subscribe(self, controller: Any):
        """``controller.on_fire(rule, value)`` / ``.on_clear(rule,
        value)`` run synchronously on transitions, in subscription
        order."""
        self._subscribers.append(controller)

    @property
    def firing(self) -> Dict[str, bool]:
        return {name: m.firing for name, m in self.monitors.items()}

    def on_sample(self, sample: Sample):
        """Sampler listener: one hysteresis step per rule."""
        self.evaluate(sample.values, sample.rates)

    def evaluate(self, values: Dict[str, float],
                 rates: Dict[str, float]) -> List[str]:
        """Feed one sample to every monitor; returns the transition
        events emitted (``'<rule>:fire'`` / ``'<rule>:clear'``)."""
        out: List[str] = []
        for name, mon in self.monitors.items():
            value = mon.rule.extract(values, rates)
            if value is None:
                continue
            if not mon.rule.holds(value):
                self.registry.counter(f"obs.slo.{name}.breaches").inc()
            transition = mon.observe(value)
            if transition is None:
                continue
            out.append(f"{name}:{transition}")
            fired = transition == "fire"
            self.registry.gauge(f"obs.slo.{name}.firing").set(
                1 if fired else 0)
            self.registry.counter(
                f"obs.slo.{name}.{'fired' if fired else 'cleared'}").inc()
            self.tracer.instant(f"slo-{transition}", "slo", rule=name,
                                key=mon.rule.key or "<fn>",
                                value=round(value, 6),
                                op=mon.rule.op,
                                threshold=mon.rule.threshold)
            for sub in self._subscribers:
                hook = getattr(sub, "on_fire" if fired else "on_clear",
                               None)
                if hook is not None:
                    hook(mon.rule, value)
        return out


# ---------------------------------------------------------------------------
# the serving defaults: the ROADMAP's SLO set, thresholds caller-tunable
# ---------------------------------------------------------------------------

def default_serve_rules(queue_wait_s: float = 0.25,
                        ttft_p95_ms: float = 2000.0,
                        itl_p95_ms: float = 500.0,
                        swap_rejected_per_s: float = 1.0,
                        occupancy_floor: float = 0.0,
                        fire_after: int = 3,
                        clear_after: int = 2) -> List[Rule]:
    """The standard serving objectives over the scheduler's registry
    namespace. ``occupancy_floor=0`` disables the floor (a drained pool
    legitimately idles at 0)."""
    rules = [
        Rule("queue_wait", key="serve.queue_head_wait_s", op="<",
             threshold=queue_wait_s, fire_after=fire_after,
             clear_after=clear_after),
        Rule("ttft_p95", key="serve.ttft_ms.p95", op="<",
             threshold=ttft_p95_ms, fire_after=fire_after,
             clear_after=clear_after),
        Rule("itl_p95", key="serve.itl_ms.p95", op="<",
             threshold=itl_p95_ms, fire_after=fire_after,
             clear_after=clear_after),
        Rule("swap_rejected", key="paging.swap_rejected", op="<",
             threshold=swap_rejected_per_s, source="rate",
             fire_after=fire_after, clear_after=clear_after),
    ]
    if occupancy_floor > 0.0:
        rules.append(Rule("occupancy_floor", key="serve.mean_occupancy",
                          op=">=", threshold=occupancy_floor,
                          fire_after=fire_after, clear_after=clear_after))
    return rules
