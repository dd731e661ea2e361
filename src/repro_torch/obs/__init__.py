"""Observability for the port (copies of the reference's pure-Python
``repro.obs`` modules): the metrics registry, the tracer, the tick-driven
sampler, declarative SLO monitors with hysteresis, the controllers that act
on their alerts (backpressure on the scheduler, bounded online autotune
re-sweeps) and the schemas that pin the ``stats()`` keys and the Chrome
trace format. The reference's ``instrumented_jit`` has no counterpart:
PyTorch runs eagerly."""

from repro_torch.obs.control import (AutotuneController,
                                     BackpressureController, build_serve_loop,
                                     dispatch_imbalance_rule)
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     Registry, get_registry)
from repro_torch.obs.sampler import Sample, Sampler, get_sampler, set_sampler
from repro_torch.obs.schema import (PAGED_STATS, SCHEDULER_STATS,
                                    SLOTS_STATS, validate_chrome_trace,
                                    validate_stats)
from repro_torch.obs.slo import Monitor, Rule, SLOManager, default_serve_rules
from repro_torch.obs.trace import Event, Tracer, get_tracer, set_tracer

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "Registry",
           "get_registry", "PAGED_STATS", "SCHEDULER_STATS",
           "SLOTS_STATS", "validate_chrome_trace", "validate_stats",
           "Event", "Tracer", "get_tracer", "set_tracer", "Sample",
           "Sampler", "get_sampler", "set_sampler", "Monitor", "Rule",
           "SLOManager", "default_serve_rules", "AutotuneController",
           "BackpressureController", "build_serve_loop",
           "dispatch_imbalance_rule"]
