"""Observability for the port: copies of the reference's pure-Python
metrics registry, tracer and tick-driven sampler. The SLO monitors,
controllers and schemas come with the serving slice."""

from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     Registry, get_registry)
from repro_torch.obs.sampler import Sample, Sampler, get_sampler, set_sampler
from repro_torch.obs.trace import Event, Tracer, get_tracer, set_tracer

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "Registry",
           "get_registry", "Sample", "Sampler", "get_sampler", "set_sampler",
           "Event", "Tracer", "get_tracer", "set_tracer"]
