"""LM serving (port of ``repro.serve``): the engine's prefill / decode /
chunked-prefill steps and per-request ``generate``, the slot pool
(contiguous or paged: block pools, preemption by recompute or swap, prefix
sharing, window rings) and the continuous-batching scheduler. Speculative
decoding and the sharded pool come with later slices."""

from repro_torch.serve.engine import SamplingPolicy, generate, sample_token
from repro_torch.serve.scheduler import (Completion, RequestCache, Scheduler,
                                         SchedulerConfig)
from repro_torch.serve.slots import SlotManager

__all__ = ["Completion", "RequestCache", "SamplingPolicy", "Scheduler",
           "SchedulerConfig", "SlotManager", "generate", "sample_token"]
