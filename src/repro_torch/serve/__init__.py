"""LM serving (port of ``repro.serve``): the engine's prefill / decode /
chunked-prefill / verify steps and per-request ``generate``, block paging
(``BlockPool``, ``PageTable``, ``SwapStore``), the slot pool (contiguous or
paged: preemption by recompute or swap, prefix sharing, window rings) and
the continuous-batching scheduler with speculative decoding. The sharded
pool (and the reference's ``cache_shardings``) comes with a later slice."""

from repro_torch.serve.engine import (SamplingPolicy, generate,
                                      make_chunk_step, make_decode_step,
                                      make_prefill_step,
                                      make_slot_decode_step,
                                      make_verify_step, sample_token)
from repro_torch.serve.paging import BlockPool, PageTable, SwapStore
from repro_torch.serve.scheduler import (Completion, RequestCache, Scheduler,
                                         SchedulerConfig)
from repro_torch.serve.slots import SlotManager

__all__ = ["generate", "make_chunk_step", "make_decode_step",
           "make_prefill_step", "make_slot_decode_step", "make_verify_step",
           "sample_token", "BlockPool", "Completion", "PageTable",
           "RequestCache", "SamplingPolicy", "Scheduler", "SchedulerConfig",
           "SlotManager", "SwapStore"]
