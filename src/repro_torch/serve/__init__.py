"""LM serving (port of ``repro.serve``): the engine's prefill / decode /
chunked-prefill / verify steps and per-request ``generate``, block paging
(``BlockPool``, ``PageTable``, ``SwapStore``), the slot pool (contiguous or
paged: preemption by recompute or swap, prefix sharing, window rings, and
the sharded paged pool with per-shard block pools, placement and work
stealing) and the continuous-batching scheduler with speculative decoding.
The reference's ``cache_shardings`` (cache placement on a 2-D mesh) is
ROADMAP.md queue 1 item 4, not ported yet."""

from repro_torch.serve.engine import (SamplingPolicy, generate,
                                      make_chunk_step, make_decode_step,
                                      make_prefill_step,
                                      make_sharded_chunk_step,
                                      make_sharded_decode_step,
                                      make_sharded_verify_step,
                                      make_slot_decode_step,
                                      make_verify_step, sample_token)
from repro_torch.serve.paging import BlockPool, PageTable, SwapStore
from repro_torch.serve.scheduler import (Completion, RequestCache, Scheduler,
                                         SchedulerConfig)
from repro_torch.serve.slots import SlotManager

__all__ = ["generate", "make_chunk_step", "make_decode_step",
           "make_prefill_step", "make_sharded_chunk_step",
           "make_sharded_decode_step", "make_sharded_verify_step",
           "make_slot_decode_step", "make_verify_step",
           "sample_token", "BlockPool", "Completion", "PageTable",
           "RequestCache", "SamplingPolicy", "Scheduler", "SchedulerConfig",
           "SlotManager", "SwapStore"]
