"""Single-request dispatcher with per-(fn, bucket) bookkeeping (port of
``repro.runtime.dispatch``, ``Dispatcher.run_one`` and ``BUCKET_STATS``).

PyTorch runs eagerly, so there is no compile cache to fill: ``run_one``
calls the stage function and records, per function and input-shape bucket,
how many calls it served and their host milliseconds. The first call of a
bucket since the stats were cleared counts as its miss (first use), later
calls as hits. The batched ``run``, the device mesh and the
metrics-registry wiring are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Sequence, Tuple

import torch


def _shape_key(leaves: Sequence) -> Tuple:
    return tuple(tuple(x.shape) if isinstance(x, torch.Tensor) else ()
                 for x in leaves)


class _BucketStats:
    """``<fn>[<shapes>]`` -> hit / miss counts and first / execute host-ms
    totals (host time: the call returns once its work is queued, unless the
    function itself waits for the device)."""

    def __init__(self):
        self.buckets: Dict[str, Dict[str, Any]] = {}

    def record(self, key: str, first: bool, ms: float):
        b = self.buckets.setdefault(
            key, {"hits": 0, "misses": 0, "first_ms": 0.0,
                  "execute_ms": 0.0})
        if first:
            b["misses"] += 1
            b["first_ms"] += ms
        else:
            b["hits"] += 1
            b["execute_ms"] += ms

    def metrics(self) -> Dict[str, Any]:
        return {f"{key}.{k}": (round(v, 3) if isinstance(v, float) else v)
                for key, b in sorted(self.buckets.items())
                for k, v in b.items()}

    def clear(self):
        self.buckets.clear()


#: process-wide per-bucket dispatch stats
BUCKET_STATS = _BucketStats()


class Dispatcher:
    """Dispatch of one request's stage function on its inputs' device."""

    def run_one(self, fn, leaves: Sequence):
        name = getattr(fn, "__qualname__", getattr(fn, "__name__", "fn")
                       ).replace(".<locals>", "")
        key = f"{name}{list(_shape_key(leaves))}"
        first = key not in BUCKET_STATS.buckets
        t0 = time.perf_counter()
        out = fn(*leaves)
        BUCKET_STATS.record(key, first, (time.perf_counter() - t0) * 1e3)
        return out
