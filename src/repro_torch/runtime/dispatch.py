"""Kernel dispatch with per-(fn, bucket) bookkeeping (port of
``repro.runtime.dispatch``).

Two entry points:

  * ``run(fn, leaves, in_axes)`` — batched dispatch of one shape bucket.
    The reference runs ``jit(vmap(fn))``; PyTorch runs eagerly and has no
    vmap the port needs, so ``fn`` is written for batches: leaves whose
    ``in_axes`` entry is 0 carry the batch on axis 0, leaves whose entry
    is ``None`` are shared, and ``fn`` returns its outputs with the batch
    on axis 0.
  * ``run_one(fn, leaves)`` — one request's stage function (the read
    mapper's per-read path).

There is no compile cache to fill: the first call of a bucket since the
stats were cleared counts as its miss (first use), later calls as hits.
``run`` records them in the metrics registry (``runtime.dispatch.
cache_hits`` / ``cache_misses`` counters, ``compile_ms`` (first-use) /
``execute_ms`` histograms) and per bucket in ``BUCKET_STATS`` under
``<fn>[b<batch>]``; with a tracer enabled it records a ``bucket-dispatch``
span on the dispatcher track, and it ticks the installed sampler. Times
are host milliseconds: a call returns once its work is queued, unless the
function itself waits for the device. The target is one card, so there is
no device mesh.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import sampler as obs_sampler
from repro_torch.obs import trace as obs_trace


def _shape_key(leaves: Sequence) -> Tuple:
    return tuple(tuple(x.shape) if isinstance(x, torch.Tensor) else ()
                 for x in leaves)


def _fn_name(fn) -> str:
    # qualname keeps factory closures apart ('_sort_fn.run' vs
    # '_scan_fn.run'; plain __name__ is 'run' for both)
    return getattr(fn, "__qualname__", getattr(fn, "__name__", "fn")
                   ).replace(".<locals>", "")


class _BucketStats:
    """``<fn>[<bucket>]`` -> hit / miss counts and first / execute host-ms
    totals. Registry provider ``runtime.dispatch.bucket``."""

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
obs_metrics.REGISTRY.register_provider("runtime.dispatch.bucket",
                                       BUCKET_STATS)


class Dispatcher:
    """Dispatch of stage functions on their inputs' device."""

    def run(self, fn, leaves: Sequence, in_axes: Optional[Sequence] = None):
        """Dispatch one bucket batch; see the module docstring."""
        leaves = tuple(leaves)
        axes = tuple(0 for _ in leaves) if in_axes is None else tuple(in_axes)
        bsz = next(int(x.shape[0]) for x, ax in zip(leaves, axes)
                   if ax == 0)
        name = _fn_name(fn)
        key = f"{name}[b{bsz}]"
        first = key not in BUCKET_STATS.buckets
        t0 = time.perf_counter()
        out = fn(*leaves)
        t1 = time.perf_counter()
        reg = obs_metrics.REGISTRY
        ms = (t1 - t0) * 1e3
        if first:
            reg.counter("runtime.dispatch.cache_misses").inc()
            reg.histogram("runtime.dispatch.compile_ms").observe(ms)
        else:
            reg.counter("runtime.dispatch.cache_hits").inc()
            reg.histogram("runtime.dispatch.execute_ms").observe(ms)
        BUCKET_STATS.record(key, first, ms)
        obs_trace.get_tracer().complete(
            "bucket-dispatch", "dispatcher", t0, t1, fn=name, batch=bsz,
            workers=1, compiled=first)
        obs_sampler.tick("dispatch.run")
        return out

    def run_one(self, fn, leaves: Sequence):
        key = f"{_fn_name(fn)}{list(_shape_key(leaves))}"
        first = key not in BUCKET_STATS.buckets
        t0 = time.perf_counter()
        out = fn(*leaves)
        BUCKET_STATS.record(key, first, (time.perf_counter() - t0) * 1e3)
        return out
