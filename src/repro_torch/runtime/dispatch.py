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
function itself waits for the device.

With a 1-D worker mesh (``launch.mesh.make_worker_mesh``) the batch is
padded to a multiple of the worker count by repeating its last row, split
into contiguous parts, one a device, and ``fn`` runs on each part on its
device (shared leaves are copied to each device once a call); the parts'
outputs are concatenated on the first device and the padding is sliced
off, so results equal the mesh-less call's position by position. The
reference's ``shard_map`` is one program over the mesh; here each device
gets its own call.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import make_worker_mesh  # noqa: F401
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
    """``<fn>[<bucket>]`` -> hit / miss counts and first-use / execute
    host-ms totals. Registry provider ``runtime.dispatch.bucket``; the
    first-use total keeps the reference's name, ``compile_ms``, which the
    SLO rules read (``obs.control.dispatch_imbalance_rule``)."""

    def __init__(self):
        self.buckets: Dict[str, Dict[str, Any]] = {}

    def record(self, key: str, first: bool, ms: float):
        b = self.buckets.setdefault(
            key, {"hits": 0, "misses": 0, "compile_ms": 0.0,
                  "execute_ms": 0.0})
        if first:
            b["misses"] += 1
            b["compile_ms"] += ms
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


def _pad_rows(x, pad: int):
    """``x`` with its last row repeated ``pad`` times on axis 0."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


def _to(x, dev: torch.device):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _concat(parts: List, dev: torch.device):
    """Concatenate the per-device outputs of ``fn`` (tensors, numpy
    arrays, and tuples, lists or dicts of them) on axis 0, on ``dev``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], dev) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([p[i] for p in parts], dev)
                           for i in range(len(first)))
    return np.concatenate([np.asarray(p) for p in parts])


def _head(out, n: int):
    """The first ``n`` rows of every leaf of ``out``."""
    if isinstance(out, dict):
        return {k: _head(v, n) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_head(v, n) for v in out)
    return out[:n]


class Dispatcher:
    """Dispatch of stage functions on their inputs' device, or over a 1-D
    worker mesh (``mesh``, split along ``axis``, by default its one axis
    name); see the module docstring."""

    def __init__(self, mesh=None, axis: Optional[str] = None):
        self.mesh = mesh
        self.axis = axis or (mesh.axis_names[0] if mesh is not None
                             else None)
        if mesh is not None and self.axis not in mesh.axis_names:
            raise ValueError(f"axis {self.axis!r} not in mesh axes "
                             f"{mesh.axis_names}")

    @property
    def num_workers(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.axis]

    def _run_mesh(self, fn, leaves: Tuple, axes: Tuple, rows: int):
        """``fn`` on each device's contiguous part of ``rows`` rows."""
        devs = self.mesh.devices
        per = rows // len(devs)
        outs = []
        for i, dev in enumerate(devs):
            part = tuple(_to(x[i * per:(i + 1) * per], dev) if ax == 0
                         else _to(x, dev)
                         for x, ax in zip(leaves, axes))
            outs.append(fn(*part))
        return outs[0] if len(outs) == 1 else _concat(outs, devs[0])

    def run(self, fn, leaves: Sequence, in_axes: Optional[Sequence] = None):
        """Dispatch one bucket batch; see the module docstring."""
        leaves = tuple(leaves)
        axes = tuple(0 for _ in leaves) if in_axes is None else tuple(in_axes)
        bsz = next(int(x.shape[0]) for x, ax in zip(leaves, axes)
                   if ax == 0)
        w = self.num_workers
        pad = (-bsz) % w
        if pad:
            leaves = tuple(_pad_rows(x, pad) if ax == 0 else x
                           for x, ax in zip(leaves, axes))
        name = _fn_name(fn)
        key = f"{name}[b{bsz + pad}]"
        first = key not in BUCKET_STATS.buckets
        t0 = time.perf_counter()
        out = (fn(*leaves) if self.mesh is None
               else self._run_mesh(fn, leaves, axes, bsz + pad))
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
            "bucket-dispatch", "dispatcher", t0, t1, fn=name,
            batch=bsz + pad, workers=w, compiled=first)
        obs_sampler.tick("dispatch.run")
        return _head(out, bsz) if pad else out

    def run_one(self, fn, leaves: Sequence):
        key = f"{_fn_name(fn)}{list(_shape_key(leaves))}"
        first = key not in BUCKET_STATS.buckets
        t0 = time.perf_counter()
        out = fn(*leaves)
        BUCKET_STATS.record(key, first, (time.perf_counter() - t0) * 1e3)
        return out
