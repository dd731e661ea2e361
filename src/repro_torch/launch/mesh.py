"""Worker meshes (port of ``repro.launch.mesh``, the 1-D mesh only).

A ``WorkerMesh`` is a tuple of devices along one named axis: the
dispatcher splits a bucket's batch over it (``runtime.dispatch``), and the
sharded slot pool puts one shard's segment on each of its devices
(``serve.slots``). It exposes what those readers ask of the reference's
``jax.sharding.Mesh``: ``devices``, ``axis_names`` and ``shape[axis]``.

``make_worker_mesh`` takes the first n CUDA devices. Tests build a mesh
over the CPU by naming ``torch.device("cpu")`` n times, the counterpart of
the reference's forced host devices; no constructor here ever falls back
to the CPU. The 2-D and 3-D production meshes (``make_production_mesh``,
``make_smoke_mesh``) need a ``(data, model)`` mesh and sharding rules,
which are ROADMAP.md queue 1 item 4, not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

NOT_PORTED = ("the 2-D and 3-D meshes need sharding rules over (data, "
              "model): ROADMAP.md queue 1 item 4, not ported yet")


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """``devices`` along the one axis ``axis_names[0]``. Hashable, so step
    factories cache on it. A CUDA device the machine lacks raises."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("workers",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"a worker mesh has one axis, got "
                             f"{self.axis_names}")
        n_cuda = torch.cuda.device_count()
        norm = []
        for d in devs:
            if d.type == "cuda":
                idx = 0 if d.index is None else d.index
                if idx >= n_cuda:
                    raise ValueError(
                        f"mesh device {d} does not exist: "
                        f"{n_cuda} CUDA device(s) are available")
                d = torch.device("cuda", idx)
            norm.append(d)
        object.__setattr__(self, "devices", tuple(norm))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_worker_mesh(num_workers: Optional[int] = None,
                     axis: str = "workers") -> WorkerMesh:
    """1-D mesh over the first ``num_workers`` CUDA devices (default all).
    Raises ``ValueError`` up front when fewer than one worker, or more
    workers than devices, are requested."""
    m = torch.cuda.device_count()
    n = m if num_workers is None else num_workers
    if n < 1:
        if num_workers is None:
            raise ValueError("no CUDA device is available for a worker "
                             "mesh")
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if n > m:
        raise ValueError(f"requested {n} workers but only {m} device(s) "
                         "are available")
    return WorkerMesh(tuple(torch.device("cuda", i) for i in range(n)),
                      (axis,))


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(NOT_PORTED)


def make_smoke_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(NOT_PORTED)
