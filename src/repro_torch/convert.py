"""Bring state made by the JAX reference into the port.

The read mapper has no weights: its state is the reference minimizer index.
``index_from_numpy`` turns the reference package's ``Index`` (its
``hashes`` / ``positions`` as numpy arrays) into the port's ``Index``, so
both packages can probe the very same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.seeding import Index
from repro_torch.device import DeviceLike, resolve_device


def index_from_numpy(hashes: np.ndarray, positions: np.ndarray,
                     device: DeviceLike = None) -> Index:
    """uint32 hashes and int32 positions -> the port's int64 ``Index`` on
    ``device``."""
    h = np.asarray(hashes)
    if h.dtype != np.uint32 or h.ndim != 1:
        raise TypeError(f"hashes must be 1-D uint32, got {h.dtype} "
                        f"{h.shape}")
    p = np.asarray(positions)
    if p.shape != h.shape:
        raise ValueError(f"positions {p.shape} do not match hashes "
                         f"{h.shape}")
    dev = resolve_device(device)
    return Index(hashes=torch.as_tensor(h.astype(np.int64)).to(dev),
                 positions=torch.as_tensor(p.astype(np.int64)).to(dev))
