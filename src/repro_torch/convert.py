"""Bring state made by the JAX reference into the port, and back.

The read mapper has no weights: its state is the reference minimizer index.
``index_from_numpy`` turns the reference package's ``Index`` (its
``hashes`` / ``positions`` as numpy arrays) into the port's ``Index``, so
both packages can probe the very same state.

A model's state is its weights. ``params_from_numpy`` turns the reference's
``init_model`` tree (as numpy arrays, block leaves stacked over periods)
into the port's ``Model``; ``reference_layout`` and ``params_to_numpy`` go
the other way, so either package's weights can drive the other. Every leaf
is carried by name, the attention ones too (``wq``, ``wk``, ``wv``, ``wo``,
the optional ``bq``, ``bk``, ``bv`` and ``q_norm``, ``k_norm``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.seeding import Index
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Model


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


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: DeviceLike = None) -> Model:
    """The reference's parameter tree, as numpy arrays (``embed``,
    ``blocks/p<i>`` with leaves stacked over periods, ``final_norm``,
    ``unembed``), as the port's ``Model`` of fp32 tensors on ``device``."""
    dev = resolve_device(device)
    period = len(cfg.pattern)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    out: Dict[str, Any] = {k: _map(tree[k], tensor)
                           for k in ("embed", "final_norm", "unembed")
                           if k in tree}
    blocks = tree["blocks"]
    out["layers"] = [
        _map(blocks[f"p{li % period}"],
             lambda a, j=li // period: tensor(np.asarray(a)[j]))
        for li in range(cfg.num_layers)]
    return Model(out)


def reference_layout(cfg: ModelConfig, params: Model) -> Dict[str, Any]:
    """The port's weights in the reference's tree: ``blocks/p<i>`` leaves
    stacked over periods (tensors on the model's device, ``meta`` too)."""
    period = len(cfg.pattern)
    out: Dict[str, Any] = {}
    if params.embed is not None:
        out["embed"] = params.embed.to_dict()
    layers = [p.to_dict() for p in params.layers]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees, dim=0)

    out["blocks"] = {f"p{i}": stack(layers[i::period])
                     for i in range(period)}
    out["final_norm"] = params.final_norm.to_dict()
    if params.unembed is not None:
        out["unembed"] = params.unembed.to_dict()
    return out


def params_to_numpy(cfg: ModelConfig, params: Model) -> Dict[str, Any]:
    """``reference_layout`` as host numpy arrays: the tree the reference's
    ``apply_model`` takes."""
    return _map(reference_layout(cfg, params),
                lambda t: t.detach().cpu().numpy())
