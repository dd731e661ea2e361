"""The decoder (port of ``repro.models.transformer``), for the families this
port runs so far: the ``rwkv`` mixer with the ``rwkv_ffn`` or ``dense`` MLP
(RWKV6). Attention, Mamba and MoE layers raise ``NotImplementedError``.

Parameters are a ``Model``: one ``nn.Module`` per layer, each a
``ParamTree`` holding the reference's leaf names (``norm1``, ``rwkv``,
``rwkv_ffn``, ...). The layers run one after another in a Python loop; the
reference's ``lax.scan`` over periods has no counterpart here. Caches keep
the reference's layout: a dict keyed by pattern position (``p0``...), each
leaf stacked over periods with the batch on axis 1, so they compare leaf
for leaf with the JAX package's.

Modes:
  * train    - full-sequence forward, returns (logits, aux_loss, None).
  * prefill  - full-sequence forward, returns (last-token logits, caches).
  * decode   - one token (S = 1), or a chunk of S > 1 consecutive tokens
               (chunked prefill) that carries the cached state.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm

Tensor = torch.Tensor

#: the slice of the port (ROADMAP queue 1 item 8) that brings each part
_WAITS = {"attn": "the attention slice, with flash_attention",
          "mamba": "the Mamba slice", "moe": "the MoE slice"}


def _not_ported(what: str, name: str):
    raise NotImplementedError(
        f"{what} {name!r} is not ported yet: it comes with {_WAITS[name]} "
        "(ROADMAP queue 1 item 8)")


class ParamTree(nn.Module):
    """A nested mapping of parameter names to tensors, as a module: leaves
    are parameters (no gradient), inner dicts are child ParamTrees, and
    ``tree["name"]`` reads either, as the reference reads its dicts."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def keys(self) -> List[str]:
        return list(self._parameters) + list(self._modules)

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, ParamTree) else v.data)
                for k, v in ((k, self[k]) for k in self.keys())}


class Model(nn.Module):
    """``embed`` (token inputs), ``layers`` (one ParamTree per layer, in
    order: layer l is pattern position l % period of period l // period),
    ``final_norm`` and ``unembed`` (untied embeddings)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.embed = ParamTree(tree["embed"]) if "embed" in tree else None
        self.layers = nn.ModuleList(ParamTree(t) for t in tree["layers"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.unembed = (ParamTree(tree["unembed"]) if "unembed" in tree
                        else None)


# ---------------------------------------------------------------------------
# sub-config adapters
# ---------------------------------------------------------------------------

def _rwkv_cfg(cfg: ModelConfig) -> ssm.RWKVConfig:
    return ssm.RWKVConfig(d_model=cfg.d_model, head_dim=cfg.rwkv_head_dim,
                          scan_chunk=cfg.scan_chunk)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(g, cfg: ModelConfig, spec: LayerSpec, device):
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": L.init_rmsnorm(d, device),
                         "norm2": L.init_rmsnorm(d, device)}
    if spec.mixer == "rwkv":
        p["rwkv"] = ssm.init_rwkv_time_mix(g, _rwkv_cfg(cfg), device)
    elif spec.mixer in _WAITS:
        _not_ported("mixer", spec.mixer)
    else:
        raise ValueError(spec.mixer)
    if spec.mlp == "dense":
        p["mlp"] = L.init_mlp(g, d, cfg.d_ff, device)
    elif spec.mlp == "rwkv_ffn":
        p["rwkv_ffn"] = ssm.init_rwkv_channel_mix(g, d, cfg.d_ff, device)
    elif spec.mlp in _WAITS:
        _not_ported("mlp", spec.mlp)
    else:
        raise ValueError(spec.mlp)
    return p


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Model:
    """Random fp32 master weights on ``device`` (default: the card), drawn
    from ``generator``, which must live on that device. On the ``meta``
    device nothing is drawn and the generator may be None."""
    dev = resolve_device(device)
    if dev.type != "meta" and generator is None:
        raise ValueError("init_model needs a torch.Generator on "
                         f"{dev} (torch.Generator(device).manual_seed(s))")
    tree: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        tree["embed"] = L.init_embedding(generator, cfg.vocab, cfg.d_model,
                                         dev)
    tree["layers"] = [_init_layer(generator, cfg, spec, dev)
                      for spec in cfg.layer_specs()]
    tree["final_norm"] = L.init_rmsnorm(cfg.d_model, dev)
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        tree["unembed"] = L.init_unembed(generator, cfg.vocab, cfg.d_model,
                                         dev)
    return Model(tree)


def param_count(params: Model) -> int:
    return int(sum(p.numel() for p in params.parameters()))


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

def _apply_layer(p, cfg: ModelConfig, spec: LayerSpec, x: Tensor, cache,
                 mode: str, use_kernels: bool):
    new_cache: Optional[Dict[str, Any]] = None
    h = L.rmsnorm(p["norm1"], x)
    if spec.mixer == "rwkv":
        rcfg = _rwkv_cfg(cfg)
        if mode == "decode":
            if h.shape[1] == 1:
                y, st = ssm.rwkv_time_mix_decode(p["rwkv"], rcfg, h,
                                                 cache["rwkv"])
            else:       # chunked prefill: the state-carried scan
                y, st = ssm.rwkv_time_mix(p["rwkv"], rcfg, h, cache["rwkv"],
                                          use_kernels=use_kernels)
        else:
            y, st = ssm.rwkv_time_mix(p["rwkv"], rcfg, h, None,
                                      use_kernels=use_kernels)
        new_cache = {"rwkv": st}
    elif spec.mixer in _WAITS:
        _not_ported("mixer", spec.mixer)
    else:
        raise ValueError(spec.mixer)
    x = x + y

    h2 = L.rmsnorm(p["norm2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp == "dense":
        y2 = L.mlp(p["mlp"], h2, act=cfg.act)
    elif spec.mlp == "rwkv_ffn":
        x_prev = cache.get("ffn_x") if (cache and mode == "decode") else None
        y2, ffn_x = ssm.rwkv_channel_mix(p["rwkv_ffn"], h2, x_prev)
        if new_cache is None:
            new_cache = {}
        new_cache["ffn_x"] = ffn_x
    elif spec.mlp in _WAITS:
        _not_ported("mlp", spec.mlp)
    else:
        raise ValueError(spec.mlp)
    x = x + y2
    return x, new_cache, aux


def _take(tree, j: int):
    """Period j of a cache entry whose leaves are stacked over periods."""
    if isinstance(tree, dict):
        return {k: _take(v, j) for k, v in tree.items()}
    return tree[j]


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def apply_model(params: Model, cfg: ModelConfig, *,
                tokens: Optional[Tensor] = None,
                embeds: Optional[Tensor] = None,
                positions: Optional[Tensor] = None,
                caches=None, mode: str = "train",
                pos_scalar=None, cache_slots: int = 0,
                use_kernels: bool = True):
    """Returns (logits, aux_loss, new_caches_or_None).

    ``positions``, ``pos_scalar`` and ``cache_slots`` are the reference's
    arguments for attention layers; no mixer of this port reads them yet.
    ``use_kernels=False`` runs the WKV scan's plain version on the
    tensors' device instead of the kernel.
    """
    assert mode in ("train", "prefill", "decode"), mode
    del positions, pos_scalar, cache_slots
    dt = cfg.dtype
    if embeds is not None:
        x = embeds.to(dt)
    else:
        x = L.embed(params.embed, tokens, dt)
        if cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                                 device=x.device)

    pattern = cfg.pattern
    period = len(pattern)
    want_caches = mode != "train"
    new: Dict[str, List[Any]] = {f"p{i}": [] for i in range(period)}
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, p in enumerate(params.layers):
        i, j = li % period, li // period
        ci = _take(caches[f"p{i}"], j) if caches is not None else None
        x, nc, aux = _apply_layer(p, cfg, pattern[i], x, ci, mode,
                                  use_kernels)
        if want_caches:
            new[f"p{i}"].append(nc)
        aux_loss = aux_loss + aux
    new_caches = ({k: _stack(v) for k, v in new.items()} if want_caches
                  else None)

    x = L.rmsnorm(params.final_norm, x)
    if mode == "prefill":
        x = x[:, -1:]       # prefill callers only consume the last logits
    # decode chunks (s > 1) keep ALL s positions, as in the reference
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        table = params.embed["table"]
    else:
        table = params.unembed["table"]
    logits = L.logits({"table": table}, x)
    return logits, aux_loss, new_caches


# ---------------------------------------------------------------------------
# decode-cache allocation
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, slots: int,
                per_slot_pos: bool = False, device: DeviceLike = None):
    """Zero caches for decode: dict p<i> -> stacked-over-periods leaves,
    every leaf with the batch on axis 1. ``slots`` and ``per_slot_pos``
    size attention caches in the reference; RWKV state is O(1) per row."""
    del slots, per_slot_pos
    dev = resolve_device(device)
    np_, d = cfg.num_periods, cfg.d_model
    f32 = dict(dtype=torch.float32, device=dev)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "rwkv":
            h, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            caches[f"p{i}"] = {
                "rwkv": {"s": torch.zeros((np_, batch, h, hd, hd), **f32),
                         "x_prev": torch.zeros((np_, batch, d), **f32)},
                "ffn_x": torch.zeros((np_, batch, d), **f32)}
        elif spec.mixer in _WAITS:
            _not_ported("mixer", spec.mixer)
        else:
            raise ValueError(spec.mixer)
    return caches
