"""The decoder (port of ``repro.models.transformer``) for all ten
configs: the ``attn`` (``models.attention``), ``rwkv`` and ``mamba``
(``models.ssm``) mixers with the ``dense``, ``moe`` (``models.moe``) or
``rwkv_ffn`` MLP, on token or embedding inputs.

Parameters are a ``Model``: one ``nn.Module`` per layer, each a
``ParamTree`` holding the reference's leaf names (``norm1``, ``attn``,
``rwkv``, ``mlp``, ...). The layers run one after another in a Python loop;
the reference's ``lax.scan`` over periods has no counterpart here. Caches
keep the reference's layout: a dict keyed by pattern position (``p0``...),
each leaf stacked over periods (attention layers hold ``KVCache`` ring
buffers, Mamba layers their conv ring and state ``h``), so they compare
leaf for leaf with the JAX package's.

Modes:
  * train    - full-sequence forward, returns (logits, aux_loss, None).
  * prefill  - full-sequence forward, returns (last-token logits, caches).
  * decode   - one token (S = 1), or a chunk of S > 1 consecutive tokens
               (chunked prefill) that carries the cached state.

On the card, train and prefill run the kernels: ``flash_attention`` for
every attention layer and ``ssm_scan`` for every RWKV layer. In train mode
with gradients on (the trainer's ``Model`` has ``requires_grad``) both go
through their ``autograd.Function``: the forward kernel (which then also
keeps flash attention's row log-sum-exp) and a hand-written backward
kernel. With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body), so its forward kernels run twice a step: once in the forward, once
in the recompute; ``remat_policy="dots"`` keeps the matrix products'
outputs instead of recomputing them (``checkpoint_dots``). A decode step
and a chunk attend over the cache with the plain ``blockwise_attention``.
The Mamba scan and the MoE dispatch have no kernel in the reference and
run as plain torch everywhere.

``lm_loss`` is the reference's masked cross-entropy plus z-loss.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm

Tensor = torch.Tensor


class ParamTree(nn.Module):
    """A nested mapping of parameter names to tensors, as a module: leaves
    are parameters (no gradient until a trainer turns it on with
    ``requires_grad_``), inner dicts are child ParamTrees, and
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

def _attn_cfg(cfg: ModelConfig, spec: LayerSpec) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, rope_theta=spec.rope_theta,
        window=spec.window, kv_block=cfg.kv_block)


def _moe_cfg(cfg: ModelConfig) -> moe_lib.MoEConfig:
    return moe_lib.MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.moe_d_ff or cfg.d_ff,
        num_experts=cfg.num_experts,
        experts_per_token=cfg.experts_per_token,
        capacity_factor=cfg.capacity_factor, act=cfg.act)


def _rwkv_cfg(cfg: ModelConfig) -> ssm.RWKVConfig:
    return ssm.RWKVConfig(d_model=cfg.d_model, head_dim=cfg.rwkv_head_dim,
                          scan_chunk=cfg.scan_chunk)


def _mamba_cfg(cfg: ModelConfig) -> ssm.MambaConfig:
    return ssm.MambaConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                           expand=cfg.ssm_expand,
                           scan_chunk=cfg.scan_chunk)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(g, cfg: ModelConfig, spec: LayerSpec, device):
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": L.init_rmsnorm(d, device),
                         "norm2": L.init_rmsnorm(d, device)}
    if spec.mixer == "attn":
        p["attn"] = attention.init_attention(g, _attn_cfg(cfg, spec), device)
    elif spec.mixer == "rwkv":
        p["rwkv"] = ssm.init_rwkv_time_mix(g, _rwkv_cfg(cfg), device)
    elif spec.mixer == "mamba":
        p["mamba"] = ssm.init_mamba(g, _mamba_cfg(cfg), device)
    else:
        raise ValueError(spec.mixer)
    if spec.mlp == "dense":
        p["mlp"] = L.init_mlp(g, d, cfg.d_ff, device)
    elif spec.mlp == "moe":
        p["moe"] = moe_lib.init_moe(g, _moe_cfg(cfg), device)
    elif spec.mlp == "rwkv_ffn":
        p["rwkv_ffn"] = ssm.init_rwkv_channel_mix(g, d, cfg.d_ff, device)
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


def active_param_count(params: Model, cfg: ModelConfig) -> int:
    """6*N_active*D accounting for MoE: experts count at k/E of their size."""
    total = 0
    for name, p in params.named_parameters():
        n = p.numel()
        if "expert_" in name and cfg.num_experts:
            n = n * cfg.experts_per_token // cfg.num_experts
        total += n
    return int(total)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

def _apply_layer(p, cfg: ModelConfig, spec: LayerSpec, x: Tensor,
                 positions: Optional[Tensor], cache, mode: str, pos_scalar,
                 cache_slots: int, use_kernels: bool, own_positions: bool):
    new_cache: Optional[Dict[str, Any]] = None
    h = L.rmsnorm(p["norm1"], x)
    if spec.mixer == "attn":
        acfg = _attn_cfg(cfg, spec)
        if mode == "decode":
            y, kvc = attention.attention(p["attn"], acfg, h, positions,
                                         cache=cache["attn"],
                                         position_scalar=pos_scalar)
            new_cache = {"attn": kvc}
        else:
            slots = None
            if mode == "prefill":
                slots = (min(cache_slots, spec.window) if spec.window
                         else cache_slots)
            y, kvc = attention.attention(
                p["attn"], acfg, h, positions, make_cache_slots=slots,
                use_kernels=use_kernels and own_positions)
            if kvc is not None:
                new_cache = {"attn": kvc}
    elif spec.mixer == "rwkv":
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
    elif spec.mixer == "mamba":
        mcfg = _mamba_cfg(cfg)
        if mode == "decode":
            if h.shape[1] == 1:
                y, st = ssm.mamba_block_decode(p["mamba"], mcfg, h,
                                               cache["mamba"])
            else:       # chunked prefill: the state-carried scan
                y, st = ssm.mamba_block(p["mamba"], mcfg, h, cache["mamba"])
        else:
            y, st = ssm.mamba_block(p["mamba"], mcfg, h, None)
        new_cache = {"mamba": st}
    else:
        raise ValueError(spec.mixer)
    x = x + y

    h2 = L.rmsnorm(p["norm2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp == "dense":
        y2 = L.mlp(p["mlp"], h2, act=cfg.act)
    elif spec.mlp == "moe":
        y2, aux = moe_lib.moe(p["moe"], _moe_cfg(cfg), h2)
    elif spec.mlp == "rwkv_ffn":
        x_prev = cache.get("ffn_x") if (cache and mode == "decode") else None
        y2, ffn_x = ssm.rwkv_channel_mix(p["rwkv_ffn"], h2, x_prev)
        if new_cache is None:
            new_cache = {}
        new_cache["ffn_x"] = ffn_x
    else:
        raise ValueError(spec.mlp)
    x = x + y2
    return x, new_cache, aux


def _take(tree, j: int):
    """Period j of a cache entry whose leaves are stacked over periods."""
    if isinstance(tree, dict):
        return {k: _take(v, j) for k, v in tree.items()}
    if isinstance(tree, attention.KVCache):
        return attention.KVCache(*(x[j] for x in tree))
    return tree[j]


def _stack(trees: List[Any]):
    if trees[0] is None:        # a prefill without cache slots
        return None
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], attention.KVCache):
        return attention.KVCache(*(torch.stack(x, dim=0)
                                   for x in zip(*trees)))
    return torch.stack(trees, dim=0)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

# the matrix products whose outputs remat_policy="dots" keeps (the
# reference's checkpoint_dots keeps every dot_general's)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg: ModelConfig):
    """``checkpoint``'s context_fn: full recompute, or with
    ``remat_policy="dots"`` the matrix products' outputs saved."""
    if cfg.remat_policy == "dots":
        return functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_dots)
    return ckpt.noop_context_fn


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

    ``positions`` (B, S) default to 0..S-1 in train and prefill and to
    ``pos_scalar`` + 0..S-1 in decode, where ``pos_scalar`` is the shared
    scalar position or the (B,) per-row positions. In train mode with
    gradients on and ``cfg.remat``, each layer runs under
    ``torch.utils.checkpoint``. ``cache_slots`` sizes
    the caches a prefill builds (0: none). ``use_kernels=False`` runs the
    plain versions on the tensors' device instead of the kernels: the WKV
    scan's, and ``blockwise_attention`` (or ``banded_attention``) instead
    of ``flash_attention``, which runs only where the positions are the
    model's own 0..S-1.
    """
    assert mode in ("train", "prefill", "decode"), mode
    dt = cfg.dtype
    if embeds is not None:
        x = embeds.to(dt)
    else:
        x = L.embed(params.embed, tokens, dt)
        if cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                                 device=x.device)

    b, s = x.shape[0], x.shape[1]
    own_positions = positions is None and mode != "decode"
    if positions is None and (mode != "decode" or pos_scalar is not None):
        steps = torch.arange(s, dtype=torch.int64, device=x.device)
        if mode == "decode":
            pos_scalar = torch.as_tensor(pos_scalar, dtype=torch.int64,
                                         device=x.device)
            p0 = pos_scalar.expand(b) if pos_scalar.dim() == 0 else pos_scalar
            positions = p0[:, None] + steps[None]
        else:
            positions = steps[None].expand(b, s)

    pattern = cfg.pattern
    period = len(pattern)
    want_caches = mode != "train"
    remat = (cfg.remat and mode == "train" and torch.is_grad_enabled()
             and any(p.requires_grad for p in params.parameters()))
    new: Dict[str, List[Any]] = {f"p{i}": [] for i in range(period)}
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, p in enumerate(params.layers):
        i, j = li % period, li // period
        if remat:
            def layer(xc, p=p, spec=pattern[i]):
                xo, _, aux_l = _apply_layer(p, cfg, spec, xc, positions,
                                            None, mode, pos_scalar,
                                            cache_slots, use_kernels,
                                            own_positions)
                return xo, aux_l
            x, aux = ckpt.checkpoint(layer, x, use_reentrant=False,
                                     context_fn=_remat_context(cfg))
            aux_loss = aux_loss + aux
            continue
        ci = _take(caches[f"p{i}"], j) if caches is not None else None
        x, nc, aux = _apply_layer(p, cfg, pattern[i], x, positions, ci,
                                  mode, pos_scalar, cache_slots, use_kernels,
                                  own_positions)
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
                per_slot_pos: bool = False, device: DeviceLike = None,
                paged_global_attn: bool = False,
                paged_window_attn: bool = False):
    """Zero caches for decode: dict p<i> -> stacked-over-periods leaves,
    every leaf but a shared ``pos`` with the batch on axis 1. Attention
    layers get bf16 ``KVCache`` rings of ``slots`` slots (``min(slots,
    window)`` for a sliding window), with per-row positions (periods,
    batch, slots) when ``per_slot_pos`` else shared ones (periods, slots);
    RWKV state is O(1) per row.

    ``paged_global_attn`` leaves ``{"attn": None}`` for the layers whose
    view spans all ``slots`` (global attention, or a window >= slots), and
    ``paged_window_attn`` for the sliding-window layers with a shorter
    ring: those leaves live in the block pools of the paged slot backing
    (``serve.slots``). RWKV and Mamba state always stays dense: Mamba's
    ``conv`` ring (periods, batch, K-1, d_inner) and ``h`` (periods, batch,
    d_inner, d_state), both fp32."""
    dev = resolve_device(device)
    np_, d = cfg.num_periods, cfg.d_model
    f32 = dict(dtype=torch.float32, device=dev)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "attn":
            sl = min(slots, spec.window) if spec.window else slots
            if (paged_global_attn and sl == slots) or \
                    (paged_window_attn and sl < slots):
                caches[f"p{i}"] = {"attn": None}
                continue
            pos = (np_, batch, sl) if per_slot_pos else (np_, sl)
            kv = (np_, batch, sl, cfg.num_kv_heads, cfg.head_dim)
            caches[f"p{i}"] = {"attn": attention.KVCache(
                k=torch.zeros(kv, dtype=torch.bfloat16, device=dev),
                v=torch.zeros(kv, dtype=torch.bfloat16, device=dev),
                pos=torch.full(pos, -1, dtype=torch.int32, device=dev))}
        elif spec.mixer == "rwkv":
            h, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            caches[f"p{i}"] = {
                "rwkv": {"s": torch.zeros((np_, batch, h, hd, hd), **f32),
                         "x_prev": torch.zeros((np_, batch, d), **f32)},
                "ffn_x": torch.zeros((np_, batch, d), **f32)}
        elif spec.mixer == "mamba":
            mcfg = _mamba_cfg(cfg)
            caches[f"p{i}"] = {"mamba": {
                "conv": torch.zeros((np_, batch, mcfg.conv_kernel - 1,
                                     mcfg.d_inner), **f32),
                "h": torch.zeros((np_, batch, mcfg.d_inner, mcfg.d_state),
                                 **f32)}}
        else:
            raise ValueError(spec.mixer)
    return caches


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def lm_loss(logits: Tensor, labels: Tensor, mask: Optional[Tensor] = None,
            z_weight: float = 1e-4) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Masked CE (fp32) + z-loss. labels: (B, S) integers; mask 1.0 = keep.
    Returns (loss, {"ce", "z_loss"}), as the reference's ``lm_loss``."""
    logits = logits.to(torch.float32)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = ((logz - ll) * mask).sum() / denom
    zl = z_weight * (torch.square(logz) * mask).sum() / denom
    return ce + zl, {"ce": ce, "z_loss": zl}
