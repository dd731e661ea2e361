"""RWKV6 (Finch) and Mamba blocks (port of ``repro.models.ssm``).

RWKV prefill and chunked prefill run the WKV recurrence over the whole
sequence on the hand-written kernel (``kernels.ssm_scan``: the state of
every batch-head row spread over the card as register tiles); decode runs
the O(1)-state single step of ``core.linear_attn.wkv_decode_step``. The
recurrent state is the cache. The reference runs its prefill on the
chunk-parallel jnp ``wkv_chunked``; the kernel computes the same function.

RWKV6 here is what the reference implements: static token-shift mixing
vectors plus the data-dependent decay (a low-rank MLP modulating w per
token and channel), multi-head (dk = dv = head_dim) WKV with the
current-token bonus ``u``, per-head groupnorm, and the squared-ReLU channel
mix. The reference's two ``use_fold`` layouts compute the same thing on
one device; the port keeps the folded (batch*heads) one.

Mamba follows mamba-1 as the reference does: in and gate projections, a
depthwise causal conv, selective (dt, B, C) projections and the diagonal
state update of ``core.linear_attn.mamba_chunked`` (prefill and chunks)
or ``mamba_decode_step`` (decode). The reference has no Pallas kernel for
it, so it runs as plain torch on the card too. ``dt``, ``A`` and ``D``
stay fp32 whatever the model's dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import linear_attn as la
from repro_torch.kernels import ssm_scan as K
from repro_torch.models import layers as L

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# RWKV6 time mix
# ---------------------------------------------------------------------------

class RWKVConfig(NamedTuple):
    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    scan_chunk: int = 64

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


def init_rwkv_time_mix(g, cfg: RWKVConfig, device=None):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    ramp = torch.arange(d, dtype=torch.float32, device=device) / d
    return {
        # token-shift mixing coefficients (static lerp weights)
        "mu_r": 0.5 * (1 + ramp), "mu_k": 0.7 * (1 + ramp) / 2,
        "mu_v": 0.7 * (1 + ramp) / 2, "mu_w": 0.6 * (1 + ramp) / 2,
        "mu_g": 0.5 * (1 + ramp),
        "wr": L.he_init(g, (d, d), d, device),
        "wk": L.he_init(g, (d, d), d, device),
        "wv": L.he_init(g, (d, d), d, device),
        "wg": L.he_init(g, (d, d), d, device),
        "wo": L.he_init(g, (d, d), d, device),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": -6.0 + 5.0 * ramp,                         # decay base
        "w_lora_a": L.truncated_normal(g, (d, cfg.decay_lora), 0.02, device),
        "w_lora_b": torch.zeros((cfg.decay_lora, d), dtype=torch.float32,
                                device=device),
        "u": L.truncated_normal(g, (h, hd), 0.5, device),    # bonus
        "ln_x": L.init_groupnorm(d, device),                 # per-head norm
    }


def _token_shift(x: Tensor, x_prev: Optional[Tensor]) -> Tensor:
    """shifted[t] = x[t-1]; slot -1 comes from the decode state (or zeros)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    else:
        x_prev = x_prev[:, None] if x_prev.dim() == 2 else x_prev
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _time_mix_inputs(params, x: Tensor, xs: Tensor):
    """r, k, v, g in x's dtype and the decay w (fp32, not clamped)."""
    dt = x.dtype

    def mix(mu):
        return x + (xs - x) * mu.to(dt)

    r = mix(params["mu_r"]) @ params["wr"].to(dt)
    k = mix(params["mu_k"]) @ params["wk"].to(dt)
    v = mix(params["mu_v"]) @ params["wv"].to(dt)
    g = F.silu(mix(params["mu_g"]) @ params["wg"].to(dt))
    # data-dependent decay (the Finch feature)
    xw = mix(params["mu_w"]).to(torch.float32)
    dd = torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    w = torch.exp(-torch.exp(params["w0"] + dd))        # (B, S, D) in (0,1)
    return r, k, v, g, w


def rwkv_time_mix(params, cfg: RWKVConfig, x: Tensor,
                  state: Optional[dict] = None, use_kernels: bool = True):
    """x: (B, S, D). state (decode/prefill-continuation) holds
    {"s": (B, H, hd, hd) fp32, "x_prev": (B, D)}. Returns (y, new_state).

    The WKV runs through ``kernels.ssm_scan.ssm_scan`` (the kernel for
    CUDA tensors, its plain version for CPU ones), or with
    ``use_kernels=False`` through the plain version on any device. Either
    way ``w`` is clamped to >= e^-1 first, as ``wkv_chunked`` clamps.
    The reference's ``chunk`` argument sized its chunked scan; the kernel
    needs none.
    """
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    dt = x.dtype
    x_prev = state["x_prev"] if state is not None else None
    r, k, v, g, w = _time_mix_inputs(params, x, _token_shift(x, x_prev))
    s0 = state["s"] if state is not None else None       # (b, h, hd, hd)

    def fold(z):          # (b*h, s, hd), contiguous as the kernel takes it
        return (z.reshape(b, s, h, hd).transpose(1, 2)
                .reshape(b * h, s, hd).contiguous())

    rf, wf, kf, vf = map(fold, (r, w, k, v))
    s0f = s0.reshape(b * h, hd, hd) if s0 is not None else None
    scan = K.ssm_scan if use_kernels else K.ssm_scan_plain
    yf, s_fin = scan(rf, la.clamp_decay(wf), kf, vf, None, s0f)
    yf = yf.to(dt)
    uf = params["u"][None].expand(b, h, hd).reshape(b * h, hd)
    bonus = torch.einsum("btk,bk,btk->bt", rf.to(torch.float32), uf,
                         kf.to(torch.float32))
    yf = yf + bonus[..., None] * vf.to(torch.float32)    # promotes to fp32
    yf = yf.reshape(b, h, s, hd)
    s_fin = s_fin.reshape(b, h, hd, hd)

    y = yf.transpose(1, 2).reshape(b, s, d)
    y = L.groupnorm(params["ln_x"], y.to(dt), groups=h)
    y = (y * g) @ params["wo"].to(dt)
    new_state = {"s": s_fin, "x_prev": x[:, -1].to(torch.float32)}
    return y, new_state


def rwkv_time_mix_decode(params, cfg: RWKVConfig, x: Tensor, state: dict):
    """Single-token decode: x (B, 1, D). O(1) in context length."""
    b, _, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    dt = x.dtype
    xs = state["x_prev"][:, None].to(dt)
    r, k, v, g, w = (z[:, 0] for z in _time_mix_inputs(params, x, xs))

    def fold(z):
        return z.reshape(b * h, hd)

    s0 = state["s"].reshape(b * h, hd, hd)
    yf, s_fin = la.wkv_decode_step(fold(r), fold(w), fold(k), fold(v),
                                   None, s0)
    uf = params["u"][None].expand(b, h, hd).reshape(b * h, hd)
    bonus = torch.einsum("bk,bk,bk->b", fold(r).to(torch.float32), uf,
                         fold(k).to(torch.float32))
    yf = yf + bonus[:, None] * fold(v).to(torch.float32)

    y = yf.reshape(b, h * hd)[:, None, :]
    y = L.groupnorm(params["ln_x"], y.to(dt), groups=h)
    y = (y * g[:, None]) @ params["wo"].to(dt)
    new_state = {"s": s_fin.reshape(b, h, hd, hd),
                 "x_prev": x[:, -1].to(torch.float32)}
    return y, new_state


def init_rwkv_state(batch: int, cfg: RWKVConfig, device=None):
    h, hd = cfg.num_heads, cfg.head_dim
    return {"s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                                  device=device)}


# ---------------------------------------------------------------------------
# RWKV channel mix (the arch's FFN; uses token shift too)
# ---------------------------------------------------------------------------

def init_rwkv_channel_mix(g, d_model: int, d_ff: int, device=None):
    ramp = torch.arange(d_model, dtype=torch.float32, device=device) / d_model
    return {
        "mu_k": 0.5 * (1 + ramp), "mu_r": 0.5 * (1 + ramp),
        "wk": L.he_init(g, (d_model, d_ff), d_model, device),
        "wv": L.he_init(g, (d_ff, d_model), d_ff, device),
        "wr": L.he_init(g, (d_model, d_model), d_model, device),
    }


def rwkv_channel_mix(params, x: Tensor, x_prev: Optional[Tensor] = None):
    """Squared-ReLU channel mix. Returns (y, x_last) for the decode shift."""
    dt = x.dtype
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * params["mu_k"].to(dt)
    xr = x + (xs - x) * params["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ params["wk"].to(dt)))
    y = torch.sigmoid(xr @ params["wr"].to(dt)) * \
        (kk @ params["wv"].to(dt))
    return y, x[:, -1].to(torch.float32)


# ---------------------------------------------------------------------------
# Mamba (S6) block
# ---------------------------------------------------------------------------

class MambaConfig(NamedTuple):
    d_model: int
    d_state: int = 16
    expand: int = 2
    conv_kernel: int = 4
    scan_chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))


def init_mamba(g, cfg: MambaConfig, device=None):
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real init for A; dt bias init for softplus ~ [1e-3, 1e-1]
    a = torch.arange(1, n + 1, **f32)[None].expand(di, n)
    u = torch.empty((di,), **f32)
    if u.device.type != "meta":
        u.uniform_(0.0, 1.0, generator=g)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt_init = torch.exp(u * (hi - lo) + lo)
    inv_softplus = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "w_in": L.he_init(g, (d, 2 * di), d, device),
        "conv_w": L.truncated_normal(g, (cfg.conv_kernel, di), 0.2, device),
        "conv_b": torch.zeros((di,), **f32),
        "w_x": L.he_init(g, (di, r + 2 * n), di, device),
        "w_dt": L.he_init(g, (r, di), r, device),
        "dt_bias": inv_softplus,
        "a_log": torch.log(a),
        "d_skip": torch.ones((di,), **f32),
        "w_out": L.he_init(g, (di, d), di, device),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 conv_state: Optional[Tensor] = None):
    """Depthwise causal conv along time. x: (B, S, di); w: (K, di). The K
    products are summed in ascending order, then the bias is added, as in
    the reference.

    Returns (y: (B, S, di), new_conv_state: (B, K-1, di) fp32)."""
    kk = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], kk - 1, x.shape[-1]))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(kk))
    new_state = xp[:, -(kk - 1):].to(torch.float32)
    return y + b.to(x.dtype), new_state


def _selective_inputs(params, cfg: MambaConfig, xi: Tensor):
    """(dt fp32, a fp32, b_in, c_in) from the conv output ``xi``: dt is
    softplus of the fp32 low-rank product with the fp32 master ``w_dt``
    (``logaddexp(z, 0)``, the reference's softplus)."""
    r, n = cfg.dt_rank, cfg.d_state
    proj = xi @ params["w_x"].to(xi.dtype)
    dt_low, b_in, c_in = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    z = dt_low.to(torch.float32) @ params["w_dt"] + params["dt_bias"]
    dt = torch.logaddexp(z, torch.zeros((), device=z.device))
    return dt, -torch.exp(params["a_log"]), b_in, c_in


def mamba_block(params, cfg: MambaConfig, x: Tensor,
                state: Optional[dict] = None, chunk: Optional[int] = None):
    """x: (B, S, D). state = {"conv": (B, K-1, di), "h": (B, di, n)}.
    Returns (y (B, S, D), new_state)."""
    di = cfg.d_inner
    dt_ = x.dtype
    xz = x @ params["w_in"].to(dt_)
    xi, z = xz[..., :di], xz[..., di:]
    conv_state = state["conv"] if state is not None else None
    xi, new_conv = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                conv_state)
    xi = F.silu(xi)
    dt, a, b_in, c_in = _selective_inputs(params, cfg, xi)
    h0 = state["h"] if state is not None else None
    y, h_fin = la.mamba_chunked(xi, dt, a, b_in, c_in, params["d_skip"],
                                h0, chunk=chunk or cfg.scan_chunk)
    y = (y.to(dt_) * F.silu(z)) @ params["w_out"].to(dt_)
    return y, {"conv": new_conv, "h": h_fin}


def mamba_block_decode(params, cfg: MambaConfig, x: Tensor, state: dict):
    """Single-token decode: x (B, 1, D). The conv runs over the ring of the
    last K-1 inputs and this one (the reference's ``bkd,kd->bd``)."""
    di = cfg.d_inner
    dt_ = x.dtype
    xz = (x @ params["w_in"].to(dt_))[:, 0]
    xi, z = xz[..., :di], xz[..., di:]
    window = torch.cat([state["conv"].to(dt_), xi[:, None]], dim=1)
    y = (torch.einsum("bkd,kd->bd", window, params["conv_w"].to(dt_))
         + params["conv_b"].to(dt_))
    new_conv = window[:, 1:].to(torch.float32)
    xi = F.silu(y)
    dt, a, b_in, c_in = _selective_inputs(params, cfg, xi)
    yd, h = la.mamba_decode_step(xi, dt, a, b_in, c_in, params["d_skip"],
                                 state["h"])
    out = (yd.to(dt_) * F.silu(z)) @ params["w_out"].to(dt_)
    return out[:, None], {"conv": new_conv, "h": h}


def init_mamba_state(batch: int, cfg: MambaConfig, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                                **f32),
            "h": torch.zeros((batch, cfg.d_inner, cfg.d_state), **f32)}
