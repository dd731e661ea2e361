"""Chunked linear-attention recurrences, the WKV (RWKV6) part (port of
``repro.core.linear_attn``).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``wkv_chunked`` is the chunk-parallel form (intra-chunk causal matmuls plus
a short scan over the T/C chunk-boundary states), ``wkv_ref`` its
sequential oracle and ``wkv_decode_step`` one serving step. The model's
prefill runs the recurrence on the hand-written kernel
(``kernels.ssm_scan``) instead; ``wkv_chunked`` stays as the plain-torch
point of comparison for it.

Numerics: fp32. Per-step log-decay is clamped to >= -1 (w >= e^-1), so
with chunk <= 64 every within-chunk exponent stays below 64 < log(fp32
max) ~ 88. The Mamba recurrences of the reference module come with the
Mamba slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

_MIN_LOGW = -1.0  # w >= e^-1; keeps all chunk exponents fp32-safe for C<=64


def clamp_decay(w: Tensor) -> Tensor:
    """``exp(max(log(max(w, 1e-38)), -1))`` in fp32: the clamp contract
    of ``wkv_chunked``, ``wkv_ref`` and ``wkv_decode_step``."""
    w = w.to(torch.float32)
    return torch.exp(torch.clamp_min(torch.log(torch.clamp_min(w, 1e-38)),
                                     _MIN_LOGW))


def wkv_chunked(r: Tensor, w: Tensor, k: Tensor, v: Tensor,
                u: Optional[Tensor], s0: Optional[Tensor] = None,
                chunk: int = 64, variant: str = "tape",
                out_dtype=None) -> Tuple[Tensor, Tensor]:
    """RWKV6-style readout over the diagonal-linear recurrence.

    r, w, k: (B, T, dk), w the multiplicative decay in (0, 1]; v: (B, T,
    dv); u: (dk,) current-token bonus or None; s0: (B, dk, dv) or None.
    Returns (y: (B, T, dv) [out_dtype, default fp32], s_final: (B, dk, dv)
    fp32). Only the reference's default ``tape`` variant is ported.
    """
    if variant != "tape":
        raise NotImplementedError(
            f"wkv_chunked variant {variant!r}: the port has only 'tape'")
    assert chunk <= 64, "chunk > 64 breaks the fp32 exponent bound"
    b, t, dk = r.shape
    dv = v.shape[-1]
    r, w, k, v = (z.to(torch.float32) for z in (r, w, k, v))

    pad = (-t) % chunk
    if pad:
        z = r.new_zeros((b, pad, dk))
        r = torch.cat([r, z], 1)
        k = torch.cat([k, z], 1)
        w = torch.cat([w, r.new_ones((b, pad, dk))], 1)
        v = torch.cat([v, v.new_zeros((b, pad, dv))], 1)
    tp = t + pad
    nc = tp // chunk

    rc = r.reshape(b, nc, chunk, dk)
    wc = w.reshape(b, nc, chunk, dk)
    kc = k.reshape(b, nc, chunk, dk)
    vc = v.reshape(b, nc, chunk, dv)

    logw = torch.clamp_min(torch.log(torch.clamp_min(wc, 1e-38)), _MIN_LOGW)
    cum = torch.cumsum(logw, dim=2)                    # cum_j = sum_{i<=j}
    cum_prev = cum - logw                              # decay start -> j-1
    d_full = torch.exp(cum[:, :, -1])                  # (b, nc, dk)

    rq = rc * torch.exp(cum_prev)                      # r_j decayed from start
    ks = kc * torch.exp(-cum)                          # k_i advanced to start
    kd = kc * torch.exp(cum[:, :, -1:, :] - cum)       # k_i decayed to end

    # intra-chunk causal readout: pairs (i < j) within the chunk
    att = torch.einsum("bnjk,bnik->bnji", rq, ks)      # (b, nc, C, C)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    att = torch.where(mask, att, torch.zeros((), device=r.device))
    y_intra = torch.einsum("bnji,bniv->bnjv", att, vc)

    if u is not None:
        bonus = torch.einsum("bnjk,k,bnjk->bnj", rc, u.to(torch.float32), kc)
        y_intra = y_intra + bonus[..., None] * vc

    # chunk summaries + boundary handoff (the global-counter scan)
    upd = torch.einsum("bnik,bniv->bnkv", kd, vc)      # (b, nc, dk, dv)
    s = (r.new_zeros((b, dk, dv)) if s0 is None
         else s0.to(torch.float32))
    s_in = []
    for n in range(nc):
        s_in.append(s)                                 # incoming state
        s = d_full[:, n, :, None] * s + upd[:, n]
    s_in = torch.stack(s_in, dim=1)                    # (b, nc, dk, dv)

    y = y_intra + torch.einsum("bnjk,bnkv->bnjv", rq, s_in)
    y = y.reshape(b, tp, dv)[:, :t]
    if out_dtype is not None:
        y = y.to(out_dtype)
    return y, s


def wkv_steps(r, w, k, v, u=None, s0=None) -> Tuple[Tensor, Tensor]:
    """The recurrence one step at a time, in fp32, with ``w`` as given (no
    clamp): ``ref.ssm_scan_ref``'s loop, from ``s0`` (B, dk, dv) or zero,
    returning (y (B, T, dv), the final state)."""
    b, t, dk = r.shape
    dv = v.shape[-1]
    r, w, k, v = (z.to(torch.float32) for z in (r, w, k, v))
    uu = r.new_zeros((dk,)) if u is None else u.to(torch.float32)
    s = (r.new_zeros((b, dk, dv)) if s0 is None
         else s0.to(torch.float32).clone())
    ys = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        ys.append(torch.sum(r[:, i, :, None] * (s + uu[:, None] * kv),
                            dim=1))
        s = w[:, i, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else r.new_zeros((b, 0, dv))
    return y, s


def wkv_ref(r, w, k, v, u, s0=None) -> Tuple[Tensor, Tensor]:
    """Sequential oracle for wkv_chunked (same clamp contract)."""
    return wkv_steps(r, clamp_decay(w), k, v, u, s0)


def wkv_decode_step(r, w, k, v, u, s) -> Tuple[Tensor, Tensor]:
    """Single-token WKV update (serving): r/w/k: (B, dk); v: (B, dv);
    s: (B, dk, dv). Returns (y: (B, dv), s_next)."""
    r, k, v, s = (z.to(torch.float32) for z in (r, k, v, s))
    w = clamp_decay(w)
    kv = k[:, :, None] * v[:, None, :]
    uu = torch.zeros_like(r[0]) if u is None else u.to(torch.float32)
    y = torch.einsum("bk,bkv->bv", r, s + uu[None, :, None] * kv)
    s_next = w[:, :, None] * s + kv
    return y, s_next
