"""Chunked linear-attention recurrences, WKV (RWKV6) and Mamba (S6) (port
of ``repro.core.linear_attn``).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t                       (WKV)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

    h_t = exp(dt_t A) (.) h_{t-1} + (dt_t x_t) B_t             (Mamba)
    y_t = h_t C_t^T + D (.) x_t

``wkv_chunked`` and ``mamba_chunked`` are the chunk-parallel forms
(intra-chunk work plus a short scan over the T/C chunk-boundary states),
``wkv_ref`` and ``mamba_ref`` their sequential oracles, and
``wkv_decode_step`` and ``mamba_decode_step`` one serving step each. The
model's RWKV prefill runs the WKV recurrence on the hand-written kernel
(``kernels.ssm_scan``) instead; ``wkv_chunked`` stays as the plain-torch
point of comparison for it. The reference has no Pallas kernel for the
Mamba scan, so ``mamba_chunked`` is what the Mamba layers run, on the card
too.

Numerics: fp32. Per-step log-decay is clamped to >= -1 (w >= e^-1, and
dt * A >= -1 for Mamba), so with chunk <= 64 every within-chunk exponent
stays below 64 < log(fp32 max) ~ 88.
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


def mamba_chunked(x: Tensor, dt: Tensor, a: Tensor, b_in: Tensor,
                  c_in: Tensor, d_skip: Tensor, h0: Optional[Tensor] = None,
                  chunk: int = 64) -> Tuple[Tensor, Tensor]:
    """Mamba (S6) selective scan, chunk-parallel.

    x, dt: (B, T, d) input and positive step sizes; a: (d, n) negative
    state matrix; b_in, c_in: (B, T, n); d_skip: (d,); h0: (B, d, n) or
    None. Returns (y: (B, T, d) fp32, h_final: (B, d, n) fp32).

    Within a chunk the prefix is a rescaled cumsum, h_j = e^{cum_j} (h_in
    + sum_{i<=j} e^{-cum_i} u_i); across chunks only the T/C boundary
    states are scanned. Padding steps carry dt = 0 (decay 1, no input), so
    ``h_final`` is the state after step T. The (B, T/C, C, d, n)
    temporaries are dropped as soon as the next one is made.
    """
    assert chunk <= 64, "chunk > 64 breaks the fp32 exponent bound"
    bsz, t, d = x.shape
    n = a.shape[-1]
    x, dt, a, b_in, c_in, d_skip = (z.to(torch.float32) for z in
                                    (x, dt, a, b_in, c_in, d_skip))

    pad = (-t) % chunk
    if pad:
        x, dt, b_in, c_in = (torch.cat([z, z.new_zeros((bsz, pad,
                                                         z.shape[-1]))], 1)
                             for z in (x, dt, b_in, c_in))
    tp = t + pad
    nc = tp // chunk

    xc = x.reshape(bsz, nc, chunk, d)
    dtc = dt.reshape(bsz, nc, chunk, d)
    bc = b_in.reshape(bsz, nc, chunk, n)
    cc = c_in.reshape(bsz, nc, chunk, n)

    # log decay per step and (channel, state): dt * A, clamped like wkv
    cum = torch.clamp_min(dtc[..., :, None] * a, _MIN_LOGW)
    cum = torch.cumsum(cum, dim=2)                     # (b, nc, C, d, n)
    # input contribution u_i = dt_i x_i B_i (outer over n), rescaled to the
    # chunk start and summed: acc_j = sum_{i<=j} e^{-cum_i} u_i
    acc = (dtc * xc)[..., :, None] * bc[..., None, :]
    acc = torch.cumsum(torch.exp(-cum) * acc, dim=2)

    d_full = torch.exp(cum[:, :, -1])                  # (b, nc, d, n)
    upd = d_full * acc[:, :, -1]                       # sum_i e^{cum_C-cum_i}u

    h = (x.new_zeros((bsz, d, n)) if h0 is None else h0.to(torch.float32))
    h_in = []
    for j in range(nc):                                # the boundary scan
        h_in.append(h)
        h = d_full[:, j] * h + upd[:, j]
    h_in = torch.stack(h_in, dim=1)                    # (b, nc, d, n)

    hs = torch.exp(cum)
    del cum
    hs = hs * (h_in[:, :, None] + acc)                 # (b, nc, C, d, n)
    del acc
    y = torch.einsum("bnjds,bnjs->bnjd", hs, cc)
    y = y + d_skip * xc
    y = y.reshape(bsz, tp, d)[:, :t]
    return y, h


def mamba_ref(x, dt, a, b_in, c_in, d_skip, h0=None) -> Tuple[Tensor,
                                                                 Tensor]:
    """Sequential oracle for mamba_chunked (same clamp contract)."""
    bsz, t, d = x.shape
    n = a.shape[-1]
    x, dt, a, b_in, c_in, d_skip = (z.to(torch.float32) for z in
                                    (x, dt, a, b_in, c_in, d_skip))
    h = x.new_zeros((bsz, d, n)) if h0 is None else h0.to(torch.float32)
    ys = []
    for i in range(t):
        y, h = mamba_decode_step(x[:, i], dt[:, i], a, b_in[:, i],
                                 c_in[:, i], d_skip, h)
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bsz, 0, d))
    return y, h


def mamba_decode_step(x, dt, a, b_in, c_in, d_skip, h) -> Tuple[Tensor,
                                                                 Tensor]:
    """Single-token Mamba update: x/dt: (B, d); b_in/c_in: (B, n);
    h: (B, d, n). Returns (y: (B, d), h_next)."""
    x, dt, a, b_in, c_in, d_skip, h = (z.to(torch.float32) for z in
                                       (x, dt, a, b_in, c_in, d_skip, h))
    la = torch.clamp_min(dt[:, :, None] * a[None], _MIN_LOGW)
    h_next = torch.exp(la) * h + (dt * x)[:, :, None] * b_in[:, None, :]
    y = torch.einsum("bds,bs->bd", h_next, c_in) + d_skip * x
    return y, h_next
