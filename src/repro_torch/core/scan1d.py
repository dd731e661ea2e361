"""1-D dependency-bound recurrence engine (port of ``repro.core.scan1d``).

The recurrence

    x_t = (a_t (*) x_{t-1}) (+) b_t        (elementwise over the state)

runs in one of three modes, all exact up to the semiring's float
association:

* ``sequential``  — one step at a time (the software-mutex baseline).
* ``chunked``     — the timeline is cut into W chunks ("workers"); each
  computes its local prefix maps independently, only the chunk summaries
  flow through a short scan (the global-counter handoff), then every chunk
  applies its prefixes to its incoming state.
* ``associative`` — a parallel prefix over affine elements, combined in the
  order ``jax.lax.associative_scan`` uses (``associative_scan`` below), so
  the float results associate as in the reference.

Time is axis 0; trailing axes are the state (a batch of independent
recurrences rides there).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core.semiring import REAL, Semiring, finite_zero

Tensor = torch.Tensor


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    out = torch.empty((even.shape[0] + odd.shape[0],) + even.shape[1:],
                      dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(fn: Callable[[List[Tensor], List[Tensor]],
                                  List[Tensor]],
                     elems: List[Tensor]) -> List[Tensor]:
    """Inclusive scan over axis 0 with the recursion of
    ``jax.lax.associative_scan``: pairs are combined in the same order, so
    float results associate the same way. ``fn(x, y)`` combines lists of
    tensors elementwise, x before y."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[0:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[0:1], r], dim=0) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _identity_pair(sr: Semiring, shape, dtype, device
                   ) -> Tuple[Tensor, Tensor]:
    one = torch.full(shape, sr.one, dtype=dtype, device=device)
    zero = finite_zero(sr, dtype).to(device).expand(shape)
    return one, zero


def _combiner(sr: Semiring):
    def combine(e1, e2):
        return list(sr.affine_compose(e1[0], e1[1], e2[0], e2[1]))
    return combine


def affine_scan_sequential(a: Tensor, b: Tensor, x0: Tensor,
                           sr: Semiring = REAL) -> Tensor:
    """One step at a time. Returns x_t for t = 1..T, shaped like a."""
    xs = torch.empty_like(a)
    x = x0
    for t in range(a.shape[0]):
        x = sr.affine_apply(a[t], b[t], x)
        xs[t] = x
    return xs


def affine_scan_associative(a: Tensor, b: Tensor, x0: Tensor,
                            sr: Semiring = REAL) -> Tensor:
    """Parallel prefix over affine elements: depth O(log T)."""
    pa, pb = associative_scan(_combiner(sr), [a, b])
    return sr.affine_apply(pa, pb, x0[None])


def affine_scan_chunked(a: Tensor, b: Tensor, x0: Tensor,
                        sr: Semiring = REAL, num_chunks: int = 8,
                        boundary_mode: str = "sequential") -> Tensor:
    """Squire-faithful chunked execution: local prefix maps per chunk (all
    chunks at once), a scan over the chunk summaries, then each chunk's
    prefixes applied to its incoming state."""
    t = a.shape[0]
    lc = -(-t // num_chunks)
    pad = lc * num_chunks - t
    rest = a.shape[1:]
    if pad:
        ia, ib = _identity_pair(sr, (pad,) + rest, a.dtype, a.device)
        a = torch.cat([a, ia], dim=0)
        b = torch.cat([b, ib], dim=0)

    ac = a.reshape((num_chunks, lc) + rest)
    bc = b.reshape((num_chunks, lc) + rest)
    pa, pb = _identity_pair(sr, (num_chunks,) + rest, a.dtype, a.device)
    pas = torch.empty_like(ac)
    pbs = torch.empty_like(bc)
    for s in range(lc):                          # every chunk at once
        pa, pb = sr.affine_compose(pa, pb, ac[:, s], bc[:, s])
        pas[:, s] = pa
        pbs[:, s] = pb
    sum_a, sum_b = pas[:, -1], pbs[:, -1]         # chunk summaries

    if boundary_mode == "associative":
        ca, cb = associative_scan(_combiner(sr), [sum_a, sum_b])
        starts = torch.cat(
            [x0[None].to(a.dtype).expand((1,) + rest),
             sr.affine_apply(ca[:-1], cb[:-1], x0[None])], dim=0)
    else:
        starts = torch.empty((num_chunks,) + rest, dtype=a.dtype,
                             device=a.device)
        x = x0
        for w in range(num_chunks):              # incoming state per chunk
            starts[w] = x
            x = sr.affine_apply(sum_a[w], sum_b[w], x)

    xs = sr.affine_apply(pas, pbs, starts[:, None])
    return xs.reshape((num_chunks * lc,) + rest)[:t]


def affine_scan(a: Tensor, b: Tensor, x0: Tensor, sr: Semiring = REAL,
                mode: str = "sequential", num_chunks: int = 8,
                boundary_mode: str = "sequential") -> Tensor:
    """Run the affine recurrence in ``mode``."""
    if mode == "sequential":
        return affine_scan_sequential(a, b, x0, sr)
    if mode == "associative":
        return affine_scan_associative(a, b, x0, sr)
    if mode == "chunked":
        return affine_scan_chunked(a, b, x0, sr, num_chunks=num_chunks,
                                   boundary_mode=boundary_mode)
    raise ValueError(f"unknown scan1d mode: {mode!r}")


# ---------------------------------------------------------------------------
# Matrix-state recurrence (diagonal decay + rank-1 update), the SSM/RWKV
# workhorse: S_t = diag(w_t) S_{t-1} + k_t^T v_t, state (dk, dv).
# ---------------------------------------------------------------------------

def diag_rank1_scan(w: Tensor, k: Tensor, v: Tensor, s0: Tensor,
                    mode: str = "chunked", chunk: int = 64) -> Tensor:
    """w (T, dk) multiplicative decay, k (T, dk), v (T, dv), s0 (dk, dv).
    Returns the state after each step, (T, dk, dv). ``chunked`` keeps
    states only at chunk boundaries and rebuilds the rest with cumulative
    log-decays and prefix sums of the decay-scaled outer products."""
    t, dk = w.shape
    dv = v.shape[-1]

    if mode == "sequential":
        states = torch.empty((t, dk, dv), dtype=s0.dtype, device=s0.device)
        s = s0
        for i in range(t):
            s = w[i][:, None] * s + k[i][:, None] * v[i][None, :]
            states[i] = s
        return states

    lc = chunk
    nch = -(-t // lc)
    pad = nch * lc - t
    if pad:
        w = torch.cat([w, torch.ones((pad, dk), dtype=w.dtype,
                                     device=w.device)])
        k = torch.cat([k, torch.zeros((pad, dk), dtype=k.dtype,
                                      device=k.device)])
        v = torch.cat([v, torch.zeros((pad, dv), dtype=v.dtype,
                                      device=v.device)])

    wc = w.reshape(nch, lc, dk)
    kc = k.reshape(nch, lc, dk)
    vc = v.reshape(nch, lc, dv)

    logw = torch.log(torch.clamp_min(wc, 1e-38))
    cum = torch.cumsum(logw, dim=1)                    # log D_j
    d_full = torch.exp(cum[:, -1])                     # chunk decay
    scale = torch.exp(cum[:, -1:, :] - cum)
    u = torch.einsum("clk,clv->ckv", scale * kc, vc)   # chunk update

    s_in = torch.empty((nch, dk, dv), dtype=s0.dtype, device=s0.device)
    s = s0
    for c in range(nch):                               # incoming states
        s_in[c] = s
        s = d_full[c][:, None] * s + u[c]

    k_scaled = kc * torch.exp(-cum)
    outer = k_scaled[..., :, None] * vc[..., None, :]  # (nch, lc, dk, dv)
    acc = torch.cumsum(outer, dim=1)
    states = torch.exp(cum)[..., None] * (s_in[:, None] + acc)
    return states.reshape(nch * lc, dk, dv)[:t]
