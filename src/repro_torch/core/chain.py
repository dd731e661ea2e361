"""Minimap2 chain kernel (port of ``repro.core.chain``): 1-D banded max-plus DP

    f(i) = max( w_i,  max_{i-T <= j < i} [ f(j) + alpha(i,j) - beta(i,j) ] )

with the paper's loop fission (the (N, T) match-up scores are one dense,
dependency-free pass, ``chain_scores``) and band truncation T = 64.

Modes for the serial part:
  * 'sequential' / 'fission' — one row per step with a (T,) ring.
  * 'blocked' — band-to-band max-plus transfer matrices per block, composed
    with the same associative-scan schedule as ``jax.lax.associative_scan``
    (so the fp32 sums associate as in the reference), then replayed.
The hand-written CUDA kernel of the sequential mode is
``repro_torch.kernels.chain_scan``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.semiring import MAXPLUS

Tensor = torch.Tensor

NEG = -1e18     # as float32: -999999984306749440


class ChainParams(NamedTuple):
    kmer: int = 15          # anchor width (w_i and alpha cap)
    max_dist: int = 5000    # max reference/query span of a match-up
    bandwidth: int = 500    # max |dq - dr| (gap)
    gap_scale: float = 0.01


def chain_scores(q: Tensor, r: Tensor, T: int,
                 params: ChainParams = ChainParams(),
                 anchor_valid: Tensor | None = None) -> Tensor:
    """Fission phase: dense (N, T) fp32 match-up scores S[i, t] of chaining
    anchor i after anchor i - t; NEG where invalid. q, r: (N,) integer
    positions sorted by r. Keeps the reference's fp32 operation order."""
    n = q.shape[0]
    dev = q.device
    q = q.to(torch.int64)
    r = r.to(torch.int64)
    idx = torch.arange(n, device=dev)[:, None]
    t = torch.arange(1, T + 1, device=dev)[None, :]
    j = idx - t
    valid = j >= 0
    jc = j.clamp(0, n - 1)

    dq = q[:, None] - q[jc]
    dr = r[:, None] - r[jc]
    gap = (dq - dr).abs().to(torch.float32)

    alpha = torch.minimum(torch.minimum(dq, dr),
                          torch.tensor(params.kmer, device=dev)
                          ).to(torch.float32)
    beta = (params.gap_scale * params.kmer * gap
            + 0.5 * torch.log2(gap + 1.0))

    ok = (valid & (dq > 0) & (dr >= 0)
          & (dq <= params.max_dist) & (dr <= params.max_dist)
          & (gap <= params.bandwidth))
    if anchor_valid is not None:
        ok &= anchor_valid[:, None] & anchor_valid[jc]
    return torch.where(ok, alpha - beta,
                       torch.tensor(NEG, dtype=torch.float32, device=dev))


def _first_argmax(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(max, index of its first occurrence) over the last axis, like
    ``jnp.argmax``."""
    best = torch.amax(x, dim=-1, keepdim=True)
    pos = torch.arange(x.shape[-1], device=x.device)
    first = torch.where(x == best, pos, x.shape[-1]).amin(dim=-1)
    return best[..., 0], first


def _scan_rows(scores: Tensor, w: Tensor, ring: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """Consume rows of scores (..., N, T) from ring state (..., T), where
    ring[..., t-1] = f(i - t). Returns f (..., N) and off (..., N)."""
    n = scores.shape[-2]
    f = torch.empty(scores.shape[:-1], dtype=torch.float32,
                    device=scores.device)
    off = torch.empty(scores.shape[:-1], dtype=torch.int32,
                      device=scores.device)
    for i in range(n):
        wi = w[..., i]
        best, arg = _first_argmax(scores[..., i, :] + ring)
        fi = torch.maximum(best, wi)
        f[..., i] = fi
        off[..., i] = torch.where(best >= wi, arg + 1, 0).to(torch.int32)
        ring = torch.cat([fi[..., None], ring[..., :-1]], dim=-1)
    return f, off


def chain_sequential(scores: Tensor, w: Tensor) -> Tuple[Tensor, Tensor]:
    """Serial consumption phase. scores (..., N, T) fp32; w (..., N).

    Returns (f: (..., N) fp32, off: (..., N) int32 in [0, T]; 0 = start).
    """
    scores = scores.to(torch.float32)
    w = w.to(torch.float32)
    ring = torch.full(scores.shape[:-2] + scores.shape[-1:], NEG,
                      dtype=torch.float32, device=scores.device)
    return _scan_rows(scores, w, ring)


def _compose(mc1, mc2):
    """Apply mc1 then mc2 (max-plus affine composition), batched."""
    m1, c1 = mc1
    m2, c2 = mc2
    m = MAXPLUS.matmul(m2, m1)
    c = torch.maximum(MAXPLUS.matmul(m2, c1[..., :, None])[..., 0], c2)
    return m, c


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    out = torch.empty((even.shape[0] + odd.shape[0],) + even.shape[1:],
                      dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def _associative_scan(fn, elems: List[Tensor]) -> List[Tensor]:
    """Inclusive scan over axis 0 with the recursion of
    ``jax.lax.associative_scan``: pairs are combined in the same order, so
    float results associate the same way."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[0:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[0:1], r], dim=0) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def chain_blocked(scores: Tensor, w: Tensor, block: int = 16
                  ) -> Tuple[Tensor, Tensor]:
    """Tropical block-transfer associative scan (beyond the paper). Exact up
    to fp32 association; preds come from a parallel replay per block."""
    scores = scores.to(torch.float32)
    w = w.to(torch.float32)
    n, T = scores.shape
    dev = scores.device
    pad = (-n) % block
    if pad:
        scores = torch.cat([scores, torch.full((pad, T), NEG, device=dev)])
        w = torch.cat([w, torch.full((pad,), NEG, device=dev)])
    nb = scores.shape[0] // block

    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    eye = torch.where(torch.eye(T, dtype=torch.bool, device=dev), zero, neg)
    shift = torch.where(torch.ones(T, T, dtype=torch.bool, device=dev)
                        .tril(-1).triu(-1), zero, neg)    # v'[k] = v[k-1]

    sc_b = scores.reshape(nb, block, T)
    w_b = w.reshape(nb, block)

    # compose each block's steps in order, all blocks at once
    m = eye.expand(nb, T, T)
    c = torch.full((nb, T), NEG, device=dev)
    for s in range(block):
        sm = shift.expand(nb, T, T).clone()
        sm[:, 0, :] = sc_b[:, s, :]
        sc = torch.full((nb, T), NEG, device=dev)
        sc[:, 0] = w_b[:, s]
        m, c = _compose((m, c), (sm, sc))

    pm, pc = _associative_scan(
        lambda x, y: list(_compose(tuple(x), tuple(y))), [m, c])
    v0 = torch.full((T,), NEG, device=dev)
    v_in = torch.cat(
        [v0[None],
         torch.maximum(MAXPLUS.matmul(pm[:-1], v0[None, :, None])[..., 0],
                       pc[:-1])], dim=0)                # state entering block

    f, off = _scan_rows(sc_b, w_b, v_in)                # parallel replay
    return f.reshape(-1)[:n], off.reshape(-1)[:n]


def anchor_weights(n: int, params: ChainParams,
                   anchor_valid: Tensor | None, device) -> Tensor:
    """(N,) anchor self-scores w_i: the k-mer width, NEG for padding."""
    w = torch.full((n,), float(params.kmer), dtype=torch.float32,
                   device=device)
    if anchor_valid is not None:
        w = torch.where(anchor_valid, w,
                        torch.tensor(NEG, dtype=torch.float32, device=device))
    return w


def chain_anchors(q: Tensor, r: Tensor, T: int = 64,
                  params: ChainParams = ChainParams(),
                  mode: str = "fission", block: int = 16,
                  anchor_valid: Tensor | None = None):
    """Full chain kernel. Returns (f, pred) with pred[i] in [-1, i)."""
    w = anchor_weights(q.shape[0], params, anchor_valid, q.device)
    scores = chain_scores(q, r, T, params, anchor_valid=anchor_valid)
    if mode in ("sequential", "fission"):
        f, off = chain_sequential(scores, w)
    elif mode == "blocked":
        f, off = chain_blocked(scores, w, block=block)
    else:
        raise ValueError(f"unknown chain mode: {mode!r}")
    return f, pred_from_offsets(off)


def pred_from_offsets(off: Tensor) -> Tensor:
    """off (N,) in [0, T] -> pred (N,) int64, -1 at a chain start."""
    idx = torch.arange(off.shape[-1], device=off.device)
    return torch.where(off > 0, idx - off.to(torch.int64), -1)


def chain_ref_unbanded(q: np.ndarray, r: np.ndarray,
                       params: ChainParams = ChainParams(),
                       T: int = 5000):
    """Pure-numpy oracle with arbitrary T (float64)."""
    n = len(q)
    f = np.zeros(n, np.float64)
    pred = np.full(n, -1, np.int64)
    for i in range(n):
        best, bj = float(params.kmer), -1
        for j in range(i - 1, max(0, i - T) - 1, -1):
            dq, dr = q[i] - q[j], r[i] - r[j]
            if dq <= 0 or dr < 0 or dq > params.max_dist \
                    or dr > params.max_dist:
                continue
            g = abs(int(dq) - int(dr))
            if g > params.bandwidth:
                continue
            alpha = min(dq, dr, params.kmer)
            beta = params.gap_scale * params.kmer * g + 0.5 * np.log2(g + 1.0)
            sc = f[j] + alpha - beta
            if sc > best:
                best, bj = sc, j
        f[i] = best
        pred[i] = bj
    return f, pred


def backtrack(f: np.ndarray, pred: np.ndarray, min_score: float = 40.0):
    """Host-side chain extraction: chains in order of falling score, each a
    (score, members in anchor order) pair of at least two anchors."""
    order = np.argsort(-f)
    used = np.zeros(len(f), bool)
    chains = []
    for i in order:
        if f[i] < min_score:
            break
        if used[i]:
            continue
        node, members = int(i), []
        while node >= 0 and not used[node]:
            used[node] = True
            members.append(node)
            node = int(pred[node])
        if len(members) >= 2:
            chains.append((float(f[i]), members[::-1]))
    return chains
