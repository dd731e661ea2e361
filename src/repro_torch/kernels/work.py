"""The work of each hand-written kernel, stated once.

One function per kernel row of ``PERF.md`` section 6. Each returns a
``Work(flops, bytes)`` for one launch at the given shape, by the rule of
that table's "Bound ms" column: every input read once, every output
written once, and the operations the kernel computes on them (a
multiply-add counts 2). ``launch.roofline.kernel_bound_s`` turns a
``Work`` into the card's least time for it.

The kernel wrappers charge these numbers to every active cost walk
(``launch.op_analysis``): their CUDA branches once per launch, and their
meta branches, which run only inside a walk, in place of the launch.
Outside a walk ``charge`` does nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np


class Work(NamedTuple):
    flops: int
    bytes: int


def chain_scan(n: int, t: int) -> Work:
    """Banded max-plus chain over ``n`` rows of ``t`` fp32 scores: scores
    and w read; f and the int32 offsets written; a max and an add per
    band entry."""
    return Work(2 * n * t, n * t * 4 + 3 * n * 4)


def dp_tile(tr: int, tc: int) -> Work:
    """One fp32 DP tile: top, left and corner boundaries and the two int32
    character strips read; the tile, its bottom row, right column and
    corner written; 7 operations a cell."""
    return Work(7 * tr * tc, 4 * (tc + tr + 1) + 4 * (tr + tc)
                + 4 * (tr * tc + tc + tr + 1))


def dp_wavefront(n: int, m: int) -> Work:
    """A whole n x m fp32 DP matrix in one launch: the two int32
    sequences, top, left and corner read; the matrix, bottom row, right
    column and corner written; 7 operations a cell."""
    return Work(7 * n * m, 4 * (2 * (n + m) + 1) + 4 * (n * m + m + n + 1))


def radix_rank(n_chunks: int, chunk_len: int) -> Work:
    """One 8-bit LSD pass over int64 keys: keys read; int32 ranks and the
    256-bucket histogram of each chunk written; 2 operations a key."""
    n = n_chunks * chunk_len
    return Work(2 * n, n * 8 + n * 4 + n_chunks * 256 * 4)


def radix_sort_chunks(n_chunks: int, chunk_len: int) -> Work:
    """The whole chunked sort (one histogram launch, four pass launches):
    int64 keys read; sorted keys and int32 indices written; 2 operations a
    key in each of the 5 launches."""
    n = n_chunks * chunk_len
    return Work(2 * 5 * n, n * (8 + 8 + 4))


def ssm_scan(b: int, t: int, dk: int, dv: int, with_u: bool = False,
             with_s0: bool = False) -> Work:
    """The fp32 WKV scan: r, w, k, v (and u, s0) read; y and the final
    state written; per step and state element a multiply-add for the decay
    and the k v product and one for the readout."""
    n_bytes = 4 * (b * t * (3 * dk + dv) + b * t * dv + b * dk * dv)
    n_bytes += 4 * dk * with_u + 4 * b * dk * dv * with_s0
    return Work(5 * b * t * dk * dv, n_bytes)


def ssm_scan_bwd(b: int, t: int, dk: int, dv: int, with_u: bool = False,
                 with_s0: bool = False, with_ds_final: bool = False) -> Work:
    """The fp32 WKV backward: r, w, k, v, dy (u, s0, the final state's
    gradient) read; dr, dw, dk, dv (du, ds0) written; six multiply-adds per
    step and state element (the state's recompute, G's two terms, the dr,
    dk, dv and dw products)."""
    n_bytes = 4 * b * t * (3 * dk + 2 * dv + 3 * dk + dv)
    n_bytes += 4 * 2 * dk * with_u + 4 * 2 * b * dk * dv * with_s0
    n_bytes += 4 * b * dk * dv * with_ds_final
    return Work(12 * b * t * dk * dv, n_bytes)


def visible_pairs(sq: int, skv: int, window: int = 0) -> int:
    """(q, kv) position pairs one head attends: kv position j is visible to
    q position i when j <= i and, for window > 0, i - j < window
    (``kernels.flash_attention``'s rule)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(b: int, h: int, kvh: int, sq: int, skv: int, hd: int,
                    window: int, elem_bytes: int,
                    with_lse: bool = False) -> Work:
    """Causal attention: q, k, v read; the output (and the fp32 row
    log-sum-exp) written; q.k and p.v, 2 hd multiply-adds per visible
    pair."""
    pairs = b * h * visible_pairs(sq, skv, window)
    n_bytes = (2 * b * h * sq * hd + 2 * b * kvh * skv * hd) * elem_bytes
    return Work(4 * hd * pairs, n_bytes + 4 * b * h * sq * with_lse)


def flash_attention_bwd(b: int, h: int, kvh: int, sq: int, skv: int,
                        hd: int, window: int, elem_bytes: int) -> Work:
    """The attention backward: q, k, v, o, dO and the fp32 lse read; dq,
    dk, dv written; 2.5x the forward's operations (S, dP, dV, dK, dQ: five
    products against the forward's two)."""
    pairs = b * h * visible_pairs(sq, skv, window)
    q, kv = b * h * sq * hd, b * kvh * skv * hd
    n_bytes = (2 * (q + 2 * kv) + 2 * q) * elem_bytes + 4 * b * h * sq
    return Work(10 * hd * pairs, n_bytes)


#: the work function of each kernel, by the name its wrapper charges
WORK: Dict[str, Callable[..., Work]] = {
    "chain_scan": chain_scan, "dp_tile": dp_tile,
    "dp_wavefront": dp_wavefront, "radix_rank": radix_rank,
    "radix_sort_chunks": radix_sort_chunks, "ssm_scan": ssm_scan,
    "ssm_scan_bwd": ssm_scan_bwd, "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd}

# the cost walks open now (``launch.op_analysis.OpWalk``), innermost last:
# one list for the process, not per thread, since on the card the autograd
# engine runs the backward kernels' wrappers on a thread of its own
_walks: List = []


def active() -> bool:
    """Whether a cost walk is open."""
    return bool(_walks)


def push(walk) -> None:
    _walks.append(walk)


def pop(walk) -> None:
    _walks.remove(walk)


def charge(kernel: str, *args, **kwargs) -> None:
    """Charge one launch of ``kernel``, ``WORK[kernel](*args, **kwargs)``,
    to every open walk (``walk.charge_kernel(kernel, work)``). Nothing is
    computed when no walk is open."""
    if not _walks:
        return
    work = WORK[kernel](*args, **kwargs)
    for walk in _walks:
        walk.charge_kernel(kernel, work)
