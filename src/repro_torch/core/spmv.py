"""Chunk-parallel sparse matrix-vector product (paper Fig. 1c; port of
``repro.core.spmv``).

Rows are the dependency-free fine-grain units; the irregularity (variable
nonzeros per row) is what defeats lockstep SIMD. Two fixed-shape forms:

  * **ELL-style worker chunks** (``spmv_chunked``): rows are padded to the
    chunk's most nonzeros, and the whole (chunks, rows_per, width) plan is
    one batched gather-multiply-sum; load imbalance stays inside a chunk.
  * **segment-sum form** (``spmv_segsum``): a flat COO gather and a sum
    by row id (``index_add_``).

``random_csr`` and ``_ell_pack`` are numpy, copied from the reference, so
one seed gives one matrix in both packages. Both products run on the
device of ``x``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class CSR(NamedTuple):
    """Fixed-shape CSR: indptr (n+1,), indices (nnz,), data (nnz,)."""
    indptr: Tensor
    indices: Tensor
    data: Tensor
    n_cols: int


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def random_csr(n_rows: int, n_cols: int, density: float, seed: int = 0,
               skew: float = 0.0, device: DeviceLike = None) -> CSR:
    """Synthetic sparse matrix; ``skew`` > 0 gives power-law row lengths
    (the load imbalance the paper calls out)."""
    rng = np.random.default_rng(seed)
    base = max(1, int(n_cols * density))
    if skew > 0:
        lens = np.minimum(
            (base * rng.pareto(1.0 + 1.0 / max(skew, 1e-6), n_rows) +
             1).astype(np.int64), n_cols)
    else:
        lens = np.full(n_rows, base)
    indptr = np.zeros(n_rows + 1, np.int32)
    indptr[1:] = np.cumsum(lens)
    nnz = int(indptr[-1])
    indices = np.concatenate(
        [np.sort(rng.choice(n_cols, size=l, replace=False)) for l in lens])
    data = rng.normal(size=nnz).astype(np.float32)
    dev = resolve_device(device)
    return CSR(torch.as_tensor(indptr).to(dev),
               torch.as_tensor(indices.astype(np.int32)).to(dev),
               torch.as_tensor(data).to(dev), n_cols)


def to_dense(m: CSR, n_rows: int) -> np.ndarray:
    out = np.zeros((n_rows, m.n_cols), np.float32)
    indptr = _np(m.indptr)
    idx, dat = _np(m.indices), _np(m.data)
    for r in range(n_rows):
        for j in range(indptr[r], indptr[r + 1]):
            out[r, idx[j]] += dat[j]
    return out


# --------------------------------------------------------------------------
# ELL-style chunked execution (the worker partitioning)
# --------------------------------------------------------------------------

def _ell_pack(m: CSR, n_rows: int, num_chunks: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side: rows -> (chunk, row, slot) fixed-capacity gather plan."""
    indptr = _np(m.indptr)
    lens = np.diff(indptr)
    rows_per = -(-n_rows // num_chunks)
    width = 0
    for c in range(num_chunks):
        lo, hi = c * rows_per, min((c + 1) * rows_per, n_rows)
        if lo < hi:
            width = max(width, int(lens[lo:hi].max()))
    width = max(width, 1)
    cols = np.zeros((num_chunks, rows_per, width), np.int32)
    vals = np.zeros((num_chunks, rows_per, width), np.float32)
    idx, dat = _np(m.indices), _np(m.data)
    for c in range(num_chunks):
        for r in range(rows_per):
            row = c * rows_per + r
            if row >= n_rows:
                continue
            lo, hi = indptr[row], indptr[row + 1]
            cols[c, r, :hi - lo] = idx[lo:hi]
            vals[c, r, :hi - lo] = dat[lo:hi]
    return cols, vals, lens, rows_per


def ell_plan(m: CSR, n_rows: int, num_chunks: int, device
             ) -> Tuple[Tensor, Tensor]:
    """The ELL plan of ``_ell_pack`` as (cols int64, vals fp32) tensors of
    shape (num_chunks, rows_per, width) on ``device``."""
    cols, vals, _, _ = _ell_pack(m, n_rows, num_chunks)
    return (torch.as_tensor(cols).to(device=device, dtype=torch.int64),
            torch.as_tensor(vals).to(device))


def spmv_ell(cols: Tensor, vals: Tensor, x: Tensor, n_rows: int) -> Tensor:
    """One batched gather-multiply-sum over an ELL plan; zero padding makes
    the irregularity exact."""
    return torch.sum(vals * x[cols], dim=-1).reshape(-1)[:n_rows]


def spmv_chunked(m: CSR, x: Tensor, n_rows: int, num_chunks: int = 8
                 ) -> Tensor:
    """Worker-chunked SpMV: each chunk is a dense (rows_per, width)
    gather-multiply-reduce, all chunks in one batched call."""
    cols, vals = ell_plan(m, n_rows, num_chunks, x.device)
    return spmv_ell(cols, vals, x, n_rows)


# --------------------------------------------------------------------------
# segment-sum form (flat COO; the 1-D handoff formulation)
# --------------------------------------------------------------------------

def row_ids(m: CSR) -> Tensor:
    """The row of every nonzero (monotone), int64."""
    nnz = m.data.shape[0]
    return torch.searchsorted(
        m.indptr.to(torch.int64),
        torch.arange(nnz, dtype=torch.int64, device=m.data.device),
        right=True) - 1


def spmv_segsum(m: CSR, x: Tensor, n_rows: int) -> Tensor:
    """products = data * x[indices]; y = their sum by row id."""
    prod = m.data * x[m.indices.to(torch.int64)]
    return torch.zeros(n_rows, dtype=prod.dtype,
                       device=prod.device).index_add_(0, row_ids(m), prod)
