"""GQA/MQA attention with blockwise online softmax and sliding-window,
ring-buffer KV caches (port of ``repro.models.attention``).

Layouts are the reference's: q (B, S, H, hd), k and v (B, S, KV, hd),
positions (B, S) absolute. Masks are by absolute position, so a ring
buffer needs no reordering before it is attended over and an empty slot
(position -1) is simply masked.

Three paths attend, as in the reference:

  * a fresh sequence (``cache=None``, prefill and training): with
    ``use_kernels`` the ``flash_attention`` kernel (``kernels.ops``), whose
    positions count from 0, so the caller passes it only the model's own
    positions 0..S-1; without it ``blockwise_attention``, or
    ``banded_attention`` for a window shorter than the sequence;
  * a chunk (vector positions, S > 1): ``blockwise_attention`` over the
    pre-update cache, rounded to bf16, with the chunk's own k and v
    appended unrounded;
  * one token: ``blockwise_attention`` over the post-update cache.

The KV cache is bf16 whatever the model's dtype, as in the reference. Its
updates are out of place (a new tensor per update), as JAX's are, so a
caller may reuse a cache it passed in.

The paged layout (``make_paged_cache``, ``paged_view``, ``paged_writeback``)
keeps attention KV in one flat pool of blocks per layer group, read and
written through the page tables of ``serve.paging``; its writeback is in
place, since the pool is the scarce memory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG_INF = -1e30


class AttnConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    bias: bool = False          # qwen-style QKV bias
    qk_norm: bool = False       # gemma3-style per-head RMS on q/k
    rope_theta: float = 1e4
    window: int = 0             # 0 = global; >0 sliding window
    kv_block: int = 512


def init_attention(g, cfg: AttnConfig, device=None):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": L.he_init(g, (d, h * hd), d, device),
        "wk": L.he_init(g, (d, kvh * hd), d, device),
        "wv": L.he_init(g, (d, kvh * hd), d, device),
        "wo": L.he_init(g, (h * hd, d), h * hd, device),
    }
    if cfg.bias:
        for name, n in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=device)
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, device)
        p["k_norm"] = L.init_rmsnorm(hd, device)
    return p


def _mxu(x: Tensor, model_dtype: torch.dtype) -> Tensor:
    """The reference's matmul input: rounded to bf16 in a bf16 model, then
    multiplied with fp32 accumulation (``preferred_element_type``)."""
    if model_dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    return x.to(torch.float32)


def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                        kv_pos: Tensor, window: int = 0,
                        kv_block: int = 512) -> Tensor:
    """Online-softmax attention over kv blocks of ``kv_block`` slots.

    q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd); q_pos: (B, Sq) absolute
    positions; kv_pos: (B, Skv) absolute slot positions (-1 = empty slot).
    Causal and sliding-window masks by absolute position.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    f32 = torch.float32
    blk = min(kv_block, skv)
    pad = (-skv) % blk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    nb = k.shape[1] // blk

    qr = (q.reshape(b, sq, kvh, grp, hd).permute(0, 2, 3, 1, 4).to(f32)
          * hd ** -0.5)                                  # (B, KV, G, Sq, hd)
    qr = _mxu(qr, q.dtype)
    qp = q_pos[:, None, None, :, None]
    m = torch.full((b, kvh, grp, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, kvh, grp, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, kvh, grp, sq, hd), dtype=f32, device=q.device)
    for i in range(nb):
        sl = slice(i * blk, (i + 1) * blk)
        posb = kv_pos[:, None, None, None, sl]           # (B, 1, 1, 1, blk)
        s = torch.einsum("bkgsh,btkh->bkgst", qr, _mxu(k[:, sl], q.dtype))
        ok = (posb <= qp) & (posb >= 0)
        if window > 0:
            ok &= (qp - posb) < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", p, v[:, sl].to(f32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def banded_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                     window: int) -> Tensor:
    """Exact sliding-window attention by block banding: a query in
    sequence block i (block size ``window``) sees only keys in blocks i-1
    and i, so each block attends to that 2w-key band.

    q: (B, S, H, hd); k/v: (B, S, KV, hd); q_pos: (B, S) absolute positions
    (consecutive per row). S is padded to a multiple of the window here.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    grp = h // kvh
    wb = window
    pad = (-s) % wb
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    sp = s + pad
    nb = sp // wb

    qb = q.reshape(b, nb, wb, h, hd)
    kb = k.reshape(b, nb, wb, kvh, hd)
    vb = v.reshape(b, nb, wb, kvh, hd)
    pb = q_pos.reshape(b, nb, wb)

    def shift(z):           # block i-1 at block i, zeros at block 0
        return torch.cat([torch.zeros_like(z[:, :1]), z[:, :-1]], dim=1)

    k_band = torch.cat([shift(kb), kb], dim=2)          # (b, nb, 2w, kv, hd)
    v_band = torch.cat([shift(vb), vb], dim=2)
    p_band = torch.cat([torch.full_like(pb[:, :1], -1), pb[:, :-1]], dim=1)
    p_band = torch.cat([p_band, pb], dim=2)             # (b, nb, 2w)

    qg = _mxu(qb.reshape(b, nb, wb, kvh, grp, hd), q.dtype)
    sc = torch.einsum("bnqkgh,bntkh->bnkgqt", qg,
                      _mxu(k_band, q.dtype)) * hd ** -0.5
    kp = p_band[:, :, None, None, None, :]
    qp = pb[:, :, None, None, :, None]
    ok = (kp <= qp) & (kp >= 0) & ((qp - kp) < window)
    sc = torch.where(ok, sc, NEG_INF)
    p = torch.where(ok, torch.softmax(sc, dim=-1), 0.0)
    out = torch.einsum("bnkgqt,bntkh->bnqkgh", p,
                       v_band.to(torch.float32))
    out = out.reshape(b, sp, h, hd)[:, :s]
    return out.to(q.dtype)


class KVCache(NamedTuple):
    """Static-shape decode cache. ``pos``: absolute position per slot (-1
    empty). Local layers allocate ``window`` slots (a ring buffer).

    Two position layouts: shared, ``pos: (S,)`` (every row decodes at the
    same position), and per-row, ``pos: (B, S)`` (each row its own clock).
    """
    k: Tensor      # (B, S, KV, hd)
    v: Tensor      # (B, S, KV, hd)
    pos: Tensor    # (S,) int32, or (B, S) int32 per-row


def make_cache(batch: int, slots: int, kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, per_row_pos: bool = False,
               device=None) -> KVCache:
    shape = (batch, slots) if per_row_pos else (slots,)
    return KVCache(
        k=torch.zeros((batch, slots, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, slots, kv_heads, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full(shape, -1, dtype=torch.int32, device=device))


def make_paged_cache(num_blocks: int, block_size: int, kv_heads: int,
                     head_dim: int, dtype=torch.bfloat16, periods: int = 1,
                     device=None) -> KVCache:
    """Flat physical block pool: (num_blocks + 1) * block_size rows, the
    last block the TRASH block, the sink of unmapped page-table entries
    (serve.paging). Backs global KV and sliding-window rings alike: the
    view length lives in the page table."""
    rows = (num_blocks + 1) * block_size
    return KVCache(
        k=torch.zeros((periods, rows, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((periods, rows, kv_heads, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((periods, rows), -1, dtype=torch.int32,
                       device=device))


def paged_live_rows(flat: KVCache, block_size: int) -> int:
    """Rows of ``flat`` that back real blocks: all but the trash block,
    which is the pool's last."""
    return flat.k.shape[1] - block_size


def paged_view(flat: KVCache, rows: Tensor, live_rows: int) -> KVCache:
    """Gather a per-slot contiguous view through a page table.

    flat: k/v (P, R, KV, hd), pos (P, R); rows: (B, V) int64 physical row
    per view position (``PageTable.rows()``); rows at or past
    ``live_rows`` are trash and read as the empty-slot encoding (k=v=0,
    pos=-1), which is what a freshly reset contiguous slot holds, so
    attending over the view is the contiguous path. For a sliding-window
    layer V is the ring length and ``rows`` come from a ring-mode table:
    ``pos % V`` addressing resolves through the view as in a dense ring.
    """
    ok = rows < live_rows                                   # (B, V)
    k = torch.where(ok[None, :, :, None, None], flat.k[:, rows], 0)
    v = torch.where(ok[None, :, :, None, None], flat.v[:, rows], 0)
    pos = torch.where(ok[None], flat.pos[:, rows], -1)
    return KVCache(k, v, pos)


def paged_writeback(flat: KVCache, view: KVCache, rows: Tensor) -> KVCache:
    """Scatter an updated view back into the pool, in place; returns
    ``flat``.

    A mapped row has one writer per step: a block shared by several slots
    is never inside a write span (the first write into one is preceded by
    a copy-on-write, ``serve/slots.py`` ensure()), and every sharer writes
    back the bytes it gathered. Unmapped view positions of every slot all
    land in the trash block, so its rows receive duplicate indices, and on
    CUDA which duplicate wins is undefined. That is harmless only because
    trash is always read masked (``paged_view``): never read it unmasked.
    """
    flat.k[:, rows] = view.k.to(flat.k.dtype)
    flat.v[:, rows] = view.v.to(flat.v.dtype)
    flat.pos[:, rows] = view.pos.to(torch.int32)
    return flat


def cache_update(cache: KVCache, k_new: Tensor, v_new: Tensor,
                 position) -> KVCache:
    """Insert new entries, ring-addressed: slot = pos % slots.

    ``position`` scalar: the shared-clock path; k_new/v_new (B, Sq) land at
    slot ``position % slots`` (clamped so that they fit, as
    ``lax.dynamic_update_slice`` clamps), and only that slot's position is
    written. ``position`` vector (B,): the per-row path; row b carries Sq
    consecutive tokens from ``position[b]`` (Sq > 1 is chunked prefill);
    it needs the per-row ``pos: (B, S)`` layout. A chunk longer than the
    ring keeps only its last ``slots`` tokens.
    """
    slots = cache.k.shape[1]
    dev = cache.k.device
    position = torch.as_tensor(position, dtype=torch.int64, device=dev)
    if position.dim() == 0:
        sq = k_new.shape[1]
        slot = position % slots
        start = torch.clamp(slot, 0, slots - sq)
        idx = start + torch.arange(sq, device=dev)
        k = cache.k.index_copy(1, idx, k_new.to(cache.k.dtype))
        v = cache.v.index_copy(1, idx, v_new.to(cache.v.dtype))
        pos = cache.pos.index_copy(0, slot.reshape(1),
                                   position.reshape(1).to(torch.int32))
        return KVCache(k, v, pos)

    if cache.pos.dim() != 2:
        raise ValueError("vector positions need the per-row pos=(B, S) "
                         "cache layout")
    b, sq = k_new.shape[0], k_new.shape[1]
    if sq > slots:
        k_new, v_new = k_new[:, -slots:], v_new[:, -slots:]
        position = position + (sq - slots)
        sq = slots
    pos_mat = position[:, None] + torch.arange(sq, device=dev)[None, :]
    slot = pos_mat % slots
    bidx = torch.arange(b, device=dev)[:, None]
    k, v, pos = cache.k.clone(), cache.v.clone(), cache.pos.clone()
    k[bidx, slot] = k_new.to(k.dtype)
    v[bidx, slot] = v_new.to(v.dtype)
    pos[bidx, slot] = pos_mat.to(torch.int32)
    return KVCache(k, v, pos)


def build_cache(k: Tensor, v: Tensor, positions: Tensor,
                slots: int) -> KVCache:
    """Prefill-path cache: keep the last ``slots`` positions, in bf16, with
    the shared ``pos: (slots,)`` layout. Positions must be consecutive per
    row, so pos % slots is a bijection onto the ring."""
    b, s = k.shape[0], k.shape[1]
    pos_row = positions[0].to(torch.int64)
    if s >= slots:
        k_w, v_w = k[:, -slots:], v[:, -slots:]
        pos_w = pos_row[-slots:]
    else:
        pad = slots - s
        k_w = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_w = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_w = F.pad(pos_row, (0, pad), value=-1)
    ring = torch.arange(slots, device=k.device)
    slot = torch.where(pos_w >= 0, pos_w % slots, ring % slots)
    kc, vc = torch.zeros_like(k_w), torch.zeros_like(v_w)
    kc[:, slot] = k_w
    vc[:, slot] = v_w
    pc = torch.full((slots,), -1, dtype=torch.int32, device=k.device)
    pc[slot] = pos_w.to(torch.int32)
    return KVCache(kc.to(torch.bfloat16), vc.to(torch.bfloat16), pc)


def attention(params, cfg: AttnConfig, x: Tensor, positions: Tensor,
              cache: Optional[KVCache] = None,
              position_scalar: Optional[Tensor] = None,
              make_cache_slots: Optional[int] = None,
              use_kernels: bool = False):
    """Self-attention (``cache=None``) or a decode step or chunk (cache
    given).

    x: (B, S, D); positions: (B, S) absolute. In decode ``position_scalar``
    is the shared scalar position or the (B,) per-row positions.
    ``make_cache_slots`` (prefill) builds and returns a decode cache of
    that many slots. ``use_kernels`` (fresh sequences only) attends through
    the ``flash_attention`` kernel and requires ``positions`` to be 0..S-1
    in every row. Returns (out (B, S, D), new_cache_or_None).
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype

    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)

    if cache is None:
        if use_kernels:
            out = ops.flash_attention(q, k, v, window=cfg.window)
        elif cfg.window > 0 and s > cfg.window:
            out = banded_attention(q, k, v, positions, cfg.window)
        else:
            out = blockwise_attention(q, k, v, positions, positions,
                                      window=cfg.window,
                                      kv_block=cfg.kv_block)
        new_cache = (build_cache(k, v, positions, make_cache_slots)
                     if make_cache_slots else None)
    else:
        new_cache = cache_update(cache, k, v, position_scalar)
        if torch.as_tensor(position_scalar).dim() >= 1 and s > 1:
            # a chunk attends over the PRE-update cache plus the chunk:
            # mid-chunk queries may need ring entries that the chunk's own
            # tail just evicted (cache.pos is per-row here)
            kv_pos = torch.cat([cache.pos, positions.to(torch.int32)], dim=1)
            k_cat = torch.cat([cache.k.to(dt), k], dim=1)
            v_cat = torch.cat([cache.v.to(dt), v], dim=1)
            out = blockwise_attention(q, k_cat, v_cat, positions, kv_pos,
                                      window=cfg.window,
                                      kv_block=cfg.kv_block)
        else:
            # one token attends over the post-update cache: the only entry
            # its write can evict sits exactly `window` back, masked anyway
            kv_pos = (new_cache.pos if new_cache.pos.dim() == 2 else
                      new_cache.pos[None, :].expand(b, -1))
            out = blockwise_attention(q, new_cache.k.to(dt),
                                      new_cache.v.to(dt), positions, kv_pos,
                                      window=cfg.window,
                                      kv_block=cfg.kv_block)
    out = out.reshape(b, s, h * hd) @ params["wo"].to(dt)
    return out, new_cache
