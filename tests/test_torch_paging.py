"""The port's block pool (``repro_torch.serve.paging``), its paged-cache
functions (``models.attention.paged_view`` / ``paged_writeback``) and the
engine's block-row functions against the JAX reference's, on the CPU.

``BlockPool``, ``PageTable`` (ring mode too), ``PrefixIndex`` and
``SwapStore`` are driven through the same fixed-seed operation sequences as
the reference's classes: every result, raised error (type and message),
table, free list, refcount and ``stats()`` is equal after every operation,
and the invariants hold. Fixed seeds, not fresh random draws: two of the
reference's property tests fail on some draws. The views and writebacks
are bitwise the reference's on the same numpy pools and rows, trash rows
included (every writer to a trash row writes the same empty-slot bytes,
so the duplicates agree whatever their order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import attention as RA
from repro.serve import engine as RE
from repro.serve import paging as RP
from repro_torch.models import attention as TA
from repro_torch.serve import engine as TE
from repro_torch.serve import paging as TP


def _same(call):
    """``call(module)`` on the reference's and the port's module: the
    same result, or the same error type and message."""
    out = []
    for mod in (RP, TP):
        try:
            out.append(("ok", call(mod)))
        except (ValueError, RuntimeError) as e:
            out.append((type(e).__name__, str(e)))
    (ka, a), (kb, b) = out
    assert ka == kb, out
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    else:
        assert a == b
    return a


def _state(pt):
    return (pt.table.copy(), list(pt.pool._free), pt.pool.allocated.copy(),
            pt.pool.refs.copy(), pt.stats())


def _assert_same_state(ref, got):
    (ta, fa, aa, ra, sa), (tb, fb, ab, rb, sb) = _state(ref), _state(got)
    np.testing.assert_array_equal(ta, tb)
    assert fa == fb and sa == sb
    np.testing.assert_array_equal(aa, ab)
    np.testing.assert_array_equal(ra, rb)


# (seed, num_blocks, block_size, num_slots, slot_positions, ring)
TABLES = [(0, 6, 4, 3, 14, False), (1, 10, 2, 4, 16, False),
          (2, 5, 4, 3, 16, True), (3, 3, 8, 2, 5, True),
          (4, 12, 3, 4, 20, False), (5, 7, 4, 3, 12, True)]


@pytest.mark.parametrize("case", TABLES, ids=lambda c: f"seed{c[0]}")
def test_page_table_matches_the_reference(case):
    """200 random operations (ensure, free_slot, map_shared, cow_block,
    write_blocks, swap_out / swap_in, rows, out-of-range ids) on both
    packages' tables: equal results, errors and state throughout."""
    seed, nb, bs, ns, sp, ring = case
    rng = np.random.default_rng(seed)
    pts = {RP: RP.PageTable(RP.BlockPool(nb, bs), ns, sp, ring=ring),
           TP: TP.PageTable(TP.BlockPool(nb, bs), ns, sp, ring=ring)}
    swapped = {}
    for _ in range(200):
        op = rng.integers(0, 8)
        slot = int(rng.integers(0, ns))
        if op == 0:
            pos = int(rng.integers(-1, sp + 4))
            _same(lambda m: pts[m].ensure(slot, pos))
        elif op == 1:
            _same(lambda m: sorted(pts[m].free_slot(slot)))
        elif op == 2:
            src = int(rng.integers(0, ns))
            n = int(rng.integers(0, pts[RP].blocks_per_slot + 2))
            blocks = [int(b) for b in pts[RP].table[src][:n]]
            _same(lambda m: pts[m].map_shared(slot, blocks))
        elif op == 3:
            lb = int(rng.integers(0, pts[RP].blocks_per_slot))
            _same(lambda m: pts[m].cow_block(slot, lb))
        elif op == 4:
            lo = int(rng.integers(0, 2 * sp))
            hi = lo + int(rng.integers(-1, sp + 2))
            _same(lambda m: pts[m].write_blocks(slot, lo, hi))
        elif op == 5:
            got = _same(lambda m: pts[m].swap_out(slot))
            if isinstance(got, tuple):
                swapped[slot] = int(np.sum(got[0] != pts[RP].trash))
        elif op == 6:
            n = swapped.pop(slot, int(rng.integers(0, 3)))
            _same(lambda m: pts[m].swap_in(slot, n))
        else:
            bad = int(rng.choice([-1, nb, nb + 3]))
            _same(lambda m: pts[m].pool.free(bad))
            _same(lambda m: pts[m].pool.ref(bad))
            _same(lambda m: pts[m].rows([slot]))
        _assert_same_state(pts[RP], pts[TP])
        pts[TP].check_invariants()
        n_pos = int(rng.integers(0, 40))
        _same(lambda m: pts[m].blocks_for(n_pos))


def test_constructor_and_guard_errors_match():
    """Bad sizes, double frees and refs of unallocated blocks raise the
    reference's errors; check_invariants catches the same corruption."""
    _same(lambda m: m.BlockPool(0, 4))
    _same(lambda m: m.BlockPool(4, 0))
    _same(lambda m: m.PrefixIndex(capacity=0))
    pools = {m: m.BlockPool(2, 4) for m in (RP, TP)}
    _same(lambda m: pools[m].alloc())
    _same(lambda m: pools[m].free(0))
    _same(lambda m: pools[m].free(0))
    _same(lambda m: pools[m].ref(1))
    pts = {m: m.PageTable(m.BlockPool(4, 4), 2, 16) for m in (RP, TP)}
    for m in (RP, TP):
        pts[m].ensure(1, 3)
        pts[m].table[1, 2] = 0          # the same block mapped twice
    _same(lambda m: pts[m].check_invariants())
    _same(lambda m: pts[m].swap_out(1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_matches_the_reference(seed):
    """Chained chunk digests, match (LRU refresh), publish, evict_lru with
    a keep set, holds and stats, over 120 random operations."""
    rng = np.random.default_rng(seed)
    idx = {m: m.PrefixIndex(capacity=int(rng.integers(2, 6)))
           for m in (RP, TP)}
    prompts = [rng.integers(0, 50, int(rng.integers(1, 40))).astype(np.int32)
               for _ in range(6)]
    for _ in range(120):
        op = rng.integers(0, 4)
        p = prompts[int(rng.integers(0, len(prompts)))]
        max_chunks = int(rng.integers(0, 10))
        keys = _same(lambda m: m.PrefixIndex.chunk_keys(p, 4, max_chunks))
        if op == 0:
            _same(lambda m: idx[m].match(keys))
        elif op == 1 and keys:
            k = keys[int(rng.integers(0, len(keys)))]
            blocks = {16: int(rng.integers(0, 8)), 8: int(rng.integers(0, 4))}
            _same(lambda m: idx[m].publish(k, blocks))
        elif op == 2:
            keep = set(keys[:int(rng.integers(0, len(keys) + 1))])
            _same(lambda m: idx[m].evict_lru(keep=keep))
        holds = [idx[m].holds({16: 8, 8: 4}) for m in (RP, TP)]
        for vl in (16, 8):
            np.testing.assert_array_equal(holds[0][vl], holds[1][vl])
        assert idx[RP].stats() == idx[TP].stats()
        assert len(idx[RP]) == len(idx[TP])


def _entry(mod, rng, periods=2, rows=8):
    """A SwapEntry of bf16-sized k/v, int32 pos and an fp32 dense leaf:
    numpy for the reference, host torch tensors for the port."""
    shapes = [((periods, rows, 1, 16), np.float16),
              ((periods, rows, 1, 16), np.float16),
              ((periods, rows), np.int32), ((periods, 1, 32), np.float32)]
    arrs = [rng.standard_normal(s).astype(t) for s, t in shapes]
    if mod is TP:
        arrs = [torch.from_numpy(a) for a in arrs]
    return mod.SwapEntry(blocks={16: rows // 4},
                         paged={"p0": tuple(arrs[:3])},
                         dense={"p1": {"s": arrs[3], "attn": None}})


@pytest.mark.parametrize("budget", [None, 3000, 1])
def test_swap_store_matches_the_reference(budget):
    """put / pop / get / can_hold / reject and the byte counters: equal
    results, errors and stats for the same entries (the port sums its
    tensors' bytes without the reference's JAX tree walk)."""
    rng = np.random.default_rng(4)
    stores = {m: m.SwapStore(max_bytes=budget) for m in (RP, TP)}
    for step in range(24):
        rid = int(rng.integers(0, 5))
        op = rng.integers(0, 3)
        if op == 0:
            seed = int(rng.integers(0, 1 << 30))
            rows = 4 * int(rng.integers(1, 4))
            ents = {m: _entry(m, np.random.default_rng(seed), rows=rows)
                    for m in (RP, TP)}
            assert ents[RP].nbytes == ents[TP].nbytes
            _same(lambda m: stores[m].put(rid, ents[m]))
        elif op == 1 and rid in stores[RP]:
            _same(lambda m: stores[m].pop(rid).nbytes)
        else:
            n = int(rng.integers(0, 4000))
            _same(lambda m: stores[m].can_hold(n))
            stores[RP].reject()
            stores[TP].reject()
        assert (rid in stores[RP]) == (rid in stores[TP])
        assert len(stores[RP]) == len(stores[TP])
        assert stores[RP].stats() == stores[TP].stats()
    st = stores[TP].stats()
    assert st["swap_bytes_in"] > 0 if budget != 1 else st["swap_bytes_out"] == 0
    assert st["swap_rejected"] > 0


# --------------------------------------------------------------------------
# device functions: paged views, writebacks, block rows
# --------------------------------------------------------------------------

def _pools(rng, nb, bs, periods=2, kvh=2, hd=8):
    """One flat pool as numpy (k, v bf16-representable fp32, pos int32),
    with trash rows holding junk (they must never be read unmasked)."""
    rows = (nb + 1) * bs
    k = rng.standard_normal((periods, rows, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((periods, rows, kvh, hd)).astype(np.float32)
    pos = rng.integers(-1, 50, (periods, rows)).astype(np.int32)
    return k, v, pos


def _jflat(k, v, pos):
    return RA.KVCache(k=jnp.asarray(k, jnp.bfloat16),
                      v=jnp.asarray(v, jnp.bfloat16), pos=jnp.asarray(pos))


def _tflat(k, v, pos):
    return TA.KVCache(torch.from_numpy(k).to(torch.bfloat16),
                      torch.from_numpy(v).to(torch.bfloat16),
                      torch.from_numpy(pos.copy()))


def _np(c):
    """A KVCache of JAX arrays or torch tensors as numpy (bf16 widened to
    fp32, which is exact)."""
    out = []
    for x in c:
        if isinstance(x, torch.Tensor):
            out.append((x.float() if x.dtype == torch.bfloat16 else x)
                       .numpy())
        else:
            out.append(np.asarray(x.astype(jnp.float32)
                                  if x.dtype == jnp.bfloat16 else x))
    return out


# (seed, num_blocks, block_size, num_slots, view_len, ring)
VIEWS = [(0, 6, 4, 3, 14, False), (1, 9, 2, 4, 12, True),
         (2, 4, 8, 2, 20, False)]


@pytest.mark.parametrize("case", VIEWS, ids=lambda c: f"seed{c[0]}")
def test_paged_view_and_writeback_are_the_reference_bitwise(case):
    """A table with mapped, partial and unmapped slots: the views equal
    the reference's bit for bit (trash positions read k=v=0, pos=-1);
    writing back a view changed at mapped positions leaves both pools
    equal bit for bit, trash rows included."""
    seed, nb, bs, ns, vl, ring = case
    rng = np.random.default_rng(seed)
    pt = RP.PageTable(RP.BlockPool(nb, bs), ns, vl, ring=ring)
    for s in range(ns - 1):            # the last slot stays unmapped
        pt.ensure(s, int(rng.integers(0, vl + 3)) if ring
                  else int(rng.integers(0, vl)))
    rows = pt.rows()
    k, v, pos = _pools(rng, nb, bs)
    live = nb * bs
    jv = RA.paged_view(_jflat(k, v, pos), jnp.asarray(rows), live)
    tv = TA.paged_view(_tflat(k, v, pos), torch.from_numpy(
        rows.astype(np.int64)), live)
    for a, b in zip(_np(jv), _np(tv)):
        np.testing.assert_array_equal(a, b)
    assert (_np(tv)[2][:, rows >= live] == -1).all()
    assert (_np(tv)[0][:, rows >= live] == 0).all()

    # change the view at mapped positions only (distinct rows, one writer)
    mapped = rows < live
    dk = rng.standard_normal(jv.k.shape).astype(np.float32) \
        * mapped[None, :, :, None, None]
    dp = rng.integers(0, 9, jv.pos.shape).astype(np.int32) * mapped[None]
    jview = RA.KVCache(k=jv.k + jnp.asarray(dk, jnp.bfloat16), v=jv.v,
                       pos=jv.pos + jnp.asarray(dp))
    tview = TA.KVCache(tv.k + torch.from_numpy(dk).to(torch.bfloat16), tv.v,
                       tv.pos + torch.from_numpy(dp))
    jout = RA.paged_writeback(_jflat(k, v, pos), jview, jnp.asarray(rows))
    tflat = _tflat(k, v, pos)
    tout = TA.paged_writeback(tflat, tview, torch.from_numpy(
        rows.astype(np.int64)))
    assert tout is tflat                # in place
    for a, b in zip(_np(jout), _np(tout)):
        np.testing.assert_array_equal(a, b)


def test_block_rows_round_trip_and_match_the_reference():
    """reset_block_rows, gather_block_rows, upload_block_rows and
    copy_block_rows equal the reference's bit for bit on two pools; a
    gather then an upload into other blocks moves the bytes unchanged
    (the swap path), and a copy duplicates blocks (the CoW path)."""
    rng = np.random.default_rng(9)
    nb, bs = 6, 4
    raw = {"p0": _pools(rng, nb, bs), "p1": _pools(rng, nb, bs)}
    jp = {key: _jflat(*x) for key, x in raw.items()}
    tp = {key: _tflat(*x) for key, x in raw.items()}

    def same():
        for key in raw:
            for a, b in zip(_np(jp[key]), _np(tp[key])):
                np.testing.assert_array_equal(a, b)

    def both(blocks):
        r = RP.PageTable.block_rows(blocks, bs)
        return jnp.asarray(r), torch.from_numpy(r.astype(np.int64))

    jr, tr = both([4, 1])
    jp = RE.reset_block_rows(jp, jr)
    TE.reset_block_rows(tp, tr)
    same()
    assert (tp["p0"].pos[:, tr] == -1).all() and (tp["p1"].k[:, tr] == 0).all()

    jsrc, tsrc = both([0, 2])
    jdst, tdst = both([3, 5])
    jp = RE.copy_block_rows(jp, jsrc, jdst)
    TE.copy_block_rows(tp, tsrc, tdst)
    same()
    for x in tp["p1"]:
        assert torch.equal(x[:, tdst], x[:, tsrc])

    jsaved = RE.gather_block_rows(jp, jsrc)
    tsaved = TE.gather_block_rows(tp, tsrc)
    for key in raw:
        for a, b in zip(_np(jsaved[key]), _np(tsaved[key])):
            np.testing.assert_array_equal(a, b)
    host = {key: TA.KVCache(*(x.cpu().clone() for x in c))
            for key, c in tsaved.items()}
    jnew, tnew = both([1, 4])
    jp = RE.upload_block_rows(jp, jsaved, jnew)
    TE.upload_block_rows(tp, host, tnew)
    same()
    for key in raw:
        for x, y in zip(tp[key], host[key]):
            assert torch.equal(x[:, tnew], y)


def test_copy_on_write_through_the_paged_slot_manager():
    """Prefix sharing at the SlotManager level, the same operations on
    the port's and the reference's paged pools (reduced gemma-2b, blocks
    of 4 over 16 positions): a donor's prefilled prompt is published,
    a second slot maps its first three blocks read-shared, then writes
    into two of them. The write copies both blocks first (two CoW
    copies), the writer's view keeps the donor's bytes where it did not
    write, the donor's view never changes, and every view and stat
    equals the reference's."""
    import dataclasses
    import jax
    import torch as _torch
    from repro import configs as RC
    from repro.serve import slots as RSL
    from repro_torch import configs as TC
    from repro_torch.serve import slots as TSL

    rcfg = dataclasses.replace(RC.reduced_config("gemma-2b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.reduced_config("gemma-2b"),
                               dtype=_torch.float32)
    kw = dict(paged=True, block_size=4, prefix_sharing=True)
    pools = {RSL: RSL.SlotManager(rcfg, 2, 16, **kw),
             TSL: TSL.SlotManager(tcfg, 2, 16, device="cpu", **kw)}
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 100, 13).astype(np.int32)

    def view(mod, slot):
        c = pools[mod].gather([slot])["p0"]["attn"]
        return _np(c) if mod is TSL else _np(jax.device_get(c))

    def write(slot, lo, hi, seed):
        """Random k, v, pos over positions [lo, hi] of ``slot``."""
        r = np.random.default_rng(seed)
        shape = view(RSL, slot)[0].shape
        k = r.standard_normal(shape[:2] + (hi - lo + 1,) + shape[3:])
        pos = r.integers(0, 99, shape[:2] + (hi - lo + 1,))
        for mod in (RSL, TSL):
            sub = pools[mod].gather([slot])
            c = sub["p0"]["attn"]
            if mod is TSL:
                kk, vv, pp = c.k.clone(), c.v.clone(), c.pos.clone()
                kk[:, :, lo:hi + 1] = _torch.from_numpy(k).to(kk.dtype)
                vv[:, :, lo:hi + 1] = _torch.from_numpy(-k).to(vv.dtype)
                pp[:, :, lo:hi + 1] = _torch.from_numpy(pos).to(pp.dtype)
                sub["p0"] = {"attn": TA.KVCache(kk, vv, pp)}
            else:
                sub["p0"] = {"attn": RA.KVCache(
                    k=c.k.at[:, :, lo:hi + 1].set(k.astype(c.k.dtype)),
                    v=c.v.at[:, :, lo:hi + 1].set((-k).astype(c.v.dtype)),
                    pos=c.pos.at[:, :, lo:hi + 1].set(pos))}
            pools[mod].scatter(sub, [slot])

    def same_views(*slots):
        for slot in slots:
            for a, b in zip(view(RSL, slot), view(TSL, slot)):
                np.testing.assert_array_equal(a, b)

    donor = [pools[m].alloc(0, prompt_len=13, prompt=prompt, span=16)
             for m in (RSL, TSL)]
    assert donor[0] == donor[1]
    donor = donor[0]
    write(donor, 0, 15, seed=1)
    before = view(TSL, donor)
    assert [pools[m].register_prefix(donor, prompt, 16, 12)
            for m in (RSL, TSL)] == [3, 3]
    sharer = [pools[m].alloc(1, prompt_len=13, prompt=prompt, span=16)
              for m in (RSL, TSL)]
    assert sharer[0] == sharer[1]
    sharer = sharer[0]
    assert [pools[m].prefill_start(sharer) for m in (RSL, TSL)] == [12, 12]
    same_views(donor, sharer)
    assert [pools[m].ensure(sharer, 9, write_from=5)
            for m in (RSL, TSL)] == [True, True]
    st = pools[TSL].stats()
    assert st["cow_copies"] == pools[RSL].stats()["cow_copies"] == 2
    got = view(TSL, sharer)
    for a, b in zip(got, before):       # the copies hold the donor's bytes
        np.testing.assert_array_equal(a[:, :, :12], b[:, :, :12])
    write(sharer, 5, 9, seed=2)
    same_views(donor, sharer)
    for a, b in zip(view(TSL, donor), before):
        np.testing.assert_array_equal(a, b)
    for k in ("blocks_used", "shared_blocks", "cow_copies",
              "prefix_shared_chunks", "prefix_entries", "prefix_lookups",
              "prefix_hit_chunks", "prefix_published"):
        assert pools[TSL].stats()[k] == pools[RSL].stats()[k], k
