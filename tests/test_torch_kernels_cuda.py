"""CUDA arms of the port's kernel tests: each hand-written kernel against
its plain PyTorch version on the card. Imports no JAX, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

Without a card every test here skips with its reason.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import align as TA
from repro_torch.core import wavefront as TWF
from repro_torch.kernels import chain_scan as KC
from repro_torch.kernels import dtw_wavefront as KT
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import ops
from repro_torch.kernels import radix_rank as KR
from repro_torch.kernels import ssm_scan as KS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _masked_scores(n, t, seed):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(n, t)).astype(np.float32)
    scores[rng.random((n, t)) < 0.5] = -1e18
    for i in range(min(n, t)):
        scores[i, i:] = -1e18
    return scores


@pytest.mark.parametrize("n,t", [(1000, 64), (777, 128), (300, 17)])
def test_chain_scan_kernel_exact(cuda, n, t):
    scores = torch.as_tensor(_masked_scores(n, t, n))
    w = torch.full((n,), 15.0)
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    before = KC.launches
    f, off = KC.chain_scan(scores.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert KC.launches == before + 1
    assert torch.equal(off.cpu(), off_ref)
    assert torch.equal(f.cpu(), f_ref)


def test_chain_scan_kernel_batched_and_ties(cuda):
    scores = torch.as_tensor(np.stack([_masked_scores(200, 64, s)
                                       for s in range(3)]))
    scores[1] = 1.0                                    # all candidates tie
    w = torch.full((3, 200), 0.5)
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    f, off = KC.chain_scan(scores.to(cuda), w.to(cuda))
    assert torch.equal(off.cpu(), off_ref) and torch.equal(f.cpu(), f_ref)


def test_chain_scan_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="band"):
        KC.chain_scan(torch.zeros(10, 129, device=cuda),
                      torch.zeros(10, device=cuda))
    with pytest.raises(TypeError):
        KC.chain_scan(torch.zeros(10, 8, device=cuda, dtype=torch.float64),
                      torch.zeros(10, device=cuda))


def _tie_scores(lead, n, t, seed):
    """Integer-valued band scores (candidates tie), half masked to NEG, the
    band reaching before row 0 unmasked (the NEG-seeded candidates tie
    there); w of 15, 1 or 2 with a tenth NEG (invalid anchors)."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(-3, 4, lead + (n, t)).astype(np.float32)
    scores[rng.random(lead + (n, t)) < 0.5] = -1e18
    w = rng.choice(np.array([15.0, 1.0, 2.0], np.float32), lead + (n,))
    w[rng.random(lead + (n,)) < 0.1] = -1e18
    return torch.as_tensor(scores), torch.as_tensor(w)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4096])
@pytest.mark.parametrize("t", [1, 33, 128])
def test_chain_scan_kernel_exact_at_the_edges(cuda, t, n):
    """The forwarding kernel bit for bit: one row, part of a round, a round,
    a round and one, and many; one slot (T=1), a second slot of one row
    (T=33), four slots (T=128); ties; NEG weights; and a problem whose w is
    all NEG, where the NEG-seeded candidates decide off."""
    scores, w = _tie_scores((2,), n, t, seed=n + t)
    w[1] = -1e18
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    before = KC.launches
    f, off = KC.chain_scan(scores.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert KC.launches == before + 1
    assert torch.equal(off.cpu(), off_ref)
    assert torch.equal(f.cpu(), f_ref)


def test_chain_scan_kernel_stack_of_13(cuda):
    """A (13, N, 64) stack, as the service's anchor buckets launch it."""
    scores, w = _tie_scores((13,), 777, 64, seed=13)
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    f, off = KC.chain_scan(scores.to(cuda), w.to(cuda))
    assert torch.equal(off.cpu(), off_ref) and torch.equal(f.cpu(), f_ref)


def test_chain_scan_kernel_reads_unaligned_rows(cuda):
    """Scores that start 4 bytes past a 16-byte boundary take the 4-byte
    staging path."""
    scores, w = _tie_scores((), 300, 64, seed=5)
    buf = torch.empty(300 * 64 + 1, device=cuda)
    view = buf[1:].view(300, 64)
    view.copy_(scores.to(cuda))
    assert view.data_ptr() % 16 != 0
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    f, off = KC.chain_scan(view, w.to(cuda))
    assert torch.equal(off.cpu(), off_ref) and torch.equal(f.cpu(), f_ref)


def _sw_inputs(lead, tr, tc, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 30, lead + (tc,)),
                            dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 30, lead + (tr,)),
                            dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 30, lead), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 4, lead + (tr,)),
                            dtype=torch.int32),
            torch.as_tensor(rng.integers(0, 4, lead + (tc,)),
                            dtype=torch.int32))


@pytest.mark.parametrize("lead", [(), (5,)])
@pytest.mark.parametrize("tr,tc", [(64, 64), (128, 128), (32, 16)])
def test_sw_tile_kernel_exact(cuda, lead, tr, tc):
    ins = _sw_inputs(lead, tr, tc, tr + tc + len(lead))
    want = KT.dp_tile_plain(*ins, kind="sw")
    got = KT.dp_tile(*(x.to(cuda) for x in ins), kind="sw")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("tr,tc", [(64, 64), (32, 16)])
def test_dtw_tile_kernel_close(cuda, tr, tc):
    g = torch.Generator().manual_seed(tr * tc)
    ins = (torch.randn(tc, generator=g), torch.randn(tr, generator=g),
           torch.randn((), generator=g), torch.randn(tr, generator=g),
           torch.randn(tc, generator=g))
    want = KT.dp_tile_plain(*ins, kind="dtw")
    got = KT.dp_tile(*(x.to(cuda) for x in ins), kind="dtw")
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w, rtol=1e-5, atol=1e-4)


def test_sw_tiled_on_the_card_exact(cuda):
    rng = np.random.default_rng(1)
    b = rng.integers(0, 4, 300).astype(np.int32)
    a = b[20:250].copy()
    a[rng.random(230) < 0.1] = 3
    want = TA.sw_ref(torch.as_tensor(a), torch.as_tensor(b))
    before, wf_before = KT.launches, KT.wavefront_launches
    mat, best = ops.sw_tiled(torch.as_tensor(a, device=cuda),
                             torch.as_tensor(b, device=cuda),
                             tile_r=64, tile_c=64)
    # the 4 x 5 tiles in one dp_wavefront launch, no per-tile launch
    assert (KT.launches - before, KT.wavefront_launches - wf_before) == (0, 1)
    assert torch.equal(mat.cpu(), want)
    assert float(best) == float(want.max())


def _wf_inputs(kind, lead, n, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "sw":
        a = torch.as_tensor(rng.integers(0, 4, lead + (n,)), dtype=torch.int32)
        b = torch.as_tensor(rng.integers(0, 4, lead + (m,)), dtype=torch.int32)
        bnd = lambda shape: torch.as_tensor(  # noqa: E731
            rng.integers(0, 30, shape), dtype=torch.float32)
    else:
        a = torch.as_tensor(np.cumsum(rng.normal(size=lead + (n,)), -1),
                            dtype=torch.float32)
        b = torch.as_tensor(np.cumsum(rng.normal(size=lead + (m,)), -1),
                            dtype=torch.float32)
        bnd = lambda shape: torch.as_tensor(  # noqa: E731
            rng.normal(size=shape), dtype=torch.float32)
    return a, b, bnd(lead + (m,)), bnd(lead + (n,)), bnd(lead)


def _wavefront_exact(cuda, kind, lead, n, m, tile):
    ins = _wf_inputs(kind, lead, n, m, n + m + tile + len(lead))
    want = KT.dp_wavefront_plain(*ins, kind=kind, tile_r=tile, tile_c=tile)
    before, t_before = KT.wavefront_launches, KT.launches
    got = KT.dp_wavefront(*(x.to(cuda) for x in ins), kind=kind,
                          tile_r=tile, tile_c=tile)
    torch.cuda.synchronize()
    assert (KT.wavefront_launches - before, KT.launches - t_before) == (1, 0)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)
    return KT.last_grid


@pytest.mark.parametrize("kind", ["sw", "dtw"])
@pytest.mark.parametrize("lead", [(), (5,)])
@pytest.mark.parametrize("tile,n,m", [(64, 192, 256), (128, 256, 384)])
def test_dp_wavefront_exact(cuda, kind, lead, tile, n, m):
    _wavefront_exact(cuda, kind, lead, n, m, tile)


@pytest.mark.parametrize("kind", ["sw", "dtw"])
def test_dp_wavefront_tile_8_long(cuda, kind):
    _wavefront_exact(cuda, kind, (), 16, 10_000, 8)


@pytest.mark.parametrize("kind", ["sw", "dtw"])
def test_dp_wavefront_strips_outnumber_ctas(cuda, kind):
    """5 x 128 strips of 128 columns, more than the CTAs the card holds at
    once at that tile (its shared memory fits three per SM): CTAs walk
    several strips in turn, waiting on the counters of other CTAs."""
    grid = _wavefront_exact(cuda, kind, (5,), 128, 16_384, 128)
    assert grid < 5 * 16_384 // 128


def test_dp_wavefront_more_strips_than_resident_ctas(cuda):
    """n = 128, m = 131,072 in 64-column strips: 2,048 strips, more than
    the card holds CTAs at once. The plain tile loop would take minutes
    here (4,096 tiles), so the matrix is held to the row-scan oracle
    sw_ref, exact in fp32 for integer scores."""
    rng = np.random.default_rng(7)
    b = rng.integers(0, 4, 131_072).astype(np.int32)
    a = b[1000:1128].copy()
    a[rng.random(128) < 0.1] = 3
    at, bt = torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda)
    z = functools.partial(torch.zeros, dtype=torch.float32, device=cuda)
    mat, bottom, right, corner = KT.dp_wavefront(
        at, bt, z(131_072), z(128), z(()), kind="sw", tile_r=64, tile_c=64)
    torch.cuda.synchronize()
    assert KT.last_grid < 131_072 // 64
    want = TA.sw_ref(at, bt)
    assert torch.equal(mat, want)
    assert torch.equal(bottom, want[-1]) and torch.equal(right, want[:, -1])
    assert float(corner) == float(want[-1, -1])
    assert float(mat.max()) >= 100            # the planted match is found


def test_dtw_tiled_padding_on_the_card(cuda):
    """DTW with the 1e18 padding of dtw_tiled, kernel against plain."""
    from repro_torch.core import dtw as TD
    rng = np.random.default_rng(3)
    s = torch.as_tensor(np.cumsum(rng.normal(size=100)), dtype=torch.float32)
    r = torch.as_tensor(np.cumsum(rng.normal(size=130)), dtype=torch.float32)
    for tile in (64, 32):
        want, want_d = TD.dtw_tiled(s, r, tile, tile)
        before = KT.wavefront_launches
        got, d = ops.dtw_tiled(s.to(cuda), r.to(cuda), tile, tile)
        assert KT.wavefront_launches == before + 1
        assert torch.equal(got.cpu(), want) and float(d) == float(want_d)


def test_dp_wavefront_rejects_what_it_does_not_take(cuda):
    z = functools.partial(torch.zeros, device=cuda)
    i32 = torch.int32
    with pytest.raises(ValueError, match="multiples"):
        KT.dp_wavefront(z(30, dtype=i32), z(16, dtype=i32), z(16), z(30),
                        z(()), kind="sw", tile_r=8, tile_c=8)
    with pytest.raises(TypeError):
        KT.dp_wavefront(z(16), z(16), z(16), z(16), z(()), kind="sw",
                        tile_r=8, tile_c=8)
    with pytest.raises(ValueError, match="tile"):
        KT.dp_wavefront(z(256), z(256), z(256), z(256), z(()), kind="dtw",
                        tile_r=256, tile_c=256)


def test_mapper_aligns_in_one_launch_per_read(cuda):
    from repro_torch.apps.read_mapper import MapperConfig, ReadMapper
    from repro_torch.data import genomics
    ref = genomics.make_reference(20_000, seed=1)
    prof = genomics.ReadProfile("TEST", 1500, 100, 0.95)
    reads = genomics.sample_reads(ref, prof, 2, seed=2)
    on = ReadMapper(ref, MapperConfig(), device=cuda)
    # the baseline schedule without kernels chains sequentially, as the
    # kernel does, so every field is equal
    off = ReadMapper(ref, MapperConfig(mode="baseline", use_kernels=False),
                     device=cuda, index=on.index)
    for read, truth in reads:
        before, t_before = KT.wavefront_launches, KT.launches
        res = on.map_read(read)
        assert (KT.wavefront_launches - before, KT.launches - t_before) == (
            1, 0)
        assert abs(res.pos - truth) <= 200
        assert res == off.map_read(read)


def test_wavefront_batched_on_the_card(cuda):
    a = torch.randint(0, 4, (3, 64), dtype=torch.int32)
    b = torch.randint(0, 4, (3, 128), dtype=torch.int32)
    z = torch.zeros
    fn = ops.make_sw_tile_fn()
    want = TWF.run_wavefront_batched(fn, a, b, z(3, 128), z(3, 64), z(3),
                                     32, 32)
    got = TWF.run_wavefront_batched(fn, a.to(cuda), b.to(cuda),
                                    z(3, 128, device=cuda),
                                    z(3, 64, device=cuda), z(3, device=cuda),
                                    32, 32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("clen", [1, 255, 1024, 16384])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_radix_rank_kernel_exact(cuda, clen, n_chunks):
    rng = np.random.default_rng(clen + n_chunks)
    keys = rng.integers(0, 2**32, (n_chunks, clen), dtype=np.uint32)
    keys[:, ::3] = keys[:, :1]
    kt = torch.as_tensor(keys.astype(np.int64))
    for shift in (0, 8, 16, 24):
        want_r, want_h = KR.radix_rank_plain(kt, shift)
        before = KR.launches
        ranks, hists = KR.radix_rank(kt.to(cuda), shift)
        torch.cuda.synchronize()
        assert KR.launches == before + 1
        assert torch.equal(ranks.cpu(), want_r)
        assert torch.equal(hists.cpu(), want_h)


def test_radix_sort_chunks_on_the_card_is_a_stable_sort(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    keys = torch.randint(0, 2**32, (4, 16384), generator=g, device=cuda,
                         dtype=torch.int64)
    keys[:, ::5] = keys[:, :1].clone()
    before = (KR.launches, KR.hist_launches, KR.pass_launches)
    sk, sv = ops.radix_sort_chunks(keys)
    # one histogram launch, then one pass launch per byte; no rank launch
    assert (KR.launches, KR.hist_launches, KR.pass_launches) == (
        before[0], before[1] + 1, before[2] + 4)
    want_k, want_i = torch.sort(keys, dim=1, stable=True)
    assert torch.equal(sk, want_k)
    assert torch.equal(sv.to(torch.int64), want_i)


def _radix_keys(n_chunks, clen, draw, seed):
    """uint32 keys as int64: every third key equal to its chunk's first, or
    every key of a chunk equal (one bucket for every digit)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (n_chunks, clen), dtype=np.uint32)
    if draw == "repeated":
        keys[:, ::3] = keys[:, :1]
    else:
        keys[:] = keys[:, :1]
    return torch.as_tensor(keys.astype(np.int64))


_EDGE_LENS = (1, 255, 1023, 1024, 1025, 2047, 2048, 2049, 3 * 2048 + 7,
              16384)


@pytest.mark.parametrize("draw", ["repeated", "one_bucket"])
@pytest.mark.parametrize("tile", KR.TILES)
def test_radix_rank_kernel_exact_about_the_tile(cuda, tile, draw):
    """T - 1, T, T + 1 (and more) keys a chunk at each tile size T: ragged
    last tiles, chunks shorter than a tile, look-back across tiles."""
    for clen in (1, tile - 1, tile, tile + 1, 3 * tile + 7):
        for n_chunks in (1, 4):
            kt = _radix_keys(n_chunks, clen, draw, clen)
            for shift in (0, 8, 16, 24):
                want_r, want_h = KR.radix_rank_plain(kt, shift)
                before = KR.launches
                ranks, hists = KR.radix_rank(kt.to(cuda), shift, tile=tile)
                torch.cuda.synchronize()
                assert KR.launches == before + 1
                assert KR.last_grid == n_chunks * -(-clen // tile)
                assert torch.equal(ranks.cpu(), want_r)
                assert torch.equal(hists.cpu(), want_h)


@pytest.mark.parametrize("draw", ["repeated", "one_bucket"])
@pytest.mark.parametrize("clen", _EDGE_LENS)
def test_radix_hist_and_pass_kernels_exact(cuda, clen, draw):
    """The histogram and every pass (values absent, int32, float64) against
    their plain versions at both tile sizes, 1 and 4 chunks."""
    for n_chunks in (1, 4):
        kt = _radix_keys(n_chunks, clen, draw, clen + n_chunks)
        hist = KR.radix_hist_plain(kt)
        rng = np.random.default_rng(clen)
        vals = (None,
                torch.as_tensor(rng.integers(-9, 9, kt.shape, np.int32)),
                torch.as_tensor(rng.normal(size=kt.shape)))
        keys, starts = kt.to(cuda), hist[1].to(cuda)
        for tile in KR.TILES:
            before = KR.hist_launches
            got = KR.radix_hist(keys, tile=tile)
            assert KR.hist_launches == before + 1
            assert all(torch.equal(x.cpu(), y) for x, y in zip(got, hist))
            for p in range(4):
                for v in vals:
                    want = KR.radix_pass_plain(kt, v, hist[1], p)
                    before = KR.pass_launches
                    got = KR.radix_pass(keys, None if v is None else
                                        v.to(cuda), starts, p, tile=tile)
                    torch.cuda.synchronize()
                    assert KR.pass_launches == before + 1
                    assert torch.equal(got[0].cpu(), want[0])
                    assert torch.equal(got[1].cpu(), want[1])


def test_radix_sort_chunks_key_bits_and_values_on_the_card(cuda):
    kt = _radix_keys(3, 5000, "repeated", 1)
    vals = torch.arange(15000, dtype=torch.float32).reshape(3, 5000)
    for key_bits in (8, 12, 32):
        want = KR.radix_sort_chunks_plain(kt, vals, key_bits)
        before = KR.pass_launches
        got = ops.radix_sort_chunks(kt.to(cuda), vals.to(cuda), key_bits)
        assert KR.pass_launches == before + -(-key_bits // 8)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_radix_scratch_is_clear_after_each_launch(cuda):
    """The ticket, the histogram accumulators and their counters are back
    at zero after every launch (the next launch starts from them), and a
    run of launches of other shapes leaves the results unchanged."""
    keys = _radix_keys(4, 3000, "repeated", 2).to(cuda)
    first = ops.radix_sort_chunks(keys)
    for shape in ((64, 700), (1, 1), (2, 40000)):
        ops.radix_sort_chunks(_radix_keys(*shape, "one_bucket", 3).to(cuda))
        KR.radix_rank(_radix_keys(*shape, "repeated", 4).to(cuda), 16)
    again = ops.radix_sort_chunks(keys)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    stream = torch.cuda.current_stream(cuda).cuda_stream
    scratch = KR._SCRATCH[(keys.device.index, stream)]
    torch.cuda.synchronize()
    assert int(scratch.ticket.abs().sum()) == 0
    assert int(scratch.acc.abs().sum()) == 0
    assert int(scratch.done.abs().sum()) == 0


def test_radix_rank_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        KR.radix_rank(torch.zeros((2, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        KR.radix_rank(torch.zeros(8, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        KR.radix_rank(torch.zeros((8, 2), dtype=torch.int64,
                                  device=cuda).T)
    with pytest.raises(ValueError, match="tile"):
        KR.radix_rank(torch.zeros((2, 8), dtype=torch.int64, device=cuda),
                      tile=512)
    keys = torch.zeros((2, 8), dtype=torch.int64, device=cuda)
    _, starts = KR.radix_hist(keys)
    with pytest.raises(TypeError):
        KR.radix_pass(keys, torch.zeros((2, 8), dtype=torch.int16,
                                        device=cuda), starts, 0)
    with pytest.raises(ValueError, match="starts"):
        KR.radix_pass(keys, None, starts.long(), 0)
    with pytest.raises(ValueError, match="pass"):
        KR.radix_pass(keys, None, starts, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.radix_sort_chunks(keys, torch.zeros((8, 2), dtype=torch.int32,
                                                device=cuda).T)


def test_chain_stack_is_one_launch(cuda):
    from repro_torch.data import genomics
    sets = [genomics.anchor_set(nv, seed=s, noise=30)
            for s, nv in ((0, 400), (1, 250), (2, 90))]
    n = max(len(q) for q, _ in sets)
    q = torch.as_tensor(np.stack([np.pad(x, (0, n - len(x)))
                                  for x, _ in sets]))
    r = torch.as_tensor(np.stack([np.pad(y, (0, n - len(y)),
                                         constant_values=2**30)
                                  for _, y in sets]))
    v = torch.as_tensor(np.stack([np.arange(n) < len(x) for x, _ in sets]))
    want_f, want_p = ops.chain_anchors(q, r, T=64, anchor_valid=v)
    before = KC.launches
    f, p = ops.chain_anchors(q.to(cuda), r.to(cuda), T=64,
                             anchor_valid=v.to(cuda))
    torch.cuda.synchronize()
    assert KC.launches == before + 1
    assert torch.equal(p.cpu(), want_p)
    torch.testing.assert_close(f.cpu(), want_f, rtol=1e-5, atol=1e-4)


def test_service_on_the_card_batches_tiles(cuda):
    from repro_torch.runtime import KernelService, Request, ServiceConfig
    rng = np.random.default_rng(2)
    reqs = [Request("dtw", {"s": rng.normal(size=n).astype(np.float32),
                            "r": rng.normal(size=m).astype(np.float32)})
            for n, m in ((100, 120), (128, 90), (70, 128))]
    reqs += [Request("chain", {
        "q": np.sort(rng.integers(0, 400, n)).astype(np.int32),
        "r": np.sort(rng.integers(0, 5000, n)).astype(np.int32)})
        for n in (30, 100, 200)]
    cfg = ServiceConfig(seq_bucket=64, dtw_tile=32, anchor_bucket=256)
    want = KernelService(cfg, device="cpu").submit(reqs)
    t0, w0, c0 = KT.launches, KT.wavefront_launches, KC.launches
    got = KernelService(cfg, device="cuda").submit(reqs)
    # one dtw bucket (128 x 128, batch 3): its 4 x 4 tiles in one
    # dp_wavefront launch, no dp_tile launch; one chain bucket (256
    # anchors): one chain_scan launch
    assert (KT.launches - t0, KT.wavefront_launches - w0,
            KC.launches - c0) == (0, 1, 1)
    for w, g in zip(want, got):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-4)


def _wkv_inputs(b, t, dk, dv, seed, with_state):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn((b, t, dk), generator=g)
    w = torch.sigmoid(torch.randn((b, t, dk), generator=g) + 2.0)
    k = torch.randn((b, t, dk), generator=g)
    v = torch.randn((b, t, dv), generator=g)
    u = 0.5 * torch.randn((dk,), generator=g)
    s0 = torch.randn((b, dk, dv), generator=g) if with_state else None
    return r, w, k, v, u, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,t,dk,dv", [(128, 2048, 64, 64), (1, 1000, 16, 16),
                                       (3, 96, 8, 24)])
def test_ssm_scan_kernel_close(cuda, b, t, dk, dv, with_state):
    ins = _wkv_inputs(b, t, dk, dv, b + t, with_state)
    dev_ins = [None if x is None else x.to(cuda) for x in ins]
    want_y, want_s = KS.ssm_scan_plain(*dev_ins)
    before = KS.launches
    y, s_fin = KS.ssm_scan(*dev_ins)
    torch.cuda.synchronize()
    assert KS.launches == before + 1
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_fin, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [1, 33, 2048])
@pytest.mark.parametrize("dk", [1, 8, 64])
@pytest.mark.parametrize("dv", [1, 24, 64, 128])
def test_ssm_scan_kernel_edges(cuda, dv, dk, t):
    """B = 1 from a random state: one column to eight blocks of 16, one to
    64 state rows, one step to many chunks; dk = 1 and dv = 1 take the
    4-byte staging path."""
    ins = _wkv_inputs(1, t, dk, dv, dv * dk + t, True)
    dev_ins = [x.to(cuda) for x in ins]
    want_y, want_s = KS.ssm_scan_plain(*dev_ins)
    y, s_fin = KS.ssm_scan(*dev_ins)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_fin, want_s, rtol=1e-4, atol=1e-4)


def test_ssm_scan_kernel_reads_unaligned_rows(cuda):
    """Inputs that start 4 bytes past a 16-byte boundary take the 4-byte
    staging path at dk = dv = 64."""
    ins = _wkv_inputs(2, 40, 64, 64, 3, True)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x.to(cuda))
        return view

    r, w, k, v = (shifted(x) for x in ins[:4])
    assert r.data_ptr() % 16 != 0
    u, s0 = ins[4].to(cuda), ins[5].to(cuda)
    want_y, want_s = KS.ssm_scan_plain(r, w, k, v, u, s0)
    y, s_fin = KS.ssm_scan(r, w, k, v, u, s0)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_fin, want_s, rtol=1e-4, atol=1e-4)


def test_ssm_scan_ops_pads_t_on_the_card(cuda):
    r, w, k, v, u, _ = _wkv_inputs(2, 50, 16, 16, 0, False)
    want = ops.ssm_scan(r, w, k, v, u, chunk=16)
    got = ops.ssm_scan(r.to(cuda), w.to(cuda), k.to(cuda), v.to(cuda),
                       u.to(cuda), chunk=16)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_ssm_scan_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.zeros
    with pytest.raises(ValueError, match="dk"):
        KS.ssm_scan(z(1, 8, 65, device=cuda), z(1, 8, 65, device=cuda),
                    z(1, 8, 65, device=cuda), z(1, 8, 64, device=cuda))
    with pytest.raises(ValueError, match="dv"):
        KS.ssm_scan(z(1, 8, 64, device=cuda), z(1, 8, 64, device=cuda),
                    z(1, 8, 64, device=cuda), z(1, 8, 129, device=cuda))
    with pytest.raises(ValueError, match="on cpu"):
        KS.ssm_scan(z(1, 8, 16, device=cuda), z(1, 8, 16),
                    z(1, 8, 16, device=cuda), z(1, 8, 16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        KS.ssm_scan(z(1, 16, 8, device=cuda).transpose(1, 2),
                    z(1, 8, 16, device=cuda), z(1, 8, 16, device=cuda),
                    z(1, 8, 16, device=cuda))


def test_rwkv_prefill_is_one_launch_per_layer(cuda):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(configs.reduced_config("rwkv6-1.6b"),
                              dtype=torch.float32)
    params = TT.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    before = KS.launches
    on, _, c_on = TT.apply_model(params, cfg, tokens=toks[:, :32],
                                 mode="prefill")
    assert KS.launches == before + cfg.num_layers
    off, _, c_off = TT.apply_model(params, cfg, tokens=toks[:, :32],
                                   mode="prefill", use_kernels=False)
    assert KS.launches == before + cfg.num_layers
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_on, c_off, rtol=1e-4, atol=1e-4)
    _, _, c = TT.apply_model(params, cfg, tokens=toks[:, 32:40],
                             mode="decode", caches=c_on)   # a chunk of 8
    assert KS.launches == before + 2 * cfg.num_layers
    TT.apply_model(params, cfg, tokens=toks[:, :1], mode="decode", caches=c)
    assert KS.launches == before + 2 * cfg.num_layers   # decode: plain torch


# tolerances of flash_attention against its plain version on the card: in
# fp32 both sum 2,048-term dot products in fp32 in other orders (errors
# near 1e-6 on outputs near 1); in bf16 the tensor-core kernel also rounds
# p to bf16 for the p.v product (2^-9 relative per term, averaging out over
# a row) and both round the output once, so they differ by at most about
# one bf16 ulp of |out| <= 4 (2^-8 * 4 = 0.016)
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,sq,skv,hd,win", [
    (2, 4, 4, 128, 128, 64, 0), (1, 8, 2, 256, 256, 32, 0),
    (1, 4, 1, 256, 256, 64, 0), (1, 4, 2, 256, 256, 64, 96),
    (2, 4, 2, 300, 300, 16, 0), (1, 4, 1, 1000, 1000, 256, 0),
    (2, 8, 2, 1000, 1000, 128, 0), (1, 4, 4, 37, 70, 64, 0),
    (1, 16, 8, 2048, 2048, 256, 1024), (1, 2, 1, 12, 4, 16, 3)])
def test_flash_attention_kernel_close(cuda, dtype, b, h, kvh, sq, skv, hd,
                                      win):
    g = torch.Generator(device=cuda).manual_seed(sq + hd + win)
    q = torch.randn((b, h, sq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, kvh, skv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kvh, skv, hd), generator=g, device=cuda).to(dtype)
    want = KF.flash_attention_plain(q, k, v, win)
    before = KF.launches
    got = KF.flash_attention(q, k, v, win)
    torch.cuda.synchronize()
    assert KF.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_attention_bf16_head_dims(cuda, hd):
    """The tensor-core kernel at every head dim: GQA 3:1, ragged Sq and Skv
    (Sq > Skv: the last rows see nothing), with and without a window."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    for sq, skv, win in ((200, 200, 0), (131, 77, 0), (300, 300, 50)):
        q = torch.randn((2, 6, sq, hd), generator=g, device=cuda).bfloat16()
        k = torch.randn((2, 2, skv, hd), generator=g, device=cuda).bfloat16()
        v = torch.randn((2, 2, skv, hd), generator=g, device=cuda).bfloat16()
        want = KF.flash_attention_plain(q, k, v, win)
        got = KF.flash_attention(q, k, v, win)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[torch.bfloat16])


def test_flash_attention_bf16_reads_strided_views(cuda):
    """The model's (B, S, heads, hd) bf16 tensors, seen as (B, heads, S,
    hd), go to the tensor-core kernel through TMA maps with their own
    strides."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 150, 8, 256), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 150, 1, 256), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 150, 1, 256), generator=g, device=cuda).bfloat16()
    got = ops.flash_attention(q, k, v)
    want = KF.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2))
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                               **FLASH_TOL[torch.bfloat16])


def test_flash_attention_bf16_refuses_what_tma_cannot_load(cuda):
    """No quiet copy: a bf16 view that TMA cannot load raises."""
    kv = torch.zeros((1, 1, 8, 32), device=cuda, dtype=torch.bfloat16)
    rows36 = torch.zeros((1, 2, 8, 36), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):    # row stride 36
        KF.flash_attention(rows36[..., :32], kv, kv)
    rows40 = torch.zeros((1, 2, 8, 40), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):    # starts 2 bytes in
        KF.flash_attention(rows40[..., 1:33], kv, kv)
    got = KF.flash_attention(rows40[..., 8:40], kv, kv)   # 16 bytes in
    assert got.shape == (1, 2, 8, 32)


def test_flash_attention_kernel_reads_strided_views(cuda):
    """The model's (B, S, heads, hd) tensors, seen as (B, heads, S, hd)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 100, 8, 128), generator=g, device=cuda)
    k = torch.randn((2, 100, 2, 128), generator=g, device=cuda)
    v = torch.randn((2, 100, 2, 128), generator=g, device=cuda)
    got = ops.flash_attention(q, k, v, window=30)
    assert got.is_contiguous()
    want = KF.flash_attention_plain(q.transpose(1, 2).contiguous(),
                                    k.transpose(1, 2).contiguous(),
                                    v.transpose(1, 2).contiguous(), 30)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=1e-4,
                               atol=1e-4)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.zeros
    with pytest.raises(ValueError, match="hd=48"):
        KF.flash_attention(z(1, 2, 8, 48, device=cuda),
                           z(1, 1, 8, 48, device=cuda),
                           z(1, 1, 8, 48, device=cuda))
    with pytest.raises(ValueError, match="H % KV"):
        KF.flash_attention(z(1, 3, 8, 32, device=cuda),
                           z(1, 2, 8, 32, device=cuda),
                           z(1, 2, 8, 32, device=cuda))
    with pytest.raises(TypeError, match="bfloat16"):
        KF.flash_attention(z(1, 2, 8, 32, device=cuda, dtype=torch.float16),
                           z(1, 1, 8, 32, device=cuda, dtype=torch.float16),
                           z(1, 1, 8, 32, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="on cpu"):
        KF.flash_attention(z(1, 2, 8, 32, device=cuda), z(1, 1, 8, 32),
                           z(1, 1, 8, 32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        KF.flash_attention(z(1, 2, 32, 8, device=cuda).transpose(2, 3),
                           z(1, 1, 8, 32, device=cuda),
                           z(1, 1, 8, 32, device=cuda))


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-12b"])
def test_attention_prefill_is_one_launch_per_layer(cuda, arch):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              dtype=torch.float32)
    params = TT.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    before = KF.launches
    on, _, c_on = TT.apply_model(params, cfg, tokens=toks[:, :37],
                                 mode="prefill", cache_slots=48)
    assert KF.launches == before + cfg.num_layers
    off, _, c_off = TT.apply_model(params, cfg, tokens=toks[:, :37],
                                   mode="prefill", cache_slots=48,
                                   use_kernels=False)
    assert KF.launches == before + cfg.num_layers
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)
    for key in c_on:
        a, b = c_on[key]["attn"], c_off[key]["attn"]
        assert torch.equal(a.pos, b.pos)
        # bf16 leaves: one rounding of fp32 values that agree to ~1e-6
        torch.testing.assert_close(a.k.float(), b.k.float(), rtol=1e-2,
                                   atol=1e-2)
        torch.testing.assert_close(a.v.float(), b.v.float(), rtol=1e-2,
                                   atol=1e-2)
    _, _, c = TT.apply_model(params, cfg, tokens=toks[:, 37:40],
                             mode="decode", caches=c_on, pos_scalar=37)
    TT.apply_model(params, cfg, tokens=toks[:, :1], mode="decode", caches=c,
                   pos_scalar=40)
    assert KF.launches == before + cfg.num_layers   # decode: plain torch


# the attention shapes of the MoE, hybrid and embeds models at a 2,048-token
# prefill: olmoe-1b-7b (MHA, hd 128), jamba-v0.1-52b (GQA 32:8, hd 128),
# musicgen-large (MHA, hd 64), in the model's (B, S, heads, hd) layout
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd", [(16, 16, 128), (32, 8, 128),
                                      (32, 32, 64)],
                         ids=["olmoe", "jamba", "musicgen"])
def test_flash_attention_at_the_moe_and_hybrid_shapes(cuda, h, kvh, hd,
                                                      dtype):
    g = torch.Generator(device=cuda).manual_seed(h + kvh + hd)
    q = torch.randn((1, 2048, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((1, 2048, kvh, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((1, 2048, kvh, hd), generator=g, device=cuda).to(dtype)
    before = KF.launches
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KF.launches == before + 1
    want = KF.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_moe_and_hybrid_prefill_is_one_launch_per_attention_layer(cuda,
                                                                  arch):
    """Reduced olmoe and jamba on the card in fp32: one flash_attention
    launch per attention layer in a prefill, none in a chunk or a decode
    step (the Mamba scan and the MoE dispatch are plain torch), and the
    kernel's prefill equal to the plain one's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              dtype=torch.float32)
    n_attn = cfg.num_periods * sum(s.mixer == "attn" for s in cfg.pattern)
    params = TT.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    before = KF.launches
    on, aux_on, c_on = TT.apply_model(params, cfg, tokens=toks[:, :37],
                                      mode="prefill", cache_slots=48)
    assert KF.launches == before + n_attn
    off, aux_off, c_off = TT.apply_model(params, cfg, tokens=toks[:, :37],
                                         mode="prefill", cache_slots=48,
                                         use_kernels=False)
    assert KF.launches == before + n_attn
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux_on, aux_off, rtol=1e-5, atol=1e-6)
    c = TT.init_caches(cfg, 2, 48, per_slot_pos=True, device=cuda)
    _, _, c = TT.apply_model(params, cfg, tokens=toks[:, :37],
                             mode="decode", caches=c,
                             pos_scalar=torch.zeros(2, dtype=torch.int64,
                                                    device=cuda))
    TT.apply_model(params, cfg, tokens=toks[:, 37:38], mode="decode",
                   caches=c, pos_scalar=torch.full((2,), 37, device=cuda))
    assert KF.launches == before + n_attn


def test_moe_dispatch_on_the_card_equals_the_cpu(cuda):
    """Tight capacity (dropped entries clamped onto kept ones) on the card
    and on the CPU: the same routing, the same drops and outputs within
    fp32 reassociation; the accumulating scatter adds zeros, so nothing
    depends on the order of its atomics."""
    from repro_torch.models import moe as TM
    cfg = TM.MoEConfig(d_model=64, d_ff=96, num_experts=8,
                       experts_per_token=2, capacity_factor=0.5)
    params = TM.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 64, 64), generator=torch.Generator().manual_seed(1))
    want, want_aux = TM.moe(params, cfg, x)
    on = {k: v.to(cuda) for k, v in params.items()}
    got, got_aux = TM.moe(on, cfg, x.to(cuda))
    xt = x.reshape(-1, 64)
    _, tp, te = TM._router(params, cfg, xt)
    _, tpc, tec = TM._router(on, cfg, xt.to(cuda))
    assert torch.equal(te, tec.cpu())
    c = TM.capacity(xt.shape[0], cfg)
    keep = TM._local_dispatch(xt, te, tp, 8, c)[1][2]
    keep_c = TM._local_dispatch(xt.to(cuda), tec, tpc, 8, c)[1][2]
    assert torch.equal(keep, keep_c.cpu()) and not bool(keep.all())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5,
                               atol=1e-7)
    again, _ = TM.moe(on, cfg, x.to(cuda))
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# the backward kernels (training): against their plain backwards, and bit
# for bit across two launches (no floating-point atomics)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strided_do", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,sq,skv,hd,win", [
    (2, 8, 1, 2048, 2048, 256, 0), (2, 4, 4, 128, 128, 64, 0),
    (1, 8, 2, 256, 256, 32, 0), (1, 4, 2, 256, 256, 64, 96),
    (2, 4, 2, 300, 300, 16, 0), (2, 8, 2, 1000, 1000, 128, 0),
    (1, 4, 2, 200, 333, 64, 0), (1, 4, 2, 333, 200, 64, 50),
    # the bf16 tensor-core route at every head dim: MQA, GQA, MHA, windows,
    # ragged Sq != Skv, rows that see nothing (Sq > Skv with a window)
    (1, 6, 1, 190, 130, 16, 0), (2, 6, 2, 131, 77, 32, 20),
    (1, 4, 4, 250, 250, 64, 64), (1, 10, 2, 515, 300, 128, 0),
    (1, 8, 1, 700, 700, 256, 100), (1, 4, 2, 300, 129, 256, 40)])
def test_flash_attention_bwd_kernel_close(cuda, dtype, b, h, kvh, sq, skv,
                                          hd, win, strided_do):
    """Each backward route against the plain backward, twice bit for bit;
    a strided dO (the model's (B, S, H, hd) layout, or a view whose hd axis
    is not contiguous) is copied first, never refused."""
    g = torch.Generator(device=cuda).manual_seed(sq + skv + hd + win)
    q = torch.randn((b, h, sq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, kvh, skv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kvh, skv, hd), generator=g, device=cuda).to(dtype)
    do = torch.randn((b, h, sq, hd), generator=g, device=cuda).to(dtype)
    if strided_do:      # hd axis with stride 2: neither route loads it as is
        do = torch.stack((do, torch.zeros_like(do)), dim=-1)[..., 0]
        assert do.stride(3) == 2
    before = (KF.launches, KF.bwd_launches)
    out, lse = KF._forward(q, k, v, win, with_lse=True)
    want_out, want_lse = KF.flash_attention_fwd_plain(q, k, v, win)
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    torch.testing.assert_close(lse[fin], want_lse[fin], rtol=1e-5, atol=1e-4)
    got = KF._backward(q, k, v, out, lse, do, win)
    again = KF._backward(q, k, v, out, lse, do, win)
    torch.cuda.synchronize()
    assert (KF.launches, KF.bwd_launches) == (before[0] + 1, before[1] + 2)
    want = KF.flash_attention_bwd_plain(q, k, v, out, lse, do, win)
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        assert a.dtype == dtype and a.shape == w.shape
        torch.testing.assert_close(a.float(), w.float(), **FLASH_TOL[dtype])


def test_flash_attention_bwd_bf16_refuses_what_tma_cannot_load(cuda):
    """A bf16 backward call with q, k or v that TMA cannot load raises, and
    no backward kernel (the SIMT route included) is launched for it."""
    kv = torch.zeros((1, 1, 8, 32), device=cuda, dtype=torch.bfloat16)
    good = torch.zeros((1, 2, 8, 32), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    rows36 = torch.zeros((1, 2, 8, 36), device=cuda, dtype=torch.bfloat16)
    rows40 = torch.zeros((1, 2, 8, 40), device=cuda, dtype=torch.bfloat16)
    kv36 = torch.zeros((1, 1, 8, 36), device=cuda, dtype=torch.bfloat16)
    before = KF.bwd_launches
    for q, k in ((rows36[..., :32], kv), (rows40[..., 1:33], kv),
                 (good, kv36[..., :32])):
        with pytest.raises(ValueError, match="TMA"):
            KF._backward(q, k, kv, good, lse, good, 0)
    assert KF.bwd_launches == before
    KF._backward(rows40[..., 8:40], kv, kv, good, lse, good, 0)  # 16 B in
    torch.cuda.synchronize()
    assert KF.bwd_launches == before + 1


def test_flash_attention_function_on_the_card(cuda):
    """The autograd Function: one forward (with lse) and one backward
    launch, the gradient of autograd through the plain version; strided
    (B, S, H, hd) views, as the model passes them."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 300, 4, 64), generator=g, device=cuda)
    k = torch.randn((2, 300, 2, 64), generator=g, device=cuda)
    v = torch.randn((2, 300, 2, 64), generator=g, device=cuda)
    do = torch.randn((2, 300, 4, 64), generator=g, device=cuda)
    args = [x.requires_grad_() for x in (q, k, v)]
    before = (KF.launches, KF.bwd_launches)
    out = ops.flash_attention(*args, window=40)
    got = torch.autograd.grad(out, args, do)
    assert (KF.launches, KF.bwd_launches) == (before[0] + 1, before[1] + 1)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    ref = KF.flash_attention_plain(t(q), t(k), t(v), 40).transpose(1, 2)
    want = torch.autograd.grad(ref, args, do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("b,t,dk,dv", [(128, 2048, 64, 64), (1, 1000, 16, 16),
                                       (3, 96, 8, 24), (2, 33, 5, 7),
                                       (2, 50, 64, 128), (4, 17, 1, 1),
                                       # clusters of 1, 2, 4 and 8 CTAs
                                       (3, 61, 16, 7), (2, 100, 40, 24),
                                       (3, 77, 64, 64), (2, 45, 64, 128)])
def test_ssm_scan_bwd_kernel_close(cuda, b, t, dk, dv, full):
    r, w, k, v, u, s0 = (None if x is None else x.to(cuda) for x in
                         _wkv_inputs(b, t, dk, dv, b + t + dv, full))
    if not full:
        u = None
    g = torch.Generator(device=cuda).manual_seed(dk)
    dy = torch.randn((b, t, dv), generator=g, device=cuda)
    dsf = torch.randn((b, dk, dv), generator=g, device=cuda) if full else None
    before = KS.bwd_launches
    got = KS._backward(r, w, k, v, u, s0, dy, dsf)
    again = KS._backward(r, w, k, v, u, s0, dy, dsf)
    torch.cuda.synchronize()
    assert KS.bwd_launches == before + 2
    want = KS.ssm_scan_bwd_plain(r, w, k, v, u, s0, dy, dsf)
    for a, c, x in zip(got, again, want):
        if x is None:
            assert a is None
            continue
        assert torch.equal(a, c)
        scale = max(1.0, float(x.abs().max()))
        assert float((a - x).abs().max()) <= 1e-4 * scale


def test_ssm_scan_bwd_allocates_no_partial_plane(cuda):
    """At rwkv6-1.6b's train shape the backward allocates its outputs and
    its checkpoints and nothing else (no column-partial plane: that was 3 x
    dv/16 x B*T*dk floats), and the cluster launch is resident in one
    wave."""
    b, t, dk, dv = 128, 2048, 64, 64
    r, w, k, v, _, _ = (None if x is None else x.to(cuda) for x in
                        _wkv_inputs(b, t, dk, dv, 3, False))
    dy = torch.randn((b, t, dv), device=cuda)
    KS._backward(r, w, k, v, None, None, dy, None)      # built, warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got = KS._backward(r, w, k, v, None, None, dy, None)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    outputs = 4 * (3 * b * t * dk + b * t * dv)
    ckpt = 4 * KS.bwd_scratch_floats(b, t, dv)
    assert extra <= outputs + ckpt + (4 << 20), (extra, outputs, ckpt)
    del got
    occ = KS.bwd_occupancy(b, dv, cuda)
    assert (occ["grid"], occ["cluster"]) == (512, 4)
    assert occ["one_wave"], occ


def test_ssm_scan_function_on_the_card(cuda):
    r, w, k, v, u, s0 = (x.to(cuda).requires_grad_() for x in
                         _wkv_inputs(2, 300, 16, 24, 9, True))
    dy = torch.randn((2, 300, 24), device=cuda)
    before = (KS.launches, KS.bwd_launches)
    y, _ = KS.ssm_scan(r, w, k, v, u, s0)
    got = torch.autograd.grad(y, (r, w, k, v, u, s0), dy)
    assert (KS.launches, KS.bwd_launches) == (before[0] + 1, before[1] + 1)
    y2, _ = KS.ssm_scan_plain(r, w, k, v, u, s0)
    want = torch.autograd.grad(y2, (r, w, k, v, u, s0), dy)
    for a, x in zip(got, want):
        scale = max(1.0, float(x.abs().max()))
        assert float((a - x).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_train_step_launches_and_matches_the_plain_step(cuda, arch):
    """A reduced fp32 train step on the card under full remat: two forward
    launches and one backward launch per layer, and the loss and gradients
    of the step with the kernels off."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    from repro_torch.train import step as TS
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              dtype=torch.float32)
    params = TT.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    params.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 65), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mod = KF if arch == "gemma-2b" else KS
    before = (mod.launches, mod.bwd_launches)
    loss, _, _, grads = TS.loss_and_grads(params, cfg, batch)
    assert (mod.launches - before[0], mod.bwd_launches - before[1]) == \
        (2 * cfg.num_layers, cfg.num_layers)
    loss2, _, _, grads2 = TS.loss_and_grads(params, cfg, batch,
                                            use_kernels=False)
    torch.testing.assert_close(loss, loss2, rtol=1e-5, atol=1e-6)
    for name in grads:
        scale = max(float(grads2[name].abs().max()), 1e-8)
        assert float((grads[name] - grads2[name]).abs().max()) <= \
            1e-4 * scale, name
