"""The one-launch DP wavefront (``kernels.dtw_wavefront.dp_wavefront``) on
the CPU: its plain version against the JAX package's ``run_wavefront`` over
the reference's plain tiles (jitted, as tests/test_wavefront.py runs them)
and against ``sw_tiled`` / ``dtw_tiled`` with padded ragged lengths; then
routing spies: with ``use_kernels`` on, every kernel-path caller of the tile
loop (the mapper's align, ``ops.sw_tiled``, ``ops.dtw_tiled``, the
service's sw, dtw and map buckets) calls ``dp_wavefront`` once per
alignment or bucket and the per-tile ``dp_tile`` never.

SW values are integers in fp32 and held exactly; DTW at rtol 1e-5 (the
reference kernel tests' tolerance; the same fp32 cell arithmetic runs in
both, so in practice the matrices agree bit for bit).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import align as JA
from repro.core import dtw as JD
from repro.core import wavefront as JWF
from repro_torch.apps.read_mapper import MapperConfig, ReadMapper
from repro_torch.data import genomics
from repro_torch.kernels import dtw_wavefront as KT
from repro_torch.kernels import ops
from repro_torch.runtime import KernelService, Request, ServiceConfig

DTW_RTOL = 1e-5
PARAMS = JA.SWParams()
_J_TILES = {"sw": jax.jit(functools.partial(JA._sw_tile_fn, PARAMS)),
            "dtw": jax.jit(JD._dtw_tile_fn)}
_J_TILES_B = {k: jax.jit(jax.vmap(functools.partial(JA._sw_tile_fn, PARAMS)
                                  if k == "sw" else JD._dtw_tile_fn))
              for k in ("sw", "dtw")}


def _inputs(kind, lead, n, m, seed):
    """a, b and the boundaries, as numpy: sw characters 0..3 with integer
    boundaries, dtw random walks with random boundaries."""
    rng = np.random.default_rng(seed)
    if kind == "sw":
        a = rng.integers(0, 4, lead + (n,)).astype(np.int32)
        b = rng.integers(0, 4, lead + (m,)).astype(np.int32)
        bnd = lambda shape: rng.integers(0, 30, shape).astype(np.float32)  # noqa: E731
    else:
        a = np.cumsum(rng.normal(size=lead + (n,)), -1).astype(np.float32)
        b = np.cumsum(rng.normal(size=lead + (m,)), -1).astype(np.float32)
        bnd = lambda shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return a, b, bnd(lead + (m,)), bnd(lead + (n,)), bnd(lead)


def _assert_equal(kind, got, want):
    got, want = got.numpy(), np.asarray(want)
    if kind == "sw":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=DTW_RTOL)


@pytest.mark.parametrize("kind", ["sw", "dtw"])
@pytest.mark.parametrize("lead,n,m,tile", [
    ((), 128, 192, 64),         # 2 x 3 tiles of 64
    ((), 40, 24, 8),            # 5 x 3 tiles of 8
    ((3,), 16, 40, 8)])         # a batch of 3, 2 x 5 tiles of 8
def test_plain_equals_reference_wavefront(kind, lead, n, m, tile):
    ins = _inputs(kind, lead, n, m, n * m + len(lead))
    jfn = (_J_TILES_B if lead else _J_TILES)[kind]
    want = JWF.run_wavefront(jfn, *(jnp.asarray(x) for x in ins),
                             tile_r=tile, tile_c=tile)
    got = KT.dp_wavefront_plain(*(torch.as_tensor(x) for x in ins),
                                kind=kind, tile_r=tile, tile_c=tile)
    assert got[0].shape == lead + (n, m)
    for g, w in zip(got, want):
        _assert_equal(kind, g, w)
    # on the CPU the wrapper is its plain version
    before = KT.wavefront_launches
    again = KT.dp_wavefront(*(torch.as_tensor(x) for x in ins), kind=kind,
                            tile_r=tile, tile_c=tile)
    assert KT.wavefront_launches == before
    for g, w in zip(again, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,m,tile", [(100, 150, 64), (37, 21, 8)])
def test_sw_tiled_ragged_equals_reference(n, m, tile):
    rng = np.random.default_rng(n + m)
    b = rng.integers(0, 4, m).astype(np.int32)
    a = np.resize(b[3:], n).copy()
    a[rng.random(n) < 0.1] = 2
    want_mat, want_best = JA.sw_tiled(jnp.asarray(a), jnp.asarray(b), PARAMS,
                                      tile, tile, tile_fn=_J_TILES["sw"])
    mat, best = ops.sw_tiled(torch.as_tensor(a), torch.as_tensor(b),
                             tile_r=tile, tile_c=tile)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(want_mat))
    assert float(best) == float(want_best)


@pytest.mark.parametrize("n,m,tile", [(100, 150, 64), (37, 21, 8)])
def test_dtw_tiled_ragged_equals_reference(n, m, tile):
    rng = np.random.default_rng(n * m)
    s = np.cumsum(rng.normal(size=n)).astype(np.float32)
    r = np.cumsum(rng.normal(size=m)).astype(np.float32)
    want_mat, want_d = JD.dtw_tiled(jnp.asarray(s), jnp.asarray(r), tile,
                                    tile, tile_fn=_J_TILES["dtw"])
    mat, d = ops.dtw_tiled(torch.as_tensor(s), torch.as_tensor(r), tile, tile)
    np.testing.assert_allclose(mat.numpy(), np.asarray(want_mat),
                               rtol=DTW_RTOL)
    np.testing.assert_allclose(float(d), float(want_d), rtol=DTW_RTOL)


def test_plain_refuses_ragged_inputs():
    z = torch.zeros
    with pytest.raises(ValueError, match="multiples"):
        KT.dp_wavefront(z(30, dtype=torch.int32), z(16, dtype=torch.int32),
                        z(16), z(30), z(()), kind="sw", tile_r=8, tile_c=8)


# -- routing ---------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Counts dp_wavefront calls (with each call's batch) and per-tile
    dp_tile calls, calling through to the real functions."""
    calls = {"wavefront": [], "tile": 0}
    real_wf, real_tile = KT.dp_wavefront, KT.dp_tile

    def wf(a, *args, **kw):
        calls["wavefront"].append(tuple(a.shape[:-1]))
        return real_wf(a, *args, **kw)

    def tile(*args, **kw):
        calls["tile"] += 1
        return real_tile(*args, **kw)

    monkeypatch.setattr(KT, "dp_wavefront", wf)
    monkeypatch.setattr(KT, "dp_tile", tile)
    monkeypatch.setattr(ops, "dp_tile", tile)
    return calls


def test_ops_tiled_is_one_wavefront_call(spies):
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(0, 4, 50).astype(np.int32))
    b = torch.as_tensor(rng.integers(0, 4, 70).astype(np.int32))
    ops.sw_tiled(a, b, tile_r=16, tile_c=16)        # 4 x 5 tiles
    ops.dtw_tiled(a.float(), b.float(), 16, 16)
    assert spies == {"wavefront": [(), ()], "tile": 0}


@pytest.fixture(scope="module")
def genome():
    ref = genomics.make_reference(6000, seed=3)
    prof = genomics.ReadProfile("TEST", 300, 20, 0.95)
    reads = [r for r, _ in genomics.sample_reads(ref, prof, 3, seed=4)]
    return ref, reads


def test_mapper_align_is_one_wavefront_call_per_read(genome, spies):
    ref, reads = genome
    cfg = MapperConfig(read_bucket=64, sw_tile=32)
    mapper = ReadMapper(ref, cfg, device="cpu")
    aligned = sum(bool(mapper.map_read(rd).align_cells) for rd in reads)
    assert aligned == len(reads)
    assert spies == {"wavefront": [()] * aligned, "tile": 0}
    # without the kernels the plain tile loop runs: no wavefront call
    off = ReadMapper(ref, MapperConfig(read_bucket=64, sw_tile=32,
                                       use_kernels=False),
                     device="cpu", index=mapper.index)
    off.map_read(reads[0])
    assert len(spies["wavefront"]) == aligned


def test_service_buckets_are_one_wavefront_call_each(genome, spies):
    ref, reads = genome
    rng = np.random.default_rng(5)
    cfg = ServiceConfig(seq_bucket=32, sw_tile=16, dtw_tile=16,
                        mapper=MapperConfig(read_bucket=64, sw_tile=32))
    svc = KernelService(cfg, reference=ref, device="cpu")
    # sw: lengths bucket to (32, 32) x2 and (64, 32); dtw: (32, 64) x3
    reqs = [Request("sw", {"a": rng.integers(0, 4, la).astype(np.int32),
                           "b": rng.integers(0, 4, lb).astype(np.int32)})
            for la, lb in ((20, 30), (31, 17), (50, 20))]
    reqs += [Request("dtw", {"s": rng.normal(size=ls).astype(np.float32),
                             "r": rng.normal(size=lr).astype(np.float32)})
             for ls, lr in ((20, 40), (32, 50), (9, 64))]
    svc.submit(reqs)
    assert sorted(spies["wavefront"]) == [(1,), (2,), (3,)]
    assert spies["tile"] == 0
    spies["wavefront"].clear()
    got = svc.submit([Request("map", {"read": rd}) for rd in reads])
    assert all(g.align_cells for g in got)
    # one call per (padded read, padded window) bucket, batch = its reads
    keys = [(-(-len(rd) // 64), -(-(g.align_cells // len(rd)) // 64))
            for rd, g in zip(reads, got)]
    want_batches = sorted((keys.count(k),) for k in set(keys))
    assert sorted(spies["wavefront"]) == want_batches
    assert spies["tile"] == 0
    want = [ReadMapper(ref, cfg.mapper, device="cpu").map_read(rd)
            for rd in reads]
    assert got == want
