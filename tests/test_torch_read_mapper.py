"""The whole slice: the PyTorch port's ReadMapper against the JAX
ReadMapper on the fixtures of tests/test_read_mapper.py (a 12,000-base
reference, 3 reads of 400 bases at 0.93 accuracy). The port runs on the
CPU, so its kernel wrappers run their plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.apps import read_mapper as jrm
from repro.data import genomics
from repro_torch.apps import read_mapper as trm
from repro_torch.convert import index_from_numpy
from repro_torch.runtime import dispatch


@pytest.fixture(scope="module")
def ref():
    return genomics.make_reference(12_000, seed=0)


@pytest.fixture(scope="module")
def reads(ref):
    prof = genomics.ReadProfile("TEST", 400, 80, 0.93)
    return genomics.sample_reads(ref, prof, 3, seed=1)


@pytest.fixture(scope="module")
def jax_results(ref, reads):
    """The reference mapper's results per mode: squire on its Pallas path,
    baseline on its plain path."""
    out = {}
    for mode, pallas in (("squire", True), ("baseline", False)):
        jm = jrm.ReadMapper(ref, jrm.MapperConfig(mode=mode,
                                                  use_pallas=pallas))
        out[mode] = (jm, jm.map_reads([r for r, _ in reads]))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pos == w.pos
        assert g.n_anchors == w.n_anchors
        assert g.align_cells == w.align_cells
        assert g.sw_score == w.sw_score
        np.testing.assert_allclose(g.chain_score, w.chain_score, rtol=1e-5)


@pytest.mark.parametrize("mode,kernels", [("squire", True),
                                          ("baseline", False)])
def test_mapper_matches_reference(ref, reads, jax_results, mode, kernels):
    """squire with the kernel switch on against the reference's Pallas
    path; baseline with it off against the reference's baseline. The port
    probes the reference's own index, then its own build of it."""
    jm, want = jax_results[mode]
    cfg = trm.MapperConfig(mode=mode, use_kernels=kernels)
    idx = index_from_numpy(np.asarray(jm.index.hashes),
                           np.asarray(jm.index.positions), device="cpu")
    shared = trm.ReadMapper(ref, cfg, device="cpu", index=idx)
    got = shared.map_reads([r for r, _ in reads])
    _assert_same(got, want)
    own = trm.ReadMapper(ref, cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(own.index, idx))
    if mode == "baseline":          # the quick arm maps again on its own
        assert own.map_reads([r for r, _ in reads]) == got
    acc = trm.mapping_accuracy(got, [t for _, t in reads])
    assert acc == jrm.mapping_accuracy(want, [t for _, t in reads]) == 1.0


def test_squire_without_kernels_matches_reference(ref, reads, jax_results):
    """The squire schedule on its plain path (blocked chain, plain tiles)
    against the reference's squire results."""
    want = jax_results["squire"][1][0]
    mapper = trm.ReadMapper(ref, trm.MapperConfig(mode="squire",
                                                  use_kernels=False),
                            device="cpu")
    _assert_same([mapper.map_read(reads[0][0])], [want])
    assert set(mapper.stage_ms) == {"seed", "chain", "align"}


def test_unmappable_and_short_reads(ref):
    rng = np.random.default_rng(9)
    junk = rng.integers(0, 4, 300).astype(np.int8)
    jm = jrm.ReadMapper(ref, jrm.MapperConfig(mode="baseline"))
    tm = trm.ReadMapper(ref, trm.MapperConfig(mode="baseline"), device="cpu")
    _assert_same([tm.map_read(junk)], [jm.map_read(junk)])
    assert tm.map_read(np.zeros(10, np.int8)) == trm.MapResult(
        -1, 0.0, 0.0, 0, 0)


def test_payload_builders_match_reference(reads, ref):
    read = reads[0][0]
    jcfg, tcfg = jrm.MapperConfig(), trm.MapperConfig()
    for g, w in zip(trm.seed_payload(read, tcfg),
                    jrm.seed_payload(read, jcfg)):
        np.testing.assert_array_equal(g, w)
    q = np.arange(37, dtype=np.int32)
    for g, w in zip(trm.chain_payload(q, 3 * q, tcfg),
                    jrm.chain_payload(q, 3 * q, jcfg)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(trm.align_payload(read, ref[:500], tcfg),
                    jrm.align_payload(read, ref[:500], jcfg)):
        np.testing.assert_array_equal(g, w)
    assert (trm.chain_window(q, 3 * q, [2, 30], 400, 12_000, tcfg)
            == jrm.chain_window(q, 3 * q, [2, 30], 400, 12_000, jcfg))
    jfields = {f.name for f in dataclasses.fields(jrm.MapperConfig)}
    tfields = {f.name for f in dataclasses.fields(trm.MapperConfig)}
    assert jfields - {"use_pallas"} == tfields - {"use_kernels"}


def test_dispatcher_bucket_stats():
    dispatch.BUCKET_STATS.clear()
    d = dispatch.Dispatcher()

    def stage(x):
        return x

    d.run_one(stage, (torch.zeros(4),))
    d.run_one(stage, (torch.zeros(4),))
    d.run_one(stage, (torch.zeros(8),))
    m = dispatch.BUCKET_STATS.metrics()
    key4 = [k for k in m if "[(4,)]" in k and k.endswith(".hits")][0]
    assert m[key4] == 1
    assert m[key4.replace(".hits", ".misses")] == 1
    assert sum(v for k, v in m.items() if k.endswith(".misses")) == 2
    dispatch.BUCKET_STATS.clear()
