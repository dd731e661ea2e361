"""KernelService slice of the PyTorch port against the JAX reference: one
mixed submit through the reference's KernelService (which jits its batched
stage functions, as tests/test_runtime.py runs it) and through the port's
KernelService on the CPU (the plain versions of the kernels), per kernel.

Tolerances: sw score/end, sort keys/vals, seed anchors, chain predecessors
and map results exact; dtw at rtol 1e-5 (float sums in another order); the
scan exact in the max-plus and min-plus semirings and at rtol 1e-5 in the
real one, where XLA may fuse a multiply-add; chain f at the port's chain
tolerance (rtol 1e-5, atol 1e-4: the fp32 log2 of the match-up scores can
differ in the last place between the two libraries). Against the port's
own direct calls every result is exact.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.apps.read_mapper import MapperConfig as JMapperConfig
from repro.data import genomics
from repro.runtime import KernelService as JKernelService
from repro.runtime import Request as JRequest
from repro.runtime import ServiceConfig as JServiceConfig
from repro_torch.apps.read_mapper import MapperConfig
from repro_torch.core import sort as TS
from repro_torch.core.scan1d import affine_scan
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.kernels import chain_scan as KC
from repro_torch.kernels import dtw_wavefront as KT
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import (Autotuner, Dispatcher, KernelService,
                                 Request, ServiceConfig, prefetched,
                                 run_pipelined, seed_from_fig9)
from repro_torch.runtime import dispatch as tdispatch
from repro_torch.runtime.service import _payload_key

RTOL, ATOL = 1e-5, 1e-4
SMALL = dict(seq_bucket=32, sw_tile=8, dtw_tile=8, anchor_bucket=64,
             sort_bucket=64, scan_bucket=16)
MAP_KW = dict(read_bucket=64, sw_tile=8)


def _requests(rng, reads):
    reqs = []
    for n in (5, 17, 63, 130):
        reqs.append(("chain", {
            "q": np.sort(rng.integers(0, 400, n)).astype(np.int32),
            "r": np.sort(rng.integers(0, 5000, n)).astype(np.int32)}))
    for la, lb in ((7, 12), (31, 17), (20, 32)):
        reqs.append(("sw", {"a": rng.integers(0, 4, la).astype(np.int32),
                            "b": rng.integers(0, 4, lb).astype(np.int32)}))
    for ls, lr in ((5, 9), (16, 16), (32, 25), (12, 12)):
        reqs.append(("dtw", {"s": rng.normal(size=ls).astype(np.float32),
                             "r": rng.normal(size=lr).astype(np.float32)}))
    for n in (3, 63, 64):
        keys = rng.integers(0, 2**32, n, dtype=np.uint32)
        keys[::4] = keys[0]                       # equal keys: stability
        reqs.append(("sort", {"keys": keys}))
    reqs.append(("sort", {"keys": rng.integers(0, 9, 20, dtype=np.uint32),
                          "vals": rng.integers(-50, 50, 20)
                          .astype(np.int32)}))
    for t in (4, 20, 33):
        reqs.append(("scan1d", {"a": rng.normal(size=t).astype(np.float32),
                                "b": rng.normal(size=t).astype(np.float32),
                                "x0": np.float32(rng.normal())}))
    for rd in reads:
        reqs.append(("map", {"read": rd}))
        reqs.append(("seed", {"read": rd}))
    return reqs


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    ref = genomics.make_reference(3000, seed=0)
    prof = genomics.ReadProfile("TEST", 100, 10, 0.95)
    reads = [r for r, _ in genomics.sample_reads(ref, prof, 2, seed=1)]
    reads += [rng.integers(0, 4, 100).astype(np.int8),   # unmapped
              np.zeros(10, np.int8)]                      # too short
    reqs = _requests(rng, reads)
    jsvc = JKernelService(JServiceConfig(
        **SMALL, mapper=JMapperConfig(mode="squire", **MAP_KW)),
        reference=ref)
    svc = KernelService(ServiceConfig(
        **SMALL, mapper=MapperConfig(mode="squire", **MAP_KW)),
        reference=ref, device="cpu")
    want = jsvc.submit([JRequest(k, p) for k, p in reqs])
    tdispatch.BUCKET_STATS.clear()
    got = svc.submit([Request(k, p) for k, p in reqs])
    calls = {k: b["hits"] + b["misses"]
             for k, b in tdispatch.BUCKET_STATS.buckets.items()}
    return dict(ref=ref, reads=reads, reqs=reqs, want=want, got=got,
                svc=svc, metrics=svc.metrics(), bucket_stats=calls)


def _of(world, kernel):
    return [(p, w, g) for (k, p), w, g in
            zip(world["reqs"], world["want"], world["got"]) if k == kernel]


def test_chain_matches_reference_and_direct_calls(world):
    for p, w, g in _of(world, "chain"):
        np.testing.assert_array_equal(g["pred"], w["pred"])
        np.testing.assert_allclose(g["f"], w["f"], rtol=RTOL, atol=ATOL)
        f, pred = ops.chain_anchors(torch.as_tensor(p["q"]),
                                    torch.as_tensor(p["r"]), T=64)
        np.testing.assert_array_equal(g["f"], f.numpy())
        np.testing.assert_array_equal(g["pred"], pred.numpy())


def test_sw_matches_reference_and_direct_calls(world):
    for p, w, g in _of(world, "sw"):
        assert float(g["score"]) == float(w["score"])
        assert g["end"] == tuple(int(x) for x in w["end"])
        mat, best = ops.sw_tiled(torch.as_tensor(p["a"]),
                                 torch.as_tensor(p["b"]), tile_r=8,
                                 tile_c=8)
        flat = int(torch.argmax(mat.reshape(-1)))
        assert float(g["score"]) == float(best)
        assert g["end"] == (flat // mat.shape[1], flat % mat.shape[1])


def test_dtw_matches_reference_and_direct_calls(world):
    for p, w, g in _of(world, "dtw"):
        np.testing.assert_allclose(g["distance"], w["distance"], rtol=1e-5)
        _, dist = ops.dtw_tiled(torch.as_tensor(p["s"]),
                                torch.as_tensor(p["r"]), 8, 8)
        assert float(g["distance"]) == float(dist)


def test_sort_matches_reference_and_direct_calls(world):
    for p, w, g in _of(world, "sort"):
        np.testing.assert_array_equal(g["keys"], w["keys"])
        np.testing.assert_array_equal(g["vals"], w["vals"])
        assert g["keys"].dtype == np.uint32
        vals = (torch.as_tensor(p["vals"]) if "vals" in p else None)
        sk, sv = TS.radix_sort(torch.as_tensor(p["keys"].astype(np.int64)),
                               vals, num_chunks=4, min_parallel=0)
        np.testing.assert_array_equal(g["keys"], sk.numpy())
        np.testing.assert_array_equal(g["vals"], sv.numpy())


def test_seed_matches_reference(world):
    seeds = _of(world, "seed")
    assert len(seeds[0][2]["q"]) > 0
    for p, w, g in seeds:
        np.testing.assert_array_equal(g["q"], w["q"])
        np.testing.assert_array_equal(g["r"], w["r"])


def test_map_matches_reference(world):
    maps = _of(world, "map")
    assert sum(g.pos >= 0 for _, _, g in maps) >= 2
    assert [g.pos for _, _, g in maps][-1] == -1          # too short
    for p, w, g in maps:
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_map_baseline_without_kernels_matches_reference(world):
    reads = world["reads"][:2]
    jsvc = JKernelService(JServiceConfig(mapper=JMapperConfig(
        mode="baseline", **MAP_KW)), reference=world["ref"])
    svc = KernelService(ServiceConfig(mapper=MapperConfig(
        mode="baseline", use_kernels=False, **MAP_KW)),
        reference=world["ref"], device="cpu")
    want = jsvc.submit([JRequest("map", {"read": r}) for r in reads])
    got = svc.submit([Request("map", {"read": r}) for r in reads])
    for w, g in zip(want, got):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("semiring", ["real", "maxplus", "minplus"])
def test_scan1d_matches_reference_and_direct_calls(world, semiring):
    scans = [p for k, p in world["reqs"] if k == "scan1d"]
    jsvc = JKernelService(JServiceConfig(**SMALL, scan_semiring=semiring))
    svc = KernelService(ServiceConfig(**SMALL, scan_semiring=semiring),
                        device="cpu")
    want = jsvc.submit([JRequest("scan1d", p) for p in scans])
    got = svc.submit([Request("scan1d", p) for p in scans])
    for p, w, g in zip(scans, want, got):
        if semiring == "real":
            np.testing.assert_allclose(g["xs"], w["xs"], rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(g["xs"], w["xs"])
        direct = affine_scan(torch.as_tensor(p["a"]),
                             torch.as_tensor(p["b"]),
                             torch.as_tensor(p["x0"]), SEMIRINGS[semiring])
        np.testing.assert_array_equal(g["xs"], direct.numpy())


def test_kernels_off_equals_kernels_on(world):
    keep = ("chain", "sw", "dtw")
    reqs = [(k, p) for k, p in world["reqs"] if k in keep]
    svc = KernelService(ServiceConfig(**SMALL, use_kernels=False),
                        device="cpu")
    off = svc.submit([Request(k, p) for k, p in reqs])
    on = [g for (k, _), g in zip(world["reqs"], world["got"]) if k in keep]
    for (k, _), a, b in zip(reqs, off, on):
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


def test_cpu_service_launches_no_kernel(world):
    KC.launches = KT.launches = 0
    svc = world["svc"]
    svc.submit([Request(k, p) for k, p in world["reqs"][:12]])
    assert (KC.launches, KT.launches) == (0, 0)


def test_metrics_and_bucket_dispatch(world):
    m = world["metrics"]
    assert m["submits"] == 1 and m["deduped_requests"] == 0
    assert m["requests.map"] == 4 and m["requests.seed"] == 4
    assert m["requests.chain"] == 4 and m["requests.sort"] == 4
    # chain lengths 5, 17, 63 pad to 64 and 130 to 192: a bucket of 3 and
    # one of 1, each one batched dispatch (one chain_scan launch on the
    # card); the map kernel's chain stage adds one batch of its 3 reads
    # with anchors (one anchor bucket)
    chain = {k: v for k, v in world["bucket_stats"].items()
             if k.startswith("_chain_fn_kernel.run[b")}
    assert chain == {"_chain_fn_kernel.run[b3]": 2,
                     "_chain_fn_kernel.run[b1]": 1}
    snap = obs_metrics.REGISTRY.snapshot()
    assert snap["runtime.service.requests.chain"] >= 4
    assert world["svc"].stats()["kernels"] == sorted(
        ["chain", "dtw", "map", "scan1d", "seed", "sort", "sw"])


def test_mixed_submit_preserves_order(world):
    rng = np.random.default_rng(5)
    svc = world["svc"]
    out = svc.submit([
        Request("dtw", {"s": rng.normal(size=6).astype(np.float32),
                        "r": rng.normal(size=8).astype(np.float32)}),
        Request("sort", {"keys": rng.integers(0, 99, 7, dtype=np.uint32)}),
        Request("scan1d", {"a": np.ones(5, np.float32),
                           "b": np.zeros(5, np.float32),
                           "x0": np.float32(3.0)}),
        Request("dtw", {"s": rng.normal(size=12).astype(np.float32),
                        "r": rng.normal(size=5).astype(np.float32)}),
    ])
    assert "distance" in out[0] and "distance" in out[3]
    assert "keys" in out[1] and "xs" in out[2]
    np.testing.assert_array_equal(out[2]["xs"], np.full(5, 3.0, np.float32))


@pytest.mark.parametrize("kernel", ["nope", "generate", "score"])
def test_unknown_kernels_raise(world, kernel):
    with pytest.raises(KeyError):
        world["svc"].submit([Request(kernel, {})])


def test_empty_submit(world):
    assert world["svc"].submit([]) == []


def test_seed_needs_reference():
    svc = KernelService(ServiceConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="reference"):
        svc.submit([Request("seed", {"read": np.zeros(64, np.int8)})])


def test_dedup_without_aliasing(world):
    rng = np.random.default_rng(3)
    svc = world["svc"]
    keys = rng.integers(0, 2**32, 17, dtype=np.uint32)
    other = rng.integers(0, 2**32, 9, dtype=np.uint32)
    before = svc.deduped_requests
    out = svc.submit([Request("sort", {"keys": keys}),
                      Request("sort", {"keys": other}),
                      Request("sort", {"keys": keys.copy()}),
                      Request("sort", {"keys": keys.copy()})])
    assert svc.deduped_requests == before + 2
    assert svc.metrics()["deduped_requests"] == svc.deduped_requests
    want = np.sort(keys)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(out[i]["keys"], want)
    out[2]["keys"][:] = 0
    np.testing.assert_array_equal(out[0]["keys"], want)
    np.testing.assert_array_equal(out[3]["keys"], want)
    a32 = np.asarray([1, 0], np.uint32)
    b64 = np.asarray([1], np.uint64)
    assert a32.tobytes() == b64.tobytes()
    assert _payload_key({"keys": a32}) != _payload_key({"keys": b64})
    assert _payload_key({"keys": a32}) == _payload_key({"keys": a32.copy()})


def test_service_default_device_is_the_card():
    if torch.cuda.is_available():
        assert KernelService().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        KernelService()


# --------------------------------------------------------------------------
# dispatcher and pipeline
# --------------------------------------------------------------------------

def _affine_batched(x, y):
    return x * 2.0 + y, torch.sum(x, dim=-1)


def test_dispatcher_run_matches_row_loop():
    d = Dispatcher()
    x = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    y = torch.tensor(1.0)
    tdispatch.BUCKET_STATS.clear()
    reg = obs_metrics.REGISTRY
    misses0 = reg.counter("runtime.dispatch.cache_misses").value
    hits0 = reg.counter("runtime.dispatch.cache_hits").value
    prev = obs_trace.set_tracer(obs_trace.Tracer(enabled=True))
    try:
        out, s = d.run(_affine_batched, (x, y), in_axes=(0, None))
        d.run(_affine_batched, (x, y), in_axes=(0, None))
        spans = [e for e in obs_trace.get_tracer().events
                 if e.name == "bucket-dispatch"]
    finally:
        obs_trace.set_tracer(prev)
    for i in range(5):
        o, v = _affine_batched(x[i], y)
        assert torch.equal(out[i], o) and torch.equal(s[i], v)
    stats = tdispatch.BUCKET_STATS.buckets["_affine_batched[b5]"]
    assert (stats["misses"], stats["hits"]) == (1, 1)
    assert reg.counter("runtime.dispatch.cache_misses").value == misses0 + 1
    assert reg.counter("runtime.dispatch.cache_hits").value == hits0 + 1
    assert len(spans) == 2 and spans[0].args["batch"] == 5
    assert "runtime.dispatch.bucket._affine_batched[b5].hits" in \
        reg.snapshot()


def test_run_pipelined_preserves_order_and_results():
    items = [torch.tensor(float(i)) for i in range(9)]
    got = list(run_pipelined(items, lambda x: x * x, depth=3))
    assert [float(g) for g in got] == [float(i * i) for i in range(9)]


def test_run_pipelined_propagates_producer_errors():
    def items():
        yield torch.tensor(1.0)
        raise RuntimeError("producer boom")
    with pytest.raises(RuntimeError, match="producer boom"):
        list(run_pipelined(items(), lambda x: x))


def test_prefetched_consumer_may_stop_early():
    it = prefetched(iter(range(1000)), buffer=2)
    assert next(it) == 0
    it.close()                      # the producer stops instead of hanging


# --------------------------------------------------------------------------
# autotune
# --------------------------------------------------------------------------

def test_autotune_cache_roundtrip_and_bucketed_keys(tmp_path):
    path = str(tmp_path / "cache.json")
    t = Autotuner(path)
    assert t.get("dtw.tile") is None
    t.put("dtw.tile", 32, us=12.5)
    t.put("sort.chunks", 4)
    t.put("sort.chunks@b256", 8)
    fresh = Autotuner(path)
    assert fresh.get("dtw.tile") == 32
    assert fresh.get_bucketed("sort.chunks", 256) == 8
    assert fresh.get_bucketed("sort.chunks", 512) == 4
    assert fresh.get_bucketed("chain.block", 64, 16) == 16
    data = json.loads((tmp_path / "cache.json").read_text())
    assert data["dtw.tile"]["value"] == 32


def test_autotune_default_path_is_the_ports_own(monkeypatch, tmp_path):
    from repro_torch.runtime import autotune
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert autotune.default_cache_path() == os.path.join(
        str(tmp_path), ".cache", "repro_torch", "autotune.json")


def test_autotune_tune_picks_fastest_and_skips_failures(tmp_path):
    t = Autotuner(str(tmp_path / "cache.json"))
    calls = []

    def make_thunk(cand):
        def thunk():
            calls.append(cand)
            if cand == "bad":
                raise ValueError("block size incompatible with bucket")
            if cand == "slow":
                sum(range(200_000))
            return torch.zeros(())
        return thunk

    best = t.tune("toy.knob", {"bad": "bad", "slow": "slow",
                               "fast": "fast"}, make_thunk)
    assert best == "fast"
    entry = json.loads((tmp_path / "cache.json").read_text())["toy.knob"]
    assert "incompatible" in entry["failed"]["bad"]
    calls.clear()
    assert t.tune("toy.knob", {"slow": "slow"}, make_thunk) == "fast"
    assert calls == []
    with pytest.raises(RuntimeError, match="every candidate failed"):
        t.tune("doomed.knob", {"bad": "bad"}, make_thunk)


def test_autotune_seed_from_fig9_and_service_config(tmp_path):
    path = str(tmp_path / "cache.json")
    rows = ["fig9.dtw.tile16,90.0,x=1", "fig9.dtw.tile32,40.0,x=1",
            "fig9.sort.chunks8@b256,5.0,", "not a row"]
    assert seed_from_fig9(rows, path) == {"dtw.tile": 32,
                                          "sort.chunks@b256": 8}
    cfg = ServiceConfig().tuned(Autotuner(path))
    assert (cfg.dtw_tile, cfg.sw_tile) == (32, 32)
