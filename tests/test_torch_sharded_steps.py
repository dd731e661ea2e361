"""The pieces under the port's sharded pool on the CPU: the 1-D worker mesh
(``launch.mesh``), ``Dispatcher(mesh=...)``, the sharded step factories
(``serve.engine.make_sharded_*_step``) and their caches, the stacked pool's
trash rows, the mesh route of the slot pool, ``SwapStore`` migration
against the reference's store, and the launches of one sharded tick.

A mesh here names ``torch.device("cpu")`` n times, the counterpart of the
reference's forced host devices. Model runs are reduced and fp32: gemma-2b
(the port's own; the reference's sharded scheduler is held to it in
``tests/test_torch_sharded.py``) and rwkv6-1.6b, whose sharded placements,
steals and streams are held here to the reference's with one set of
weights through ``convert.params_from_numpy``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import transformer as RT
from repro.models.attention import KVCache as JKVCache
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve.paging import SwapEntry as JSwapEntry
from repro.serve.paging import SwapStore as JSwapStore
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import ssm_scan as K
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import WorkerMesh, make_worker_mesh
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import dispatch
from repro_torch.runtime.dispatch import Dispatcher
from repro_torch.runtime.service import _scan_fn
from repro_torch.serve import Scheduler, SchedulerConfig, SlotManager, engine
from repro_torch.serve.paging import SwapEntry, SwapStore

_BASE = dict(num_slots=4, max_len=64, prefill_chunk=8, allocator="paged",
             block_size=8, num_blocks=24, eos_token=5, cache_requests=False)
_LENS = [3, 17, 9, 24, 5, 12]
_MNTS = [6, 4, 8, 5, 7, 3]


def _cpu_mesh(n, axis="slots"):
    return WorkerMesh((torch.device("cpu"),) * n, (axis,))


@pytest.fixture(scope="module")
def gemma():
    cfg = dataclasses.replace(TC.reduced_config("gemma-2b"),
                              dtype=torch.float32)
    return cfg, T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def rwkv():
    """(reference config, port config, JAX params, port params) of reduced
    fp32 rwkv6-1.6b, one set of weights for both packages."""
    rcfg = dataclasses.replace(RC.reduced_config("rwkv6-1.6b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.reduced_config("rwkv6-1.6b"),
                               dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.array, RT.init_model(jax.random.PRNGKey(0), rcfg))
    return (rcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tcfg, tree, device="cpu"))


def _run(cfg, params, prompts, mnts, mesh=None, **kw):
    s = Scheduler(cfg, params, SchedulerConfig(**{**_BASE, **kw}), mesh=mesh)
    return _drive(s, prompts, mnts)


def _drive(s, prompts, mnts):
    """Submit, step per request, drain: ([(tokens, reason)], scheduler)."""
    rids = []
    for p, m in zip(prompts, mnts):
        rids += s.submit([p], max_new_tokens=m)
        s.step()
    s.drain()
    return [(list(map(int, s.results[r].tokens)), s.results[r].reason)
            for r in rids], s


# -- the mesh -----------------------------------------------------------------

def test_make_worker_mesh_errors():
    """Too few or too many workers raise ValueError with the reference's
    opening words and no XLA advice; a mesh naming a CUDA device the
    machine lacks raises too (no fallback to the CPU)."""
    m = torch.cuda.device_count()
    with pytest.raises(ValueError) as ei:
        make_worker_mesh(m + 1)
    msg = str(ei.value)
    assert msg.startswith(f"requested {m + 1} workers but only {m} "
                          "device(s) are available")
    assert "XLA" not in msg
    for bad in (0, -1):
        with pytest.raises(ValueError, match="num_workers must be >= 1"):
            make_worker_mesh(bad)
    with pytest.raises(ValueError, match="does not exist"):
        WorkerMesh((torch.device("cuda", m),))
    with pytest.raises(ValueError, match="at least one device"):
        WorkerMesh(())
    with pytest.raises(ValueError, match="one axis"):
        WorkerMesh((torch.device("cpu"),), ("data", "model"))
    for fn in (mesh_lib.make_production_mesh, mesh_lib.make_smoke_mesh):
        with pytest.raises(NotImplementedError, match="item 4"):
            fn()


def test_worker_mesh_shape_and_identity():
    mesh = _cpu_mesh(3)
    assert mesh.axis_names == ("slots",) and mesh.shape == {"slots": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh == _cpu_mesh(3) and hash(mesh) == hash(_cpu_mesh(3))
    assert mesh != _cpu_mesh(2) and mesh != _cpu_mesh(3, axis="workers")


# -- Dispatcher(mesh=...) -----------------------------------------------------

def _pair(shared, a, b):
    """A stage function with a shared leaf and a tuple output."""
    return a * shared + b, (a - b).sum(dim=1)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("bsz", [5, 6])
def test_dispatcher_mesh_equals_no_mesh(n, bsz):
    """Over a CPU mesh of n entries the dispatcher pads the batch to a
    multiple of n by repeating its last row, runs each device's part and
    concatenates: every output equals the mesh-less call's position by
    position (odd batches included); the bucket key and the span carry the
    padded batch and the worker count."""
    rng = np.random.default_rng(bsz * 10 + n)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (bsz, 40)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(bsz, 40)).astype(np.float32))
    x0 = torch.as_tensor(rng.normal(size=(bsz,)).astype(np.float32))
    scan = _scan_fn("real", "sequential")
    want = Dispatcher().run(scan, (a, b, x0))
    got_d = Dispatcher(mesh=_cpu_mesh(n, "workers"))
    assert got_d.num_workers == n and got_d.axis == "workers"
    tracer = obs_trace.Tracer(enabled=True)
    prev = obs_trace.set_tracer(tracer)
    try:
        got = got_d.run(scan, (a, b, x0))
    finally:
        obs_trace.set_tracer(prev)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    padded = bsz + (-bsz) % n
    (span,) = [e for e in tracer.events if e.name == "bucket-dispatch"]
    assert span.args["batch"] == padded and span.args["workers"] == n
    assert f"_scan_fn.run[b{padded}]" in dispatch.BUCKET_STATS.buckets
    shared = torch.full((1, 40), 3.0)
    want = Dispatcher().run(_pair, (shared, a, b), in_axes=(None, 0, 0))
    got = got_d.run(_pair, (shared, a, b), in_axes=(None, 0, 0))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not in mesh axes"):
        Dispatcher(mesh=_cpu_mesh(n), axis="data")


# -- step factories -----------------------------------------------------------

def test_step_caches_fold_shard_count_and_mesh(gemma):
    """Each factory caches on (cfg, num_shards, block_size, mesh, axis):
    another shard count, block size or mesh never reuses a step, and the
    same key returns the same object. Mismatched meshes raise."""
    cfg, _ = gemma
    for make in (engine.make_sharded_decode_step,
                 engine.make_sharded_chunk_step,
                 engine.make_sharded_verify_step):
        f1 = make(cfg, 1, 8)
        assert make(cfg, 1, 8) is f1
        assert make(cfg, 2, 8) is not f1 and make(cfg, 1, 4) is not f1
        f3 = make(cfg, 1, 8, _cpu_mesh(1), "slots")
        assert f3 is not f1 and make(cfg, 1, 8, _cpu_mesh(1), "slots") is f3
        assert make(cfg, 2, 8, _cpu_mesh(2), "slots") is not f3
        with pytest.raises(ValueError, match="must match the mesh"):
            make(cfg, 2, 8, _cpu_mesh(1), "slots")
        with pytest.raises(ValueError, match="not in mesh axes"):
            make(cfg, 1, 8, _cpu_mesh(1), "workers")
        with pytest.raises(ValueError, match="num_shards must be >= 1"):
            make(cfg, 0, 8)


def test_stacked_rows_send_every_trash_row_to_the_last_block():
    """Shard-local rows offset into each shard's segment; a shard's trash
    rows go to the stack's LAST block, since paged_view reads every row
    below it as live."""
    nb, bs, n = 3, 2, 2                 # segment (3 + 1) * 2 = 8 rows
    local = np.array([[0, 1, 6, 7], [2, 3, 6, 7], [4, 5, 0, 1]])
    got = engine.stacked_rows(local, np.array([0, 1, 1]), nb, n, bs)
    np.testing.assert_array_equal(
        got, [[0, 1, 14, 15], [10, 11, 14, 15], [12, 13, 8, 9]])


def test_trash_writes_stay_out_of_other_shards(gemma):
    """A sharded pool's write-back of a whole view (unmapped positions
    included) lands only in the slot's mapped blocks and the stack's last
    block: another shard's blocks, and each shard's own trash block, keep
    their empty encoding; gather reads the written rows back."""
    cfg, _ = gemma
    sm = SlotManager(cfg, 4, 32, paged=True, block_size=8, num_blocks=4,
                     mesh_shards=2, device="cpu")
    slot = sm.alloc(0, prompt_len=5, shard=0)
    assert sm.shard_of_slot(slot) == 0
    sub = sm.gather([slot])
    key = next(iter(sm.backing.paged))
    view = sub[key]["attn"]
    g = torch.Generator().manual_seed(0)
    sub[key]["attn"] = attention.KVCache(
        torch.rand(view.k.shape, generator=g),
        torch.rand(view.v.shape, generator=g),
        torch.arange(view.pos.shape[-1], dtype=torch.int32).expand(
            view.pos.shape).clone())
    sm.scatter(sub, [slot])
    flat = sm.backing.paged[key]
    seg = (4 + 1) * 8
    (block,) = [int(b) for b in
                sm.backing.shards[0].groups[32].pt.table[slot] if b != 4]
    written = set(range(block * 8, block * 8 + 8)) | set(
        range(2 * seg - 8, 2 * seg))
    untouched = [r for r in range(2 * seg) if r not in written]
    assert bool((flat.pos[:, untouched] == -1).all())
    assert bool((flat.k[:, untouched] == 0).all())
    back = sm.gather([slot])[key]["attn"]
    torch.testing.assert_close(back.k[:, :, :8], sub[key]["attn"].k[
        :, :, :8].to(back.k.dtype), rtol=0, atol=0)
    assert bool((back.pos[:, :, 8:] == -1).all())       # trash reads empty


@pytest.mark.parametrize("mesh", [None, 2], ids=["stacked", "cpu_mesh"])
def test_gather_scatter_round_trip(gemma, mesh):
    """A view written back through ``scatter`` reads back through
    ``gather`` at its mapped positions, on slots of both shards and in the
    order asked for; unmapped positions read empty."""
    cfg, _ = gemma
    sm = SlotManager(cfg, 4, 32, paged=True, block_size=8, num_blocks=4,
                     mesh_shards=2, device="cpu",
                     mesh=None if mesh is None else _cpu_mesh(mesh))
    slots = [sm.alloc(0, prompt_len=9, shard=1),
             sm.alloc(1, prompt_len=5, shard=0)]
    assert [sm.shard_of_slot(s) for s in slots] == [1, 0]
    sub = sm.gather(slots)
    key = next(iter(sm.backing.key_view))
    view = sub[key]["attn"]
    g = torch.Generator().manual_seed(1)
    new = attention.KVCache(
        torch.rand(view.k.shape, generator=g).to(view.k.dtype),
        torch.rand(view.v.shape, generator=g).to(view.v.dtype),
        torch.arange(view.pos.shape[-1], dtype=torch.int32).expand(
            view.pos.shape).clone())
    sub[key]["attn"] = new
    sm.scatter(sub, slots)
    back = sm.gather(slots)[key]["attn"]
    for row, mapped in enumerate((16, 8)):      # 9 and 5 tokens: 2, 1 blocks
        torch.testing.assert_close(back.k[:, row, :mapped],
                                   new.k[:, row, :mapped], rtol=0, atol=0)
        assert bool((back.pos[:, row, mapped:] == -1).all())


def test_slot_manager_shard_validation(gemma):
    cfg, _ = gemma
    with pytest.raises(ValueError, match="paged backing"):
        SlotManager(cfg, 4, 32, mesh_shards=2, device="cpu")
    with pytest.raises(ValueError, match="mesh without mesh_shards"):
        SlotManager(cfg, 4, 32, paged=True, mesh=_cpu_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        SlotManager(cfg, 4, 32, paged=True, mesh_shards=3, device="cpu")
    with pytest.raises(ValueError, match="must match the mesh"):
        SlotManager(cfg, 4, 32, paged=True, mesh_shards=2,
                    mesh=_cpu_mesh(4))


# -- the mesh route and the launches of a tick --------------------------------

def test_scheduler_on_a_cpu_mesh_matches_the_stack(gemma):
    """Each shard on its own (CPU) device: greedy streams equal the
    stacked pool's and the unsharded pool's, through swap preemption and
    speculation; score rows come back in input order, bitwise the
    stack's; sampled streams equal the stack's, whose shard s draws from
    the same generator the mesh's device s does."""
    cfg, params = gemma
    prompts = _prompts(cfg.vocab, _LENS)
    mnts = [20, 16, 20, 12, 18, 14]
    for kw in (dict(num_blocks=12), dict(num_blocks=5, preempt="swap"),
               dict(num_blocks=12, speculate=2),
               dict(num_blocks=12, temperature=0.8, top_k=8, seed=3)):
        flat, _ = _run(cfg, params, prompts, mnts,
                       **dict(kw, num_blocks=2 * kw["num_blocks"]))
        stack, ss = _run(cfg, params, prompts, mnts, mesh_shards=2, **kw)
        mesh, sm = _run(cfg, params, prompts, mnts, mesh=_cpu_mesh(2),
                        mesh_shards=2, **kw)
        assert mesh == stack
        if "temperature" not in kw:
            assert [t for t, _ in mesh] == [t for t, _ in flat]
        for k in ("admitted", "preempted", "swapped_out", "steals",
                  "chunk_steps", "decode_steps"):
            assert sm.counters[k] == ss.counters[k], (kw, k)
    score = []
    for mesh in (None, _cpu_mesh(2)):
        s = Scheduler(cfg, params, SchedulerConfig(
            **dict(_BASE, mesh_shards=2, num_blocks=12)), mesh=mesh)
        rids = s.score(_prompts(cfg.vocab, [19, 25, 10]))
        s.drain()
        score.append([s.results[r].logprobs for r in rids])
    for x, y in zip(*score):
        np.testing.assert_array_equal(x, y)


def test_one_sharded_tick_is_one_unsharded_step(gemma, monkeypatch):
    """Without a mesh, n shards tick with ONE model call a decode and a
    chunk step, as the unsharded pool does: no loop over shards."""
    cfg, params = gemma
    calls = []
    real = engine.T.apply_model

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(engine.T, "apply_model", counted)
    prompts = _prompts(cfg.vocab, _LENS)
    per_step = []
    for n in (None, 2, 4):
        calls.clear()
        kw = {} if n is None else dict(mesh_shards=n, num_blocks=24 // n)
        _, s = _run(cfg, params, prompts, _MNTS, **kw)
        steps = s.counters["decode_steps"] + s.counters["chunk_steps"]
        per_step.append(len(calls) / steps)
    assert per_step == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("n,placed", [(2, [5, 1]), (4, [5, 1, 0, 0])])
def test_rwkv_sharded_placements_and_steals(rwkv, n, placed):
    """RWKV has no KV (zero page-table groups): every shard reports the
    same free blocks, so least_blocks places by queue length. Streams
    equal the unsharded run's and the reference's sharded run's;
    placements, steals and control counters equal the reference's."""
    rcfg, tcfg, jparams, tparams = rwkv
    prompts = _prompts(tcfg.vocab, _LENS)
    a, _ = _run(tcfg, tparams, prompts, _MNTS)
    b, sb = _run(tcfg, tparams, prompts, _MNTS, mesh_shards=n)
    c, sc = _drive(JScheduler(rcfg, jparams, JSchedulerConfig(
        **_BASE, mesh_shards=n)), prompts, _MNTS)
    assert a == b == c
    assert sb._shard_placed == sc._shard_placed == placed
    assert sb.counters["steals"] == sc.counters["steals"] == 3
    for k in ("admitted", "preempted", "chunk_steps", "decode_steps",
              "generated_tokens", "prefill_tokens"):
        assert sb.counters[k] == sc.counters[k], k


def test_rwkv_chunk_step_launches_one_scan_a_layer(monkeypatch):
    """rwkv6-1.6b's 24 layers (reduced width): a chunk step over a
    two-shard pool calls ``ssm_scan`` 24 times, as over the unsharded
    pool (on the card each call is one kernel launch)."""
    cfg = dataclasses.replace(TC.reduced_config("rwkv6-1.6b"),
                              num_layers=24, dtype=torch.float32)
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = K.ssm_scan

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(K, "ssm_scan", counted)
    prompts = _prompts(cfg.vocab, [20, 12, 17, 9])
    streams = []
    for kw in (dict(), dict(mesh_shards=2)):
        calls.clear()
        got, s = _run(cfg, params, prompts, [3, 3, 3, 3], **kw)
        assert s.counters["chunk_steps"] >= 2
        assert len(calls) == 24 * s.counters["chunk_steps"]
        streams.append(got)
    assert streams[0] == streams[1]


# -- SwapStore migration ------------------------------------------------------

def test_swap_store_migration_equals_the_reference():
    """migrate_out / migrate_in move an entry between stores without
    counting swap traffic, against the destination's budget; every stats
    key equals the reference store's after the same operations."""
    def entries(kind):
        rng = np.random.default_rng(0)
        out = []
        for n in (3, 5):
            k = rng.normal(size=(2, n * 4, 1, 8)).astype(np.float32)
            pos = np.arange(n * 4, dtype=np.int32)[None].repeat(2, 0)
            dense = {"p0": {"x": rng.normal(size=(2, 1, 8)).astype(
                np.float32)}}
            if kind == "port":
                t = torch.as_tensor
                out.append(SwapEntry(
                    {8: n}, {"p0": attention.KVCache(t(k), t(k), t(pos))},
                    {"p0": {"x": t(dense["p0"]["x"])}}))
            else:
                out.append(JSwapEntry({8: n}, {"p0": JKVCache(k, k, pos)},
                                      dense))
        return out

    stats = []
    for kind, store in (("port", SwapStore), ("ref", JSwapStore)):
        e0, e1 = entries(kind)
        a, b = store(), store(max_bytes=e0.nbytes)
        a.put(0, e0)
        a.put(1, e1)
        assert b.can_hold(a.get(0).nbytes)
        b.migrate_in(0, a.migrate_out(0))
        with pytest.raises(RuntimeError, match="swap budget exceeded"):
            b.migrate_in(1, a.get(1))
        with pytest.raises(ValueError, match="already swapped out"):
            b.migrate_in(0, e0)
        b.pop(0)
        stats.append((a.stats(), b.stats()))
    assert stats[0] == stats[1]
    (a, b), _ = stats
    assert a["swap_migrated_out"] == b["swap_migrated_in"] == 1
    assert a["swap_bytes_in"] == 0 and b["swap_bytes_out"] == 0
