"""``repro_torch.launch.op_analysis``, the op-level cost walk, at reduced
configs and 2 x 64 tokens on the CPU: its FLOPs are
``FlopCounterMode``'s exactly (prefill, decode, train); on meta it walks
what the CPU walks (FLOPs, bytes, memory) when the kernels are off; its
prefill FLOPs are the reference's HLO walk (``repro.launch.hlo_analysis``
over the jitted reference prefill), exactly, but for RWKV, whose reference
prefill runs the chunked WKV (``core/linear_attn.wkv_chunked``) as matrix
products where the port's scan is elementwise; and with the kernels on, the
meta branches charge ``kernels.work`` once per launch and run no plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as RC
from repro.launch import hlo_analysis
from repro.launch import specs as ref_specs
from repro.serve import engine as ref_engine
from repro_torch import configs as TC
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import ssm_scan as KS
from repro_torch.kernels import work
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import specs
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamWConfig
from repro_torch.serve import engine
from repro_torch.train import step as TS

B, S = 2, 64
ARCHS = ("gemma-2b", "olmoe-1b-7b", "rwkv6-1.6b", "jamba-v0.1-52b",
         "musicgen-large")
# the reference's HLO walk of its jitted prefill (reduced, 2 x 64 tokens)
REF_PREFILL_FLOPS = {"gemma-2b": 31_490_048, "olmoe-1b-7b": 36_470_784,
                     "rwkv6-1.6b": 30_474_240}


def _batch(cfg, dev, seed=0):
    """A (B, S) train batch: random tokens and labels (or embeddings) on
    the CPU from numpy, empty stand-ins on meta."""
    out = specs.input_specs(cfg, ShapeConfig("t", "train", S, B),
                            dev)["batch"]
    if dev == "meta":
        return out
    rng = np.random.default_rng(seed)
    return {k: (torch.as_tensor(rng.integers(0, cfg.vocab, v.shape)
                                .astype(np.int32)) if not
                v.is_floating_point() else
                torch.as_tensor(rng.normal(size=v.shape).astype(np.float32))
                .to(v.dtype)) for k, v in out.items()}


def _model(cfg, dev):
    g = torch.Generator().manual_seed(0) if dev == "cpu" else None
    return TT.init_model(cfg, g, dev)


def _call(kind, arch, dev, use_kernels=True):
    """(fn, args) of one reduced call: the prefill step, a decode step over
    the prefill's caches' layout, or the train step (the loss and its
    gradients when the kernels are off: the step itself always runs
    them)."""
    cfg = TC.reduced_config(arch)
    batch = _batch(cfg, dev)
    if kind == "prefill":
        fn = engine.make_prefill_step(cfg, S, use_kernels=use_kernels)
        return fn, (_model(cfg, dev), {k: v for k, v in batch.items()
                                       if k != "labels"})
    if kind == "decode":
        ins = specs.input_specs(cfg, ShapeConfig("d", "decode", S, B), dev)
        inp = {k: v[:, :1] for k, v in batch.items() if k != "labels"}
        pos = torch.tensor(S // 2, dtype=torch.int32, device=dev)
        return engine.make_decode_step(cfg), (_model(cfg, dev),
                                              ins["caches"], inp, pos)
    g = torch.Generator().manual_seed(0) if dev == "cpu" else None
    state = TS.init_train_state(cfg, g, device=dev)
    if use_kernels:
        return TS.make_train_step(cfg, AdamWConfig()), (state, batch)
    return (lambda st, bt: TS.loss_and_grads(st.params, cfg, bt,
                                             use_kernels=False),
            (state, batch))


def _walk(kind, arch, dev, use_kernels=True) -> OA.ModuleCost:
    fn, args = _call(kind, arch, dev, use_kernels)
    return OA.analyze(fn, *args)


def _flop_counter(fn, args) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn(*args)
    return mode.get_total_flops()


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_walk_flops_are_flop_counter_mode_s(arch, kind):
    fn, args = _call(kind, arch, "cpu")
    cost = OA.analyze(fn, *args)
    assert cost.aten_flops == _flop_counter(fn, args) > 0
    assert cost.kernels == {}                 # the CPU runs no kernel
    assert cost.flops == cost.aten_flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_walk_is_the_cpu_walk_with_the_kernels_off(arch, kind):
    cpu = _walk(kind, arch, "cpu", use_kernels=False)
    meta = _walk(kind, arch, "meta", use_kernels=False)
    assert (meta.flops, meta.bytes) == (cpu.flops, cpu.bytes)
    assert meta.memory_analysis() == cpu.memory_analysis()
    assert meta.kernels == cpu.kernels == {}


def _wkv_chunked_dot_flops(cfg, b, s) -> int:
    """The matrix products of the reference's chunked WKV
    (``wkv_chunked``, 'tape' variant, u=None) over all RWKV layers: per
    row-head and chunk of C steps, the intra-chunk scores (C x C x dk), the
    intra readout (C x dv x C), the chunk summary (dk x dv x C) and the
    inter readout (C x dv x dk), each 2 FLOP a multiply-add."""
    hd, c = cfg.rwkv_head_dim, cfg.scan_chunk
    rows = b * cfg.d_model // hd
    nc = -(-s // c)
    per_layer = 2 * rows * nc * c * (c * hd + c * hd + hd * hd + hd * hd)
    return per_layer * sum(spec.mixer == "rwkv"
                           for spec in cfg.layer_specs())


@pytest.mark.parametrize("arch", sorted(REF_PREFILL_FLOPS))
def test_prefill_flops_against_the_reference_hlo_walk(arch):
    rcfg = RC.reduced_config(arch)
    fn = ref_engine.make_prefill_step(rcfg, cache_slots=S)
    params = ref_specs.params_specs(rcfg)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    hlo = jax.jit(fn).lower(params, batch).compile().as_text()
    ref_flops = hlo_analysis.analyze(hlo).flops
    assert ref_flops == REF_PREFILL_FLOPS[arch]

    tfn, args = _call("prefill", arch, "cpu")
    cost = OA.analyze(tfn, *args)
    assert cost.aten_flops == _flop_counter(tfn, args)
    gap = ref_flops - cost.aten_flops
    if arch == "rwkv6-1.6b":
        # the reference's chunked WKV runs as matrix products; the port's
        # ssm_scan (kernel and plain version alike) is elementwise
        assert gap == _wkv_chunked_dot_flops(TC.reduced_config(arch), B, S) \
            == 5_242_880
    else:
        assert gap == 0


def _patch_plain_to_raise(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a plain version ran under the meta branch")
    for mod, names in ((KF, ("flash_attention_plain",
                             "flash_attention_fwd_plain",
                             "flash_attention_bwd_plain")),
                       (KS, ("ssm_scan_plain", "ssm_scan_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)


def _layers(cfg, mixer) -> int:
    return sum(spec.mixer == mixer for spec in cfg.layer_specs())


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_meta_branch_charges_work_once_a_launch_and_runs_no_plain(
        arch, monkeypatch):
    _patch_plain_to_raise(monkeypatch)
    cfg = TC.reduced_config(arch)
    n_attn, n_rwkv = _layers(cfg, "attn"), _layers(cfg, "rwkv")
    hd, el = cfg.head_dim, torch.tensor([], dtype=cfg.dtype).element_size()
    flash = work.flash_attention(B, cfg.num_heads, cfg.num_kv_heads, S, S,
                                 hd, 0, el)
    rows, rhd = B * cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    scan = work.ssm_scan(rows, S, rhd, rhd)

    def want(w, calls):
        return {"calls": calls, "flops": calls * w.flops,
                "bytes": calls * w.bytes}

    prefill = _walk("prefill", arch, "meta")
    expect = {}
    if n_attn:
        expect["flash_attention"] = want(flash, n_attn)
    if n_rwkv:
        expect["ssm_scan"] = want(scan, n_rwkv)
    assert prefill.kernels == expect

    # train, remat: 2 forward launches (forward, recompute) and 1 backward
    # a layer, the forward with lse
    train = _walk("train", arch, "meta")
    expect = {}
    if n_attn:
        expect["flash_attention"] = want(
            work.flash_attention(
                B, cfg.num_heads, cfg.num_kv_heads, S, S, hd, 0, el,
                with_lse=True), 2 * n_attn)
        expect["flash_attention_bwd"] = want(
            work.flash_attention_bwd(
                B, cfg.num_heads, cfg.num_kv_heads, S, S, hd, 0, el),
            n_attn)
    if n_rwkv:
        expect["ssm_scan"] = want(scan, 2 * n_rwkv)
        expect["ssm_scan_bwd"] = want(work.ssm_scan_bwd(rows, S, rhd, rhd),
                                      n_rwkv)
    assert cfg.remat and train.kernels == expect


def test_cpu_walk_counts_the_plain_versions_where_meta_charges_kernels():
    """With the kernels on, the CPU runs the plain versions: the walk
    counts their ops (the whole S x S score matrix, twice: q.k and p.v)
    where meta charges the kernel's causal work."""
    arch = "gemma-2b"
    cfg = TC.reduced_config(arch)
    cpu = _walk("prefill", arch, "cpu")
    meta = _walk("prefill", arch, "meta")
    plain = 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim
    assert cpu.aten_flops - meta.aten_flops == 2 * plain
    assert cpu.kernels == {} and meta.kernels["flash_attention"]["calls"] == 2
    assert meta.kernels["flash_attention"]["flops"] < 2 * plain


def test_kernel_branches_charge_only_inside_a_walk():
    q = torch.empty((1, 4, 32, 16), device="meta")
    k = torch.empty((1, 2, 32, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        KF.flash_attention(q, k, k)
    with OA.OpWalk() as walk:
        out = KF.flash_attention(q, k, k, 8)
    assert out.shape == q.shape and out.device.type == "meta"
    w = work.flash_attention(1, 4, 2, 32, 32, 16, 8, 4)
    assert walk.kernels == {"flash_attention": [1, w.flops, w.bytes]}
    assert not work.active()
    r = torch.empty((3, 10, 8), device="meta")
    with OA.OpWalk() as walk:
        y, s = KS.ssm_scan(r, r, r, r)
    assert (tuple(y.shape), tuple(s.shape)) == ((3, 10, 8), (3, 8, 8))
    assert walk.kernels["ssm_scan"][1:] == list(work.ssm_scan(3, 10, 8, 8))


def test_walk_memory_and_top_bytes():
    """The peak holds what a call makes and keeps at once, views are free,
    and the top byte contributors are sorted, the kernels among them."""
    x = torch.empty((256, 256), device="meta")

    def f(x):
        a = x * 2                   # 256 KiB made
        b = a.t()                   # a view: free
        c = b @ x                   # 256 KiB made, a and c live at once
        del a, b
        return c.sum()

    cost = OA.analyze(f, x)
    n = 256 * 256 * 4
    assert cost.memory_analysis() == {"temp_size_in_bytes": 2 * n,
                                      "argument_size_in_bytes": n,
                                      "output_size_in_bytes": 4}
    assert cost.aten_flops == 2 * 256 **3
    assert cost.aten_bytes == (n + n) + (2 * n + n) + (n + 4)
    # a batched x @ w is one mm between free reshapes (the last an
    # _unsafe_view, which shares the mm's storage without a view's schema)
    x3 = torch.empty((2, 128, 256), device="meta")
    cost = OA.analyze(lambda a: a @ x, x3)
    assert cost.aten_bytes == (2 * 128 * 256 + 256 * 256) * 4 + \
        2 * 128 * 256 * 4
    assert cost.aten_flops == 2 * (2 * 128) * 256 * 256
    meta = _walk("prefill", "gemma-2b", "meta")
    top = meta.top_bytes(5)
    assert len(top) == 5 and [b for _, b in top] == sorted(
        (b for _, b in top), reverse=True)
    every = meta.top_bytes(10_000)
    assert sum(b for _, b in every) == meta.bytes
    assert any(d.startswith("kernel flash_attention") for d, _ in every)
