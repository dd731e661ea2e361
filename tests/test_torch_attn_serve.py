"""Serving the port's attention LMs on the CPU: the chunk/decode seam, the
launcher's streams (greedy against the reference, and sampling at a
temperature, where the port diverges from the reference on purpose),
gemma3's sliding window over a prompt longer than the window, and the
full-width gemma-2b on the ``meta`` device.

The seam. A chunk attends over the cache as it was before the chunk,
rounded to bf16, plus the chunk's own k and v; a decode step attends over
the cache after its write, where the chunk's earlier tokens are rounded
too. In a bf16 model that rounding is exact, and chunk logits equal the
same tokens stepped one at a time to 1e-5 (the reference's seam test runs
this bf16 config and finds them bit for bit equal; in the port they are not
bitwise, as the chunk's kv axis is longer and sums in another order). In
an fp32 model the chunk sees its own k and v unrounded, in the reference
and in the port alike, and the two paths differ by a bf16 rounding (about
1e-3 here): there the port's chunk and step logits are each held to the
reference's at 1e-5, and so is the gap between them.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import flash_attention as KF
from repro_torch.launch import serve as TLS
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE

TOL = dict(rtol=1e-5, atol=1e-4)


def _weights(arch, dtype, seed=0):
    rcfg = dataclasses.replace(RC.reduced_config(arch),
                               dtype=jnp.dtype(dtype))
    tcfg = dataclasses.replace(TC.reduced_config(arch),
                               dtype=getattr(torch, dtype))
    tree = jax.tree_util.tree_map(
        np.array, RT.init_model(jax.random.PRNGKey(seed), rcfg))
    return (rcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tcfg, tree, device="cpu"))


def _port_chunk_and_steps(tcfg, params, toks, pre, hi):
    """Logits of toks[pre:hi] as one chunk and as one-token steps, both
    after a chunk over toks[:pre]."""
    chunk = TE.make_chunk_step(tcfg)
    step = TE.make_slot_decode_step(tcfg)
    c = TT.init_caches(tcfg, 1, 32, per_slot_pos=True, device="cpu")
    _, c = chunk(params, c, torch.as_tensor(toks[:, :pre]),
                 torch.zeros(1, dtype=torch.int64))
    lg, _ = chunk(params, c, torch.as_tensor(toks[:, pre:hi]),
                  torch.full((1,), pre))
    steps = []
    for t in range(pre, hi):
        _, l1, c = step(params, c, torch.as_tensor(toks[:, t:t + 1]),
                        torch.full((1,), t), torch.zeros(1), None)
        steps.append(l1[0, 0])
    return lg[0].to(torch.float32), torch.stack(steps).to(torch.float32)


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-12b"])
def test_chunk_equals_stepwise_decode_in_bf16(arch):
    _, tcfg, _, params = _weights(arch, "bfloat16")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (1, 30))
    chunk, steps = _port_chunk_and_steps(tcfg, params, toks, 12, 21)
    torch.testing.assert_close(chunk, steps, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-12b"])
def test_fp32_seam_is_the_reference_seam(arch):
    rcfg, tcfg, jparams, tparams = _weights(arch, "float32")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (1, 30))
    chunk, steps = (x.numpy() for x in
                    _port_chunk_and_steps(tcfg, tparams, toks, 12, 21))

    rchunk = jax.jit(RE.make_chunk_step(rcfg))
    rstep = jax.jit(RE.make_slot_decode_step(rcfg))
    c = RT.init_caches(rcfg, 1, 32, per_slot_pos=True)
    _, c = rchunk(jparams, c, jnp.asarray(toks[:, :12]),
                  jnp.zeros(1, jnp.int32))
    want_chunk, _ = rchunk(jparams, c, jnp.asarray(toks[:, 12:21]),
                           jnp.full((1,), 12, jnp.int32))
    want_steps = []
    for t in range(12, 21):
        _, l1, c = rstep(jparams, c, jnp.asarray(toks[:, t:t + 1]),
                         jnp.full((1,), t, jnp.int32), jnp.zeros(1),
                         jax.random.PRNGKey(0))
        want_steps.append(np.asarray(l1[0, 0]))
    want_chunk, want_steps = np.asarray(want_chunk[0]), np.stack(want_steps)
    np.testing.assert_allclose(chunk, want_chunk, **TOL)
    np.testing.assert_allclose(steps, want_steps, **TOL)
    np.testing.assert_allclose(chunk - steps, want_chunk - want_steps,
                               rtol=0, atol=1e-5)
    assert np.abs(want_chunk - want_steps).max() > 1e-4   # the rounding


def test_gemma3_window_over_a_longer_prompt():
    """40 tokens through windows of 16: the reference takes
    banded_attention, the port the kernel's function (plain on the CPU)
    or, without kernels, its own banded_attention."""
    rcfg, tcfg, jparams, tparams = _weights("gemma3-12b", "float32", seed=2)
    assert rcfg.pattern[0].window == 16
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 40))
    want, _, jc = RT.apply_model(jparams, rcfg, tokens=jnp.asarray(toks),
                                 mode="prefill", cache_slots=48)
    for use in (True, False):
        got, _, tc = TT.apply_model(tparams, tcfg,
                                    tokens=torch.as_tensor(toks),
                                    mode="prefill", cache_slots=48,
                                    use_kernels=use)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tuple(tc["p0"]["attn"].k.shape) == (1, 2, 16, 2, 32)
        np.testing.assert_array_equal(tc["p0"]["attn"].pos.numpy(),
                                      np.asarray(jc["p0"]["attn"].pos))


def _fp32_launcher(monkeypatch):
    reduced = TC.reduced_config       # the launcher's config, in fp32
    monkeypatch.setattr(TLS.configs, "reduced_config", lambda name:
                        dataclasses.replace(reduced(name),
                                            dtype=torch.float32))


ARGV = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--batch", "3",
        "--prompt-len", "12", "--gen", "6", "--seed", "3"]


def test_launch_serve_gemma_on_cpu_matches_the_reference_stream(
        capsys, monkeypatch):
    _fp32_launcher(monkeypatch)
    before = KF.launches
    assert TLS.main(ARGV) == 0
    out = capsys.readouterr().out
    assert "arch=gemma-2b-smoke" in out and "[serve] decode:" in out
    res = TLS.run(ARGV)
    assert KF.launches == before
    gen = res["generated"].numpy()
    assert gen.shape == (3, 6)
    for row in range(3):
        assert f"[serve] row {row}: {gen[row].tolist()}" in out

    # the reference's prefill + decode loop on the same weights and prompts
    tcfg = res["cfg"]
    rcfg = dataclasses.replace(RC.reduced_config("gemma-2b"),
                               dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_numpy(tcfg, res["params"]))
    prompts = jnp.asarray(res["prompts"].numpy().astype(np.int32))
    prefill = jax.jit(RE.make_prefill_step(rcfg, cache_slots=18))
    decode = jax.jit(RE.make_decode_step(rcfg, 0.0))
    logits, caches = prefill(jparams, {"tokens": prompts})
    tok = RE.sample_token(logits)
    want = [tok]
    for i in range(5):
        tok, logits, caches = decode(jparams, caches, {"tokens": tok[:, None]},
                                     jnp.asarray(12 + i, jnp.int32))
        want.append(tok)
    np.testing.assert_array_equal(gen, np.asarray(jnp.stack(want, 1)))
    np.testing.assert_allclose(res["logits"].numpy(), np.asarray(logits),
                               **TOL)


def test_launch_serve_temperature_samples_in_the_port(monkeypatch):
    """The reference's launcher passes no key to its decode step, so its
    --temperature changes nothing (it stays greedy); the port samples
    from a torch.Generator seeded from --seed. At temperature 0 the
    streams are the reference's greedy ones (test above)."""
    _fp32_launcher(monkeypatch)
    greedy = TLS.run(ARGV)["generated"]
    hot = [TLS.run(ARGV + ["--temperature", "1.0"])["generated"]
           for _ in range(2)]
    assert torch.equal(hot[0], hot[1])            # the seed fixes the stream
    assert not torch.equal(hot[0], greedy)
    assert torch.equal(hot[0][:, 0], greedy[:, 0])  # prefill's token: greedy


def test_full_width_gemma_init_on_meta_has_the_reference_shapes():
    rcfg, tcfg = RC.get_config("gemma-2b"), TC.get_config("gemma-2b")
    model = TT.init_model(tcfg, device="meta")
    want = jax.eval_shape(lambda k: RT.init_model(k, rcfg),
                          jax.random.PRNGKey(0))
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                 convert.reference_layout(tcfg, model))
    assert got == jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
    assert TT.param_count(model) == RT.param_count(want) == 2_506_172_416
    caches = TT.init_caches(tcfg, 4, 2080, device="meta")
    assert tuple(caches["p0"]["attn"].k.shape) == (18, 4, 2080, 1, 256)
    assert caches["p0"]["attn"].k.dtype == torch.bfloat16
