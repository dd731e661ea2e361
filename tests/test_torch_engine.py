"""The port's serving engine and launcher (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) against the JAX reference on the CPU.

Sampling filters and greedy sampling are exact, ties included. Greedy
streams of ``generate`` and of the launcher are token for token the
reference's, on the reduced RWKV6 config in fp32 with the same weights
(the port's sequential WKV scan and the reference's chunked one agree to
about 1e-6 there, far from any argmax tie in these draws). Sampling at a
temperature draws from a ``torch.Generator``, whose stream is not JAX's, so
it is checked for its own properties only.
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
from repro_torch.kernels import ssm_scan as TK
from repro_torch.launch import serve as TLS
from repro_torch.serve import engine as TE

ARCH = "rwkv6-1.6b"


def _tied_logits(b=6, v=40, seed=0):
    """Logits on a coarse grid, so that ties (at the argmax too) abound."""
    rng = np.random.default_rng(seed)
    lg = (np.round(rng.normal(size=(b, v)) * 2) / 2).astype(np.float32)
    lg[0, [3, 17]] = lg[0].max() + 1.0            # tie at the top
    return lg


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (1, 1.0), (5, 1.0),
                                         (0, 0.3), (7, 0.6), (40, 0.999),
                                         (3, 0.05)])
def test_filter_topk_topp_is_exact(top_k, top_p):
    lg = _tied_logits()
    b = lg.shape[0]
    ks = np.full((b,), top_k, np.int32)
    ks[1] = 0                                     # per-row knobs
    ps = np.full((b,), top_p, np.float32)
    ps[2] = 1.0
    want = RE._filter_topk_topp(jnp.asarray(lg), jnp.asarray(ks),
                                jnp.asarray(ps))
    got = TE._filter_topk_topp(torch.as_tensor(lg), torch.as_tensor(ks),
                               torch.as_tensor(ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_sample_token_is_exact_with_ties(seed):
    lg = _tied_logits(seed=seed)[:, None, :]
    want = np.asarray(RE.sample_token(jnp.asarray(lg)))
    got = TE.sample_token(torch.as_tensor(lg)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 3 if seed == 0 else True     # first of the tied maxima
    # per-slot vectors with every temperature 0 are greedy too
    b = lg.shape[0]
    got = TE.sample_token(torch.as_tensor(lg), torch.Generator(),
                          torch.zeros(b), torch.full((b,), 3),
                          torch.full((b,), 0.5)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_at_a_temperature_respects_the_filters():
    lg = torch.as_tensor(_tied_logits(b=64, seed=4))[:, None, :]
    g = torch.Generator().manual_seed(0)
    untied = torch.randn((64, 1, 40), generator=g)
    tok = TE.sample_token(untied, g, 1.0, top_k=1)
    assert torch.equal(tok, TE.sample_token(untied))  # top-1 is greedy
    a = TE.sample_token(lg, torch.Generator().manual_seed(5), 0.7, 5, 0.9)
    b = TE.sample_token(lg, torch.Generator().manual_seed(5), 0.7, 5, 0.9)
    assert torch.equal(a, b)
    kept = TE._filter_topk_topp(lg[:, 0], torch.full((64,), 5),
                                torch.full((64,), 0.9))
    assert bool(torch.isfinite(kept.gather(1, a[:, None])).all())
    temps = torch.tensor([0.0, 1.0] * 32)
    mixed = TE.sample_token(lg, torch.Generator().manual_seed(1), temps)
    assert torch.equal(mixed[::2], TE.sample_token(lg)[::2])
    with pytest.raises(ValueError):
        TE.SamplingPolicy(temperature=-1.0)
    with pytest.raises(ValueError):
        TE.SamplingPolicy(top_p=0.0)
    assert TE.SamplingPolicy().greedy and TE.SamplingPolicy(
        0.5, 3, 0.9).fingerprint() == RE.SamplingPolicy(0.5, 3,
                                                        0.9).fingerprint()


@pytest.fixture(scope="module")
def weights():
    rcfg = dataclasses.replace(RC.reduced_config(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.reduced_config(ARCH), dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.array, RT.init_model(jax.random.PRNGKey(5), rcfg))
    rng = np.random.default_rng(5)
    for blk in tree["blocks"].values():     # decays on both sides of e^-1
        blk["rwkv"]["w_lora_a"] = (0.5 * rng.normal(
            size=blk["rwkv"]["w_lora_a"].shape)).astype(np.float32)
        blk["rwkv"]["w_lora_b"] = (0.3 * rng.normal(
            size=blk["rwkv"]["w_lora_b"].shape)).astype(np.float32)
    return (rcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tcfg, tree, device="cpu"))


def test_generate_is_token_identical_to_the_reference(weights):
    rcfg, tcfg, jparams, tparams = weights
    rng = np.random.default_rng(6)
    before = TK.launches
    for ln in (5, 19, 26):                  # ragged: 0, 2 and 3 full chunks
        prompt = rng.integers(0, rcfg.vocab, ln).astype(np.int32)
        want, wr = RE.generate(jparams, rcfg, prompt, 10, prefill_chunk=8)
        got, gr = TE.generate(tparams, tcfg, prompt, 10, prefill_chunk=8)
        assert got.dtype == np.int32 and got.shape == (10,)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert gr == wr == "length"
    eos = int(got[3])
    got, reason = TE.generate(tparams, tcfg, prompt, 10, prefill_chunk=8,
                              eos_token=eos)
    assert reason == "eos" and got[-1] == eos and len(got) <= 4
    assert TK.launches == before            # CPU: no kernel launch


def test_chunk_step_equals_decode_steps(weights):
    """A chunk through make_chunk_step leaves the state that stepping the
    same tokens one at a time leaves (to fp32 reassociation)."""
    _, tcfg, _, tparams = weights
    from repro_torch.models import transformer as TT
    toks = torch.randint(0, tcfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    c0 = TT.init_caches(tcfg, 2, 16, per_slot_pos=True, device="cpu")
    chunk_logits, c_chunk = TE.make_chunk_step(tcfg)(tparams, c0, toks,
                                                     torch.zeros(2))
    dec = TE.make_slot_decode_step(tcfg)
    c = c0
    for t in range(9):
        _, lg, c = dec(tparams, c, toks[:, t:t + 1], torch.full((2,), t),
                       torch.zeros(2), None)
        torch.testing.assert_close(lg[:, 0], chunk_logits[:, t], rtol=1e-4,
                                   atol=1e-4)
    for key in ("s", "x_prev"):
        torch.testing.assert_close(c["p0"]["rwkv"][key],
                                   c_chunk["p0"]["rwkv"][key], rtol=1e-4,
                                   atol=1e-4)


def test_launch_serve_on_cpu_matches_the_reference_stream(capsys,
                                                         monkeypatch):
    reduced = TC.reduced_config       # the launcher's config, in fp32
    monkeypatch.setattr(TLS.configs, "reduced_config", lambda name:
                        dataclasses.replace(reduced(name),
                                            dtype=torch.float32))
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "3",
            "--prompt-len", "12", "--gen", "6", "--seed", "3"]
    before = TK.launches
    assert TLS.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve] prefill:" in out and "[serve] decode:" in out
    assert TK.launches == before

    res = TLS.run(argv)
    gen = res["generated"].numpy()
    assert gen.shape == (3, 6)
    for row in range(3):
        assert f"[serve] row {row}: {gen[row].tolist()}" in out

    # the reference's prefill + decode loop on the same weights and prompts
    tcfg = res["cfg"]
    rcfg = dataclasses.replace(RC.reduced_config(ARCH), dtype=jnp.float32)
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
                               rtol=1e-4, atol=1e-4)


def test_launch_serve_default_device_is_the_card():
    if torch.cuda.is_available():
        assert TLS.parse_args([]).device is None
        return
    with pytest.raises(RuntimeError, match="cuda"):
        TLS.main(["--batch", "1", "--prompt-len", "4", "--gen", "2"])
