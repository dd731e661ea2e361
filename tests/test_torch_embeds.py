"""The ``embeds`` input mode of the port against the JAX reference, on
the CPU in fp32: reduced ``llava-next-34b`` and ``musicgen-large``, whose
image and audio frontends are stubs that hand the decoder precomputed
embeddings. The same embeddings go through both packages' ``apply_model``
(train, prefill and one decode step, logits at 1e-4, caches to one bf16
ulp), and the port's ``launch.serve`` serves them on the CPU. The JAX side
runs jitted.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.launch import serve as TL
from repro_torch.models import transformer as TT

TOL = dict(rtol=1e-4, atol=1e-4)

_rapply = jax.jit(RT.apply_model, static_argnames=("cfg", "mode",
                                                   "cache_slots"))


def _cfgs(arch):
    return (dataclasses.replace(RC.reduced_config(arch), dtype=jnp.float32),
            dataclasses.replace(TC.reduced_config(arch), dtype=torch.float32))


def _caches_close(got, want):
    """Positions exactly, bf16 k and v within one bf16 ulp with at most 1%
    of the values apart (the fp32 projections differ in the last bits)."""
    gl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.to(torch.float32).numpy(), got))
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w).astype(np.float32)
        assert g.shape == w.shape, path
        mag = np.maximum(np.abs(g), np.abs(w))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), path
        assert np.mean(g != w) <= 0.01, path


@pytest.mark.parametrize("arch", ["llava-next-34b", "musicgen-large"])
def test_embeds_models_match_the_reference_and_serve(arch, capsys):
    rcfg, tcfg = _cfgs(arch)
    assert tcfg.input_mode == "embeds"
    tree = jax.tree_util.tree_map(np.array, RT.init_model(
        jax.random.PRNGKey(7), rcfg))
    assert "embed" not in tree
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tcfg, tree, device="cpu")
    emb = np.random.default_rng(8).normal(size=(2, 20, rcfg.d_model)
                                          ).astype(np.float32)
    for mode in ("train", "prefill"):
        want, _, want_c = _rapply(jparams, cfg=rcfg,
                                         embeds=jnp.asarray(emb), mode=mode,
                                         cache_slots=24)
        got, _, got_c = TT.apply_model(tparams, tcfg,
                                       embeds=torch.as_tensor(emb),
                                       mode=mode, cache_slots=24)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        if mode == "prefill":
            _caches_close(got_c, want_c)
    want, _, _ = _rapply(jparams, cfg=rcfg, embeds=jnp.asarray(emb[:, :1]),
                                mode="decode", caches=want_c,
                                pos_scalar=jnp.asarray(20, jnp.int32))
    got, _, _ = TT.apply_model(tparams, tcfg, embeds=torch.as_tensor(
        emb[:, :1]), mode="decode", caches=got_c, pos_scalar=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    res = TL.run(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                  "2", "--prompt-len", "12", "--gen", "5"])
    assert res["prompts"].shape == (2, 12, tcfg.d_model)
    assert res["prompts"].dtype == torch.bfloat16
    gen = res["generated"]
    assert gen.shape == (2, 5) and bool(((gen >= 0)
                                         & (gen < tcfg.vocab)).all())
    assert "[serve] arch=" in capsys.readouterr().out
    # the same seed gives the same run
    again = TL.run(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "12", "--gen", "5"])
    assert torch.equal(again["generated"], gen)
    assert TL.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "4", "--gen", "2"]) == 0
