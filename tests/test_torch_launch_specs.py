"""``repro_torch.launch.specs`` against ``repro.launch.specs``: the port's
meta stand-ins (inputs, caches, parameters, the train state) hold the
reference's ``jax.eval_shape`` specs leaf by leaf, shape and dtype by name,
through ``convert.reference_layout`` where the layouts differ."""

import jax
import pytest
import torch

from repro import configs as RC
from repro.launch import specs as ref_specs
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.launch import specs
from repro_torch.models import transformer as TT


def _leaves(tree) -> dict:
    """{path: (shape, dtype name)} of a tree of torch tensors or of JAX
    ShapeDtypeStructs (dicts and NamedTuples alike by path)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path):
            (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in flat}


def _unflatten(named: dict) -> TT.Model:
    """A ``Model`` from {parameter name: tensor} (a ``named_parameters``
    dict, such as AdamW's ``mu``)."""
    tree: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        node = tree
        if parts[0] == "layers":
            node = tree.setdefault("layers", {}).setdefault(int(parts[1]), {})
            parts = parts[2:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    tree["layers"] = [tree["layers"][i] for i in sorted(tree["layers"])]
    return TT.Model(tree)


@pytest.mark.parametrize("shape_name", list(RC.SHAPES))
@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_input_and_cache_specs_match_the_reference(arch, shape_name):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    want = ref_specs.input_specs(rcfg, RC.SHAPES[shape_name])
    got = specs.input_specs(tcfg, TC.SHAPES[shape_name])
    assert _leaves(got) == _leaves(want)
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(got))


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_params_specs_match_the_reference(arch):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    want = ref_specs.params_specs(rcfg)
    model = specs.params_specs(tcfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert _leaves(convert.reference_layout(tcfg, model)) == _leaves(want)


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_train_state_specs_match_the_reference(arch):
    rcfg, tcfg = RC.reduced_config(arch), TC.reduced_config(arch)
    want = ref_specs.train_state_specs(rcfg)
    state = specs.train_state_specs(tcfg)
    assert all(p.requires_grad for p in state.params.parameters())
    assert _leaves(convert.reference_layout(tcfg, state.params)) == \
        _leaves(want.params)
    for part in ("mu", "nu"):
        moments = _unflatten(state.opt[part])
        assert _leaves(convert.reference_layout(tcfg, moments)) == \
            _leaves(want.opt[part])
    for got, ref in ((state.opt["count"], want.opt["count"]),
                     (state.step, want.step)):
        assert _leaves(got) == _leaves(ref)
        assert got.device.type == "meta"
    assert state.ef is None and want.ef is None


def test_specs_allocate_nothing():
    """The full gemma-2b's 2.5 B parameters and a 32k-token cache live on
    meta: no storage holds data."""
    cfg = TC.get_config("gemma-2b")
    state = specs.train_state_specs(cfg)
    ins = specs.input_specs(cfg, TC.SHAPES["decode_32k"])
    tensors = (list(state.params.parameters())
               + list(state.opt["mu"].values())
               + jax.tree_util.tree_leaves(ins))
    assert all(t.device == torch.device("meta") for t in tensors)
    assert TT.param_count(state.params) == 2_506_172_416
