"""The port's train step against the JAX reference's on the CPU, in fp32,
for the other five configs' ``reduced_config``: the MoE, Mamba, hybrid and
embeds ones (test_torch_train_step.py has the method and tolerances: the
loss, the aux loss and the gradient norm at rtol 1e-5, every gradient
within 1e-4 of its leaf's largest |g|)."""

import pytest

from test_torch_train_step import step_parity

ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
         "llava-next-34b", "musicgen-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_reference(arch):
    step_parity(arch, 10 + ARCHS.index(arch))
