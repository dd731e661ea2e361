"""CUDA arms of the port's kernel tests: each hand-written kernel against
its plain PyTorch version on the card. Imports no JAX, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a card every test here skips with its reason.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import align as TA
from repro_torch.core import wavefront as TWF
from repro_torch.kernels import chain_scan as KC
from repro_torch.kernels import dtw_wavefront as KT
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _masked_scores(n, t, seed):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(n, t)).astype(np.float32)
    scores[rng.random((n, t)) < 0.5] = -1e18
    for i in range(min(n, t)):
        scores[i, i:] = -1e18
    return scores


@pytest.mark.parametrize("n,t", [(1000, 64), (777, 128), (300, 17)])
def test_chain_scan_kernel_exact(cuda, n, t):
    scores = torch.as_tensor(_masked_scores(n, t, n))
    w = torch.full((n,), 15.0)
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    before = KC.launches
    f, off = KC.chain_scan(scores.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert KC.launches == before + 1
    assert torch.equal(off.cpu(), off_ref)
    assert torch.equal(f.cpu(), f_ref)


def test_chain_scan_kernel_batched_and_ties(cuda):
    scores = torch.as_tensor(np.stack([_masked_scores(200, 64, s)
                                       for s in range(3)]))
    scores[1] = 1.0                                    # all candidates tie
    w = torch.full((3, 200), 0.5)
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    f, off = KC.chain_scan(scores.to(cuda), w.to(cuda))
    assert torch.equal(off.cpu(), off_ref) and torch.equal(f.cpu(), f_ref)


def test_chain_scan_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="band"):
        KC.chain_scan(torch.zeros(10, 129, device=cuda),
                      torch.zeros(10, device=cuda))
    with pytest.raises(TypeError):
        KC.chain_scan(torch.zeros(10, 8, device=cuda, dtype=torch.float64),
                      torch.zeros(10, device=cuda))


def _sw_inputs(lead, tr, tc, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 30, lead + (tc,)),
                            dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 30, lead + (tr,)),
                            dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 30, lead), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 4, lead + (tr,)),
                            dtype=torch.int32),
            torch.as_tensor(rng.integers(0, 4, lead + (tc,)),
                            dtype=torch.int32))


@pytest.mark.parametrize("lead", [(), (5,)])
@pytest.mark.parametrize("tr,tc", [(64, 64), (128, 128), (32, 16)])
def test_sw_tile_kernel_exact(cuda, lead, tr, tc):
    ins = _sw_inputs(lead, tr, tc, tr + tc + len(lead))
    want = KT.dp_tile_plain(*ins, kind="sw")
    got = KT.dp_tile(*(x.to(cuda) for x in ins), kind="sw")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("tr,tc", [(64, 64), (32, 16)])
def test_dtw_tile_kernel_close(cuda, tr, tc):
    g = torch.Generator().manual_seed(tr * tc)
    ins = (torch.randn(tc, generator=g), torch.randn(tr, generator=g),
           torch.randn((), generator=g), torch.randn(tr, generator=g),
           torch.randn(tc, generator=g))
    want = KT.dp_tile_plain(*ins, kind="dtw")
    got = KT.dp_tile(*(x.to(cuda) for x in ins), kind="dtw")
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w, rtol=1e-5, atol=1e-4)


def test_sw_tiled_on_the_card_exact(cuda):
    rng = np.random.default_rng(1)
    b = rng.integers(0, 4, 300).astype(np.int32)
    a = b[20:250].copy()
    a[rng.random(230) < 0.1] = 3
    want = TA.sw_ref(torch.as_tensor(a), torch.as_tensor(b))
    before = KT.launches
    mat, best = ops.sw_tiled(torch.as_tensor(a, device=cuda),
                             torch.as_tensor(b, device=cuda),
                             tile_r=64, tile_c=64)
    assert KT.launches - before == 4 * 5
    assert torch.equal(mat.cpu(), want)
    assert float(best) == float(want.max())


def test_wavefront_batched_on_the_card(cuda):
    a = torch.randint(0, 4, (3, 64), dtype=torch.int32)
    b = torch.randint(0, 4, (3, 128), dtype=torch.int32)
    z = torch.zeros
    fn = ops.make_sw_tile_fn()
    want = TWF.run_wavefront_batched(fn, a, b, z(3, 128), z(3, 64), z(3),
                                     32, 32)
    got = TWF.run_wavefront_batched(fn, a.to(cuda), b.to(cuda),
                                    z(3, 128, device=cuda),
                                    z(3, 64, device=cuda), z(3, device=cuda),
                                    32, 32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
