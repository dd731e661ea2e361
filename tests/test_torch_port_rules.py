"""Rules of the PyTorch port: it imports neither JAX nor the reference
package, runs on the card unless told otherwise, launches no kernel for CPU
tensors, and keeps exact copies of the reference's numpy-only modules."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import genomics as ref_genomics
from repro.runtime import bucketing as ref_bucketing
from repro_torch import resolve_device
from repro_torch.apps.read_mapper import MapperConfig, ReadMapper
from repro_torch.data import genomics
from repro_torch.kernels import chain_scan as k_chain
from repro_torch.kernels import dtw_wavefront as k_tile
from repro_torch.kernels import ops
from repro_torch.runtime import bucketing

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_read_mapper_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.apps.read_mapper
        import repro_torch.kernels.ops
        import repro_torch.convert
        import repro_torch.obs
        from repro_torch.runtime import KernelService
        import repro_torch.models.transformer
        import repro_torch.models.attention
        import repro_torch.kernels.flash_attention
        import repro_torch.serve.engine
        import repro_torch.launch.serve
        print("IMPORT_OK")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "IMPORT_OK" in res.stdout


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        ReadMapper(genomics.make_reference(500, seed=0), MapperConfig())
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_inputs_launch_no_kernel():
    k_chain.launches = k_tile.launches = 0
    rng = np.random.default_rng(0)
    scores = torch.as_tensor(rng.normal(size=(40, 16)).astype(np.float32))
    ops.chain_scan(scores, torch.full((40,), 15.0))
    a = torch.as_tensor(rng.integers(0, 4, 8).astype(np.int32))
    ops.make_sw_tile_fn()(torch.zeros(8), torch.zeros(8),
                          torch.zeros(()), a, a)
    ops.dtw_tile_fn(torch.zeros(8), torch.zeros(8), torch.zeros(()),
                    a.float(), a.float())
    ref = genomics.make_reference(3000, seed=0)
    read = ref[1000:1400]
    ReadMapper(ref, MapperConfig(), device="cpu").map_read(read)
    assert (k_chain.launches, k_tile.launches) == (0, 0)


@pytest.mark.parametrize("n,mult", [(0, 4), (1, 4), (7, 4), (8, 4),
                                    (1000, 256)])
def test_bucketing_copy_matches_reference(n, mult):
    assert bucketing.round_up(n, mult) == ref_bucketing.round_up(n, mult)
    assert (bucketing.round_up_pow2(n, mult)
            == ref_bucketing.round_up_pow2(n, mult))
    for mode in ("linear", "pow2"):
        assert (bucketing.BucketSpec(mult, mode).padded(n)
                == ref_bucketing.BucketSpec(mult, mode).padded(n))
    rng = np.random.default_rng(n)
    arrs = [rng.integers(0, 9, rng.integers(1, mult + 1)) for _ in range(3)]
    width = max(len(a) for a in arrs)
    got = bucketing.pad_stack(arrs, width, -1)
    want = ref_bucketing.pad_stack(arrs, width, -1)
    np.testing.assert_array_equal(got, want)
    lens = bucketing.lengths_of(arrs)
    np.testing.assert_array_equal(lens, ref_bucketing.lengths_of(arrs))
    np.testing.assert_array_equal(bucketing.valid_mask(lens, width),
                                  ref_bucketing.valid_mask(lens, width))
    for x, y in zip(bucketing.unpad(got, lens),
                    ref_bucketing.unpad(want, lens)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(bucketing.pad_to(arrs[0], width, 7),
                                  ref_bucketing.pad_to(arrs[0], width, 7))
    assert (bucketing.group_by_bucket(lens, bucketing.BucketSpec(2))
            == ref_bucketing.group_by_bucket(lens,
                                             ref_bucketing.BucketSpec(2)))
    assert bucketing.shape_key(got) == ref_bucketing.shape_key(want)


def test_genomics_copy_matches_reference():
    assert genomics.PROFILES == [
        genomics.ReadProfile(p.name, p.mean_len, p.std_len, p.accuracy,
                             p.mix) for p in ref_genomics.PROFILES]
    ref = genomics.make_reference(5000, seed=3)
    np.testing.assert_array_equal(ref, ref_genomics.make_reference(5000, 3))
    for prof, rprof in zip(genomics.PROFILES, ref_genomics.PROFILES):
        got = genomics.sample_reads(ref, prof, 2, seed=4)
        want = ref_genomics.sample_reads(ref, rprof, 2, seed=4)
        for (r1, t1), (r2, t2) in zip(got, want):
            assert t1 == t2
            np.testing.assert_array_equal(r1, r2)
    for x, y in zip(genomics.anchor_set(300, seed=2),
                    ref_genomics.anchor_set(300, seed=2)):
        np.testing.assert_array_equal(x, y)
