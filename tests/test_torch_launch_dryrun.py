"""``repro_torch.launch.{dryrun,roofline,report,perf}`` against the
reference's launch tools: a dry-run record carries the reference's keys
(``chips`` = 1, and ``fits_one_card`` beside them); ``params`` and
``active_params`` are the reference's counts on its specs, exactly; the
roofline terms and model FLOPs are the reference's functions once the
constants are set equal; the report renders; more than one card raises."""

import importlib
import json
import os

import jax
import pytest

from repro import configs as RC
from repro.launch import roofline as ref_roofline
from repro.launch import specs as ref_specs
from repro_torch import configs as TC
from repro_torch.launch import dryrun, perf, report, roofline, specs
from repro_torch.models import transformer as TT

# the reference's record and roofline keys (repro/launch/dryrun.py,
# roofline.summarize); the port's walk multiplies no loop trip counts
REF_RECORD_KEYS = {"arch", "shape", "mesh", "rule_overrides", "cfg_patch",
                   "status", "kind", "chips", "params", "active_params",
                   "tokens_per_step", "memory_analysis", "roofline"}
REF_ROOFLINE_KEYS = {"hlo_flops_per_device", "hlo_bytes_per_device",
                     "collective_bytes_per_device", "collective_breakdown",
                     "model_flops_global", "compute_s", "memory_s",
                     "collective_s", "dominant", "step_lower_bound_s",
                     "compute_fraction_of_bound", "hlo_flops_global",
                     "useful_flops_ratio"}


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with the JAX backend already up
    and ``XLA_FLAGS`` put back: the module sets 512 host devices at import,
    which must reach neither this process nor later subprocesses."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


def test_run_cell_records_carry_the_reference_keys(tmp_path):
    rec = dryrun.run_cell("gemma-2b", "prefill_32k", out_dir=tmp_path,
                          verbose=False)
    assert rec["status"] == "OK", rec.get("error")
    assert REF_RECORD_KEYS | {"fits_one_card"} <= set(rec)
    assert set(rec["roofline"]) == REF_ROOFLINE_KEYS | {"kernels"}
    assert rec["chips"] == 1 and rec["kind"] == "prefill"
    assert rec["tokens_per_step"] == 32 * 32768
    assert set(rec["memory_analysis"]) == {"temp_size_in_bytes",
                                           "argument_size_in_bytes",
                                           "output_size_in_bytes"}
    # one flash_attention launch a layer, charged its kernels.work
    assert rec["roofline"]["kernels"]["flash_attention"]["calls"] == 18
    assert rec["fits_one_card"] is False          # 32 x 32k tokens
    saved = json.loads((tmp_path / "gemma-2b__prefill_32k__single.json")
                       .read_text())
    assert saved["roofline"]["hlo_flops_per_device"] == \
        rec["roofline"]["hlo_flops_per_device"] > 0


def test_skip_is_the_reference_s_rule(tmp_path):
    rec = dryrun.run_cell("gemma-2b", "long_500k", out_dir=tmp_path)
    want = RC.shape_applicable(RC.get_config("gemma-2b"),
                               RC.SHAPES["long_500k"])
    assert rec["status"] == "SKIP" and rec["reason"] == want
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_param_counts_are_the_reference_s(arch, ref_dryrun):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    want = ref_specs.params_specs(rcfg)
    model = specs.params_specs(tcfg)
    assert TT.param_count(model) == ref_dryrun._tree_param_count(want)
    assert TT.active_param_count(model, tcfg) == \
        ref_dryrun._active_param_count(want, rcfg)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (989e12, 0.0, 0.0), (0.0, 3.35e12, 0.0), (0.0, 0.0, 450e9),
    (1.5e15, 2.5e12, 1e9), (0.0, 0.0, 0.0)])
def test_roofline_terms_are_the_reference_s_at_equal_constants(
        flops, nbytes, coll, monkeypatch):
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW", roofline.NVLINK_BW)
    assert roofline.roofline_terms(flops, nbytes, coll) == \
        ref_roofline.roofline_terms(flops, nbytes, coll)
    for kind in ("train", "inference"):
        assert roofline.model_flops(1_234_567, 8192, kind) == \
            ref_roofline.model_flops(1_234_567, 8192, kind)


def test_no_tpu_constant_stays():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert {197e12, 819e9, 50e9}.isdisjoint(
        {roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_FP32, roofline.HBM_BW,
         roofline.NVLINK_BW})


def test_report_tables_render(tmp_path, capsys):
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--out", str(tmp_path)]) == 0
    assert "4 OK" in capsys.readouterr().out
    table = report.dryrun_table(tmp_path)
    assert table.count("| rwkv6-1.6b |") == 4
    assert "fits one H100" in table.splitlines()[0]
    roof = report.roofline_table(tmp_path)
    assert roof.count("\n") == 5 and "dominant" in roof.splitlines()[0]
    recs = {r["shape"]: r for r in report.load(tmp_path)}
    # one layer's O(1) state: the decode cells fit the card
    assert recs["long_500k"]["fits_one_card"] is True
    assert recs["train_4k"]["roofline"]["kernels"]["ssm_scan_bwd"][
        "calls"] == 24


def test_more_than_one_card_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="item 4"):
        dryrun.main(["--mesh", "multi", "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 4"):
        dryrun.main(["--mesh", "both", "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 4"):
        dryrun.run_cell("gemma-2b", "train_4k", multi_pod=True,
                        out_dir=tmp_path)
    with pytest.raises(NotImplementedError, match="item 4"):
        dryrun.run_cell("gemma-2b", "train_4k", out_dir=tmp_path,
                        rule_overrides={"batch": "data"})
    for flag in (["--multi"], ["--rules", '{"batch": "data"}']):
        with pytest.raises(NotImplementedError, match="item 4"):
            perf.main(["--arch", "gemma-2b", "--shape", "train_4k"] + flag)


@pytest.mark.parametrize("arch,shape", [("gemma-2b", "prefill_32k"),
                                        ("rwkv6-1.6b", "train_4k")])
def test_perf_runs_the_cell_on_the_cpu(arch, shape):
    """``perf.run`` at a reduced config on the CPU: the walk of the call
    that ran is FlopCounterMode's, and the CPU launches no kernel."""
    rec = perf.run(arch, shape, batch=2, seq=32, device="cpu", reduced=True,
                   topk=5, verbose=False)
    assert rec["walk"]["aten_flops"] == rec["flop_counter_flops"] > 0
    assert rec["launches"] == {} and rec["walk"]["kernels"] == {}
    assert len(rec["top_bytes"]) == 5
    assert rec["roofline"]["kernels"]          # the meta walk charged them
