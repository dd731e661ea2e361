"""``repro_torch.kernels.work``: each kernel's work, stated once, gives the
"Bound ms" column of ``PERF.md`` section 6 (nine rows, at their main-path
shapes) over the H100 figures of ``launch.roofline``, to 4 significant
digits; the visible pairs of causal and windowed attention are the brute
count's; outside a cost walk a charge does nothing."""

import numpy as np
import pytest

from repro_torch.kernels import work
from repro_torch.launch import roofline
from repro_torch.launch.op_analysis import OpWalk

# (row of PERF.md section 6, its Work, bf16 on the tensor cores, Bound ms)
ROWS = [
    ("chain_scan (4096, 64)", work.chain_scan(4096, 64), False, 0.0003277),
    ("dp_tile 64 x 64", work.dp_tile(64, 64), False, 0.000005352),
    ("dp_wavefront 21,248^2", work.dp_wavefront(21_248, 21_248), False,
     0.539230),
    ("radix_rank (4, 16384)", work.radix_rank(4, 16_384), False, 0.000236),
    ("radix_sort_chunks (4, 16384)", work.radix_sort_chunks(4, 16_384),
     False, 0.0003913),
    ("ssm_scan (128, 2048, 64)", work.ssm_scan(128, 2048, 64, 64), False,
     0.100788),
    ("flash_attention bf16 (4, 8, 2048, 256)",
     work.flash_attention(4, 8, 1, 2048, 2048, 256, 0, 2), True, 0.069518),
    ("flash_attention_bwd bf16 (2, 8, 2048, 256)",
     work.flash_attention_bwd(2, 8, 1, 2048, 2048, 256, 0, 2), True,
     0.086897),
    ("ssm_scan_bwd (128, 2048, 64)", work.ssm_scan_bwd(128, 2048, 64, 64),
     False, 0.192312),
]
# the same table's other bounds: fp32 flash forward and backward, and
# radix_rank at 64 chunks
MORE = [
    (work.flash_attention(4, 8, 1, 2048, 2048, 256, 0, 4), False, 1.026165),
    (work.flash_attention_bwd(2, 8, 1, 2048, 2048, 256, 0, 4), False,
     1.282706),
    (work.radix_rank(64, 16_384), False, 0.003776),
]


def _sig4(x: float) -> float:
    return float(f"{x:.4g}")


@pytest.mark.parametrize("row,w,tc,want", ROWS, ids=[r[0] for r in ROWS])
def test_work_gives_the_kernel_table_s_bound(row, w, tc, want):
    got_ms = roofline.kernel_bound_s(w.flops, w.bytes, tc) * 1e3
    assert _sig4(got_ms) == _sig4(want), (row, got_ms)


@pytest.mark.parametrize("w,tc,want", MORE)
def test_work_gives_the_table_s_other_bounds(w, tc, want):
    got_ms = roofline.kernel_bound_s(w.flops, w.bytes, tc) * 1e3
    assert _sig4(got_ms) == _sig4(want)


@pytest.mark.parametrize("sq,skv,window", [(1, 1, 0), (7, 7, 0), (64, 64, 0),
                                           (5, 9, 0), (9, 5, 0), (64, 64, 16),
                                           (300, 300, 96), (10, 4, 3),
                                           (4, 10, 2), (2048, 2048, 1024)])
def test_visible_pairs_are_the_brute_count(sq, skv, window):
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    ok = j <= i
    if window:
        ok &= (i - j) < window
    assert work.visible_pairs(sq, skv, window) == int(ok.sum())
    if not window and sq == skv:
        assert work.visible_pairs(sq, skv) == sq * (sq + 1) // 2


def test_a_charge_outside_a_walk_does_nothing():
    assert not work.active()
    work.charge("flash_attention", 1, 1, 1, 4, 4, 16, 0, 2)
    with OpWalk() as outer:
        with OpWalk() as inner:
            assert work.active()
            work.charge("ssm_scan", 2, 3, 4, 5)
        work.charge("dp_tile", 64, 64)
    assert not work.active()
    assert inner.kernels == {"ssm_scan": [1, *work.ssm_scan(2, 3, 4, 5)]}
    assert outer.kernels == {"ssm_scan": [1, *work.ssm_scan(2, 3, 4, 5)],
                             "dp_tile": [1, *work.dp_tile(64, 64)]}


def test_every_kernel_row_has_a_work_function():
    assert set(work.WORK) == {
        "chain_scan", "dp_tile", "dp_wavefront", "radix_rank",
        "radix_sort_chunks", "ssm_scan", "ssm_scan_bwd", "flash_attention",
        "flash_attention_bwd"}
    assert all(fn.__doc__ for fn in work.WORK.values())
