"""The card's lower bound that ``chip_smoke.py`` reports beside each kernel's
time: the larger of the bytes' time at 3.35 TB/s and the float32-accurate
operations' time at the faster of the FMA rate (67 TFLOP/s) and the 3xTF32
rate (495 / 3 TFLOP/s), at the serving shape N = 16, T = 91, D = 512, 8
heads of 64."""

import pytest

import chip_smoke

N, T, D, H, HD = 16, 91, 512, 8, 64
M = N * T
CORE = 2 * 2 * N * H * T * HD * HD  # K^T V and q . state of the linear core
CASES = {
    "fused_block": (2 * M * D * 3 * D + 2 * M * D * D + CORE,
                    4 * (2 * M * D + M + 2 * N * D + 4 * D * D + 8 * D), 0.0196624, "ops_3xtf32"),
    "projected_attention": (2 * M * D * 3 * D + CORE,
                            4 * (3 * M * D + M + 3 * D * D + 3 * D), 0.0150359, "ops_3xtf32"),
    "efficient_attention": (CORE, 4 * (4 * N * T * D + N * T), 0.0035622, "bytes"),
    "flash_attention": (4 * N * H * T * T * HD, 4 * (4 * N * T * D + N * T), 0.0035622, "bytes"),
}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_bound_takes_the_faster_float32_accurate_rate(kernel):
    flops, nbytes, want_ms, want_kind = CASES[kernel]
    ms, by, kind = chip_smoke.bound(flops, nbytes)
    assert ms == pytest.approx(want_ms, rel=1e-4)
    assert kind == want_kind
    assert by == ("bytes" if want_kind == "bytes" else "operations")
    t_fma = flops / chip_smoke.PEAK_F32_FLOPS * 1e3
    assert ms <= max(t_fma, nbytes / chip_smoke.PEAK_BYTES * 1e3)
