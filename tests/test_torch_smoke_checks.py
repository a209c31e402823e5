"""The profile phase's check of ``chip_smoke.py``: a sampler call's trace
must hold, kernel name by kernel name, its launch counts times what one
wrapper call of each form launches. Pure functions: no card needed."""

import pytest

import chip_smoke

PER_LAUNCH = {
    "fused_block": {"gemm<96>": 1, "gemm<32>": 1, "core": 1, "norm<t>": 1, "norm<f>": 1},
    "projected_attention": {"gemm<96>": 1, "core": 1},
    "flash_attention": {"flash": 1},
}


@pytest.mark.parametrize("counts, want", [
    ({"fused_block": 800},
     {"gemm<96>": 800, "gemm<32>": 800, "core": 800, "norm<t>": 800, "norm<f>": 800}),
    ({"projected_attention": 16}, {"gemm<96>": 16, "core": 16}),
    # forms that share a kernel add up on its name
    ({"fused_block": 2, "projected_attention": 3},
     {"gemm<96>": 5, "gemm<32>": 2, "core": 5, "norm<t>": 2, "norm<f>": 2}),
    ({"flash_attention": 16000}, {"flash": 16000}),
    ({}, {}),
    # a counted form the table does not know cannot be held to a trace
    ({"fused_block": 800, "efficient_attention_bf16": 16}, None),
])
def test_expected_port_kernels(counts, want):
    assert chip_smoke.expected_port_kernels(counts, PER_LAUNCH) == want


@pytest.mark.parametrize("run, sampler", [
    ("serve_fused", True), ("serve_bf16_guided", True), ("serve_ddpm", True),
    ("evaluate_ddpm1000", True), ("serve_fused_eager", True),
    ("train_step_pit", False), ("label_vote_bf16", False), ("train_step_pit_bf16", False),
])
def test_sampler_runs_are_the_checked_ones(run, sampler):
    assert chip_smoke.sampler_run(run) is sampler
