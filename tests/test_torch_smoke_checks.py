"""The profile phase's check of ``chip_smoke.py``: a sampler call's or a
replayed train step's trace must hold, kernel name by kernel name, its
launch counts times what one wrapper call of each form launches (for a
step: one training call, forward and backward, its ordered bfloat16 sums
in their own row); a profiled call is taken again until its trace passes or
two of its traces agree. Pure functions: no card needed."""

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


TRAIN_PER_CALL = {
    "projected_attention": {"gemm<96>": 1, "core": 1},
    "efficient_attention_bf16": {"core_bf16": 1},
    "bf16_sum": {"sum": 1},
}


@pytest.mark.parametrize("counts, want", [
    ({"projected_attention": 16}, {"gemm<96>": 16, "core": 16}),
    ({"efficient_attention_bf16": 16, "bf16_sum": 52}, {"core_bf16": 16, "sum": 52}),
    # B1 has no backward: a step that counts it cannot be held
    ({"projected_attention": 16, "fused_block": 16}, None),
])
def test_expected_port_kernels_of_a_train_step(counts, want):
    assert chip_smoke.expected_port_kernels(counts, TRAIN_PER_CALL) == want


@pytest.mark.parametrize("traced, sums, want", [
    ({"core_bf16": 1, "sum": 4}, 4, {"core_bf16": 1}),
    ({"flash": 1}, 0, {"flash": 1}),
    # a trace with fewer sums than counted keeps the shortfall, to fail on
    ({"flash": 1, "sum": 2}, 3, {"flash": 1, "sum": -1}),
])
def test_a_training_row_leaves_out_its_sums(traced, sums, want):
    assert chip_smoke.without_sums(traced, {"sum": 1}, sums) == want


@pytest.mark.parametrize("run, step", [
    ("train_step_pit", True), ("train_step_pit_bf16", True), ("serve_fused", False),
    ("label_vote", False), ("evaluate_dpm20", False),
])
def test_train_step_runs_are_the_checked_ones(run, step):
    assert chip_smoke.train_step_run(run) is step


def sessions_of(traces):
    """A ``session()`` that hands back each of ``traces`` ({kernel: device
    events}) in turn: (the trace, the session's number)."""
    calls = iter(enumerate(traces))

    def session():
        i, trace = next(calls)
        return trace, i

    return session


CLEAN, SHORT = {"core": 16, "copy": 40}, {"core": 15, "copy": 37}


@pytest.mark.parametrize("traces, passes, kept, taken, ok", [
    # a trace that passes its check is kept at once
    ([CLEAN], True, 0, 1, True),
    # one without a device event never is, even when it would pass
    ([{}, CLEAN], True, 1, 2, True),
    ([{}, {}, {}, {}], True, 3, 4, False),
    # a trace that fails is kept once a second session's trace equals it
    ([SHORT, SHORT], False, 1, 2, True),
    # a lossy session fails, then a clean one is confirmed by the next
    ([SHORT, CLEAN, CLEAN], False, 2, 3, True),
    ([{}, CLEAN, {}, CLEAN], False, 3, 4, True),
    # four traces, no two alike: the last comes back, not kept
    ([{"a": 1}, {"a": 2}, {"a": 3}, {"a": 4}], False, 3, 4, False),
    # no check (a table row): two sessions must agree
    ([CLEAN, CLEAN], None, 1, 2, True),
    ([CLEAN, SHORT, CLEAN], None, 2, 3, True),
    # a clean trace, then three lost sessions: none confirms it
    ([CLEAN, {}, {}, {}], None, 3, 4, False),
])
def test_a_profiled_call_is_kept_when_it_passes_or_two_traces_agree(traces, passes, kept,
                                                                    taken, ok):
    held = None if passes is None else (lambda result: passes)
    (trace, i), n, is_kept = chip_smoke.kept_session(sessions_of(traces), held, sessions=4,
                                                      pause_s=0)
    assert (i, n, is_kept, trace) == (kept, taken, ok, traces[kept])


@pytest.mark.parametrize("traces, passes, pauses", [
    ([CLEAN], True, 0),
    ([SHORT, CLEAN], True, 1),
    # a table row's second session is no retake
    ([CLEAN, CLEAN], None, 0),
    ([CLEAN, {}, CLEAN], None, 1),
])
def test_only_a_retaken_session_waits(traces, passes, pauses, monkeypatch):
    waits = []
    monkeypatch.setattr(chip_smoke.time, "sleep", waits.append)
    held = None if passes is None else (lambda result: result[0] == CLEAN)
    chip_smoke.kept_session(sessions_of(traces), held, pause_s=0.5)
    assert waits == [0.5] * pauses
