"""The card's lower bound that ``chip_smoke.py`` reports beside each kernel's
time: the larger of the bytes' time at 3.35 TB/s and the float32-accurate
operations' time at the faster of the FMA rate (67 TFLOP/s) and the 3xTF32
rate (495 / 3 TFLOP/s), at the serving shape N = 16, T = 91, D = 512, 8
heads of 64; and the gates that hold the bfloat16 forms to their twins,
against planted controls: B1-bf16's twin without one core rounding,
B3-bf16's twin without one of its rounding points, and B2-bf16's twin with
B1-bf16's core roundings."""

import pytest
import torch

import chip_smoke

N, T, D, H, HD = 16, 91, 512, 8, 64
M = N * T
CORE = 2 * 2 * N * H * T * HD * HD  # K^T V and q . state of the linear core


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
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


# The bfloat16 forms' bound: each part of the work at its own rate (bf16
# 989 TFLOP/s on the tensor cores for every product of two bfloat16 values,
# B4-bf16's q·kᵀ too: its upcast operands' products are exact; 3xTF32
# 495 / 3 for B2-bf16's float32 core), bytes at 2 per bfloat16 element.
# A float32-accurate product of a bfloat16 activation and a float32 weight
# is three bfloat16 products (B2-bf16a's GEMM): 989 / 3 beats 495 / 2.
BF16_CASES = {
    "fused_block_bf16": ([(2 * M * D * 3 * D + 2 * M * D * D, "bf16"), (CORE, "bf16")],
                         2 * (2 * M * D + 2 * N * D + 4 * D * D + 8 * D) + 4 * M, "ops_bf16"),
    "projected_attention_bf16": ([(2 * M * D * 3 * D, "bf16"), (CORE, "3xtf32")],
                                 2 * (3 * M * D + 3 * D * D + 3 * D) + 4 * M,
                                 "ops_3xtf32+bf16"),
    "flash_attention_bf16": ([(2 * 2 * N * H * T * T * HD, "bf16")],
                             2 * 4 * N * T * D + 4 * N * T, "bytes"),
    "efficient_attention_bf16": ([(CORE, "bf16")], 2 * 4 * N * T * D + 4 * N * T, "bytes"),
    # bfloat16 activations with float32 weights: float32-accurate products,
    # the GEMM's at the card's fastest such rate, the weight in three
    # bfloat16 pieces (989 / 3, above two TF32 terms at 495 / 2)
    "projected_attention_bf16a": ([(2 * M * D * 3 * D, "3xbf16"), (CORE, "3xtf32")],
                                  2 * 2 * M * D + 4 * (3 * D * D + 3 * D) + 4 * M,
                                  "ops_3xbf16+3xtf32"),
    # the ordered bfloat16 sum over one B3-bf16 backward's two axes: float32
    # adds outside the tensor cores, float32 in and out
    "bf16_sum": ([(2 * N * T * D, "f32")], 4 * (2 * N * T * D + N * T * H + N * D), "bytes"),
    # B2's rectangular bfloat16 forms (a TP rank's 256 output columns, 4
    # heads; kv from the partner): as B2-bf16's and B2-bf16a's at Dout = 256
    "projected_attention_rect_bf16": (
        [(2 * M * D * 3 * 256, "bf16"), (2 * 2 * N * 4 * T * HD * HD, "3xtf32")],
        2 * (2 * M * D + M * 256 + 3 * 256 * D + 3 * 256) + 4 * M, "ops_3xtf32+bf16"),
    "projected_attention_rect_bf16a": (
        [(2 * M * D * 3 * 256, "3xbf16"), (2 * 2 * N * 4 * T * HD * HD, "3xtf32")],
        2 * (2 * M * D + M * 256) + 4 * (3 * 256 * D + 3 * 256) + 4 * M, "ops_3xbf16+3xtf32"),
}


@pytest.mark.parametrize("form", sorted(BF16_CASES))
def test_bf16_bound_counts_each_part_at_its_rate(form):
    parts, nbytes, want_kind = BF16_CASES[form]
    ms, by, kind = chip_smoke.bound_parts(parts, nbytes)
    rates = {"bf16": chip_smoke.PEAK_BF16_FLOPS,
             "3xtf32": chip_smoke.PEAK_TF32_FLOPS / chip_smoke.TF32_SPLIT,
             "3xbf16": chip_smoke.PEAK_BF16_FLOPS / 3, "f32": chip_smoke.PEAK_F32_FLOPS}
    want = max(sum(f / rates[r] for f, r in parts), nbytes / chip_smoke.PEAK_BYTES) * 1e3
    assert ms == pytest.approx(want, rel=1e-12)
    assert kind == want_kind
    assert by == ("bytes" if want_kind == "bytes" else "operations")
    if form == "efficient_attention_bf16":  # what phase 10 passes for B3-bf16
        assert chip_smoke.b3_bf16_work(N, T, T) == (parts, nbytes)
    if form.startswith("projected_attention_rect_"):  # what phase 16 passes
        assert chip_smoke.rect_bf16_work(form.rsplit("_", 1)[1], N, T) == (parts, nbytes)


# The gates phase 10 holds each bfloat16 form to against its twin fail a
# form that skips one of B1's core roundings: the B1 twin without it, put
# in the kernel's place at the serving shape. On the CPU the float32-order
# floor is 0, so the limit is 0.25 of the twin's distance from float32.
@pytest.fixture(scope="module")
def b1_bf16_twin():
    import torch

    from hig_tpu_torch.ops.fused_block import BlockWeights, fused_attention_block_plain

    w, x, mask, scale, shift = chip_smoke.block_inputs(torch.device("cpu"))
    wb = BlockWeights(*[t.to(torch.bfloat16) for t in w])
    args = (x.to(torch.bfloat16), mask, scale.to(torch.bfloat16), shift.to(torch.bfloat16),
            wb, H, True)
    args32 = (args[0].float(), mask, args[2].float(), args[3].float(),
              BlockWeights(*[t.float() for t in wb]), H, True)
    return args, args32, fused_attention_block_plain(*args), fused_attention_block_plain(*args32)


@pytest.mark.parametrize("left_out", chip_smoke.B1_CORE_ROUNDINGS)
def test_bf16_gate_fails_b1_without_a_core_rounding(b1_bf16_twin, left_out):
    from hig_tpu_torch.ops.fused_block import fused_attention_block_plain

    args, args32, twin, twin32 = b1_bf16_twin
    assert chip_smoke.bf16_gate_row(twin, twin, twin32, twin)["passed"]
    control = fused_attention_block_plain(*args, unrounded=(left_out,))
    row = chip_smoke.bf16_gate_row(control, twin, twin32, twin)
    assert control.dtype == twin.dtype
    assert not row["passed"], row
    assert row["rms_ratio"] > 2 * chip_smoke.BF16_KERNEL_RMS, row
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attention_block_plain(*args32, unrounded=(left_out,))


def test_control_names_are_the_twins_rounding_points():
    from hig_tpu_torch.ops.pallas_attention import B3_ROUNDINGS, CORE_ROUNDINGS

    assert chip_smoke.B1_CORE_ROUNDINGS == CORE_ROUNDINGS
    assert chip_smoke.B3_CORE_ROUNDINGS == B3_ROUNDINGS


@pytest.fixture(scope="module")
def b3_bf16_twin():
    """B3-bf16's twin at the serving shape as phase 10 checks it (91 queries
    on 77 keys), its float32 twin on the same rounded inputs."""
    import torch

    from hig_tpu_torch.ops.pallas_attention import fused_efficient_attention_plain as plain

    w, x, mask, _, _ = chip_smoke.block_inputs(torch.device("cpu"))
    args = chip_smoke.b3_bf16_inputs(w, x, mask, chip_smoke.TK_SHORT)
    args32 = [a.float() if torch.is_tensor(a) else a for a in args]
    return args, plain(*args), plain(*args32)


@pytest.mark.parametrize("left_out", chip_smoke.B3_CORE_ROUNDINGS)
def test_bf16_gate_fails_b3_without_a_rounding(b3_bf16_twin, left_out):
    from hig_tpu_torch.ops.pallas_attention import fused_efficient_attention_plain as plain

    args, twin, twin32 = b3_bf16_twin
    assert chip_smoke.bf16_gate_row(twin, twin, twin32, twin)["passed"]
    control = plain(*args, unrounded=(left_out,))
    row = chip_smoke.bf16_gate_row(control, twin, twin32, twin)
    assert control.dtype == twin.dtype
    assert not row["passed"], row
    assert row["rms_ratio"] > 2 * chip_smoke.BF16_KERNEL_RMS, row


def test_bf16_gate_fails_b2_with_b1_core_roundings():
    """B2-bf16's Pallas kernel keeps its core in float32: a twin that rounds
    the core as B1-bf16's does (softmax_time(k), v, the state, softmax_feat
    (q)) fails B2-bf16's gates, so they check the float32 core."""
    import torch

    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention_plain as plain

    w, x, mask, _, _ = chip_smoke.block_inputs(torch.device("cpu"))
    xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6).to(torch.bfloat16)
    ws = [t.to(torch.bfloat16) for t in (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)]
    args = (xn, xn.flip(1).contiguous(), *ws, H, mask.flip(1).contiguous())
    twin = plain(*args)
    twin32 = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
    assert chip_smoke.bf16_gate_row(twin, twin, twin32, twin)["passed"]
    control = plain(*args, rounded=chip_smoke.B1_CORE_ROUNDINGS)
    row = chip_smoke.bf16_gate_row(control, twin, twin32, twin)
    assert control.dtype == twin.dtype
    assert not row["passed"], row
    assert row["rms_ratio"] > 2 * chip_smoke.BF16_KERNEL_RMS, row
    with pytest.raises(ValueError, match="bfloat16"):
        plain(*[a.float() if torch.is_tensor(a) else a for a in args],
              rounded=chip_smoke.B1_CORE_ROUNDINGS)


def test_bf16a_gate_fails_with_b1_core_roundings():
    """B2-bf16a (bfloat16 activations, float32 weights) keeps its core in
    float32 too: its twin with B1-bf16's core roundings fails its gates."""
    import torch

    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention_plain as plain

    w, x, mask, _, _ = chip_smoke.block_inputs(torch.device("cpu"))
    xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6).to(torch.bfloat16)
    args = (xn, xn, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, mask)
    twin = plain(*args)
    twin32 = plain(xn.float(), xn.float(), *args[2:])
    assert twin.dtype == torch.bfloat16
    assert chip_smoke.bf16_gate_row(twin, twin, twin32, twin)["passed"]
    row = chip_smoke.bf16_gate_row(plain(*args, rounded=chip_smoke.B1_CORE_ROUNDINGS), twin,
                                   twin32, twin)
    assert not row["passed"], row


@pytest.mark.parametrize("no_eff", [False, True], ids=["efficient", "no_eff"])
def test_phase11_gate_passes_the_plain_route_and_fails_its_control(no_eff):
    """Phase 11's gradient gate on the CPU, where the kernel route is the
    plain route: a small bfloat16 model (first layer of 2, latent 128, head
    dim 64) reads 0, and the control route (JAX's use_pallas forward for
    the efficient blocks, B4's unrounded plain version for --no_eff)
    exceeds BF16_TRAIN_RMS."""
    import dataclasses

    import torch

    from hig_tpu_torch.config import ExperimentConfig, model_config
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

    torch.manual_seed(0)
    mcfg = model_config(ExperimentConfig(num_layers=2, latent_dim=128, ff_size=256,
                                         num_heads=2, text_latent_dim=32, cap_id=True,
                                         no_eff=no_eff, compute_dtype="bfloat16"))
    tree = random_flax_tree(dataclasses.replace(mcfg, compute_dtype="float32"), seed=0)
    model = load_flax_tree(InteractionModel(mcfg), tree["params"]).train()
    gen = torch.Generator().manual_seed(1)
    pairs, T_ = chip_smoke.TRAIN_PAIRS // 4, 24
    batch = {"motion": torch.randn(pairs, 2, T_, 263, generator=gen),
             "lengths": torch.tensor([24, 20, 13, 24, 9, 17, 24, 5]),
             "cap_ids": torch.randint(0, 43, (pairs, 2), generator=gen)}
    failures = []
    saved = chip_smoke.TRAIN_PAIRS
    chip_smoke.TRAIN_PAIRS = pairs
    try:
        out = chip_smoke.bf16_grad_gate(g.make_schedule(g.linear_betas(1000)), batch, model,
                                        "test", failures)
    finally:
        chip_smoke.TRAIN_PAIRS = saved
    assert failures == [], out
    assert out["kernels"] == {"loss_ratio": 0.0, "grad_ratio": 0.0}
    assert max(out["control"].values()) > chip_smoke.BF16_TRAIN_RMS
