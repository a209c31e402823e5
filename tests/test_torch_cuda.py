"""CUDA kernels of the PyTorch port against their plain versions on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. The GPU machine has
no JAX, so run this file there without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are the serving path's: 8 caption pairs (N = 16 sequences), T = 91
(and 77 keys where Tq != Tk), D = 512, 8 heads of 64, float32, ragged
lengths; B1 and B4 also at T = 1, 17 and 196, the ragged edges of their
tiles, and B4 with more keys than its shared-memory tile holds; B1, B2 and
B4 at an evaluation chunk's shape (52 pairs, T = 196).

Tolerances: 1e-4 absolute, since float32 sums run in another order than
cuBLAS's and the block's second LayerNorm rescales the attention output by
1/std; and REL_TOL of the largest magnitude of the plain output, which the
kernels' 3xTF32 products meet and plain TF32 products (the low parts
dropped) miss by more than an order of magnitude.

bfloat16 forms (B1-bf16, B2-bf16, B3-bf16, B4-bf16) against their bfloat16
twins at the serving shape (B1 also at T = 1, 17 and 196 and at an
evaluation chunk's shape, where B1's planted controls must fail too; B4 at
T = 196, two of the Pallas kernel's key blocks, self, partner and causal,
and with 91 queries over 77 keys; B2 self and partner at T = 1, 129
(the edges of its 128-row rounds), 196, 320, 321, 392 and 512, and over a
merged two-actor timeline of 392 rows (the serving and evaluation chunk's
pairs), where the twin that rounds the core as B1-bf16 does must fail
but at T = 1; B3 with 91, 196 or 321 queries over 77 keys, 91 queries
over 394 keys and with T = 1, 17, 91, 196, 320, 392 and 394 queries and
keys, where the twin without each of its rounding points must fail but at
T = 1), with cuBLAS's
reduced-precision bf16 reductions off, under
``chip_smoke.py``'s gates: max |kernel − twin| within 2 bfloat16 ulps of
the twin's largest magnitude, and rms(kernel − twin) within 0.25 of
rms(twin − the float32 twin on the same rounded inputs) or, where larger,
1.5 × the twin's distance from the same twin on the CPU (the float32 order
of sums alone; B1's cancelling KᵀV sum sits there); each form counts its
own launches; B1-bf16's whole form refuses T = 321 (its streaming form
takes it), B2-bf16 takes it and T = 1000;
B3-bf16 streams past 320 rows (394 × 394, 321 × 77 and 91 × 394 queries
× keys within the same gates) and its streaming form equals its whole form
bit for bit where both run (T = 1 to 320); a bfloat16
tensor beside float32 operands raises, but for B2 on bfloat16 activations
with float32 weights (B2-bf16a, a bfloat16 model's labeling on master
weights), held to the same gates against its twin at the serving, labeling
(128 pairs) and evaluation (52 pairs, T = 196) shapes and at T = 1, 17,
196 and 320 (its control from T = 17), which counts its own launches,
whose whole form refuses T = 321 (its streaming form takes it) and which
refuses to run under grad; its weight split kernel
equals its plain version bit for bit.

Gradients: B2, B3 (float32 and bfloat16) and B4 under autograd against autograd through their
plain versions (the backwards recompute the plain versions, so only the
forward's rounding differs), at the same tolerances (B3-bf16's backward,
XLA's bfloat16 VJP written out, equal to its plain route's on the card and
within a bfloat16 ulp of its largest magnitude of the same on the CPU, also
at the training shape: 64 pairs); the ordered bfloat16 sum of the bfloat16
backwards, bit for bit against its plain version, at the training shape
over each axis they sum; B1 refuses to run
under grad; and whole training steps of the model through the kernels
against the same steps through the plain versions: the loss within 1e-4
relative and every gradient within 1e-3 of its leaf's largest magnitude
(the key biases, whose exact gradient is 0, within 1e-6 of the largest
gradient of the model).

The sampler as one CUDA graph per shape, at a small width (latent 128, 2
layers, 4 pairs, T = 40, a 100-step schedule): the capture and a replay
equal the eager loop (``graph=False``) bit for bit, with the generator in
the same state after each call and the eager call's launch counts credited
to a replay, for DDIM through B1 in float32 and bfloat16, guided DDIM, DPM
through B2, DDIM through B4, DDPM over two calls on one generator, and the
ablations (``--no_cross_attn`` through B1, ``--single_transformer``
through B2 and B2-bf16, and guided DDPM); a
second shape captures a second graph; the graphed DDPM sampler refuses a
callable ``step_noise`` (naming ``graph=False``) and a call without a
generator; an eager sampler on the plain route launches no kernel.

The train step as one CUDA graph per batch shape, at the same small width
(4 pairs, T = 40): three steps from one seeded state with per-step
generator seeds, graphed (the first step eager on the capture stream, then
the capture, replays after) against eager (``graph=False``), and eager
against eager: metrics, generator states, parameters, Adam's moments, EMA
and the loss-aware history bit for bit (two eager steps agree bit for bit
on every path here, so the graphed one must), each replay crediting the
eager step's launch counts, for float32 PIT (B2), ``--no_eff`` (B4),
caption ids, CFG with the loss-aware sampler (supervised), bf16 PIT
(B3-bf16 and the ordered sum), bf16 ``--no_eff`` (B4-bf16),
``grad_accum`` 2 with the EMA, PIT ``--no_cross_attn`` (B2), supervised
``--single_transformer`` (B2) and bf16 PIT ``--single_transformer``
(B3-bf16), and the single-person model's step and sampler; a second batch
shape captures a second graph; a rollback mid-run (``restore_state`` in place) keeps the one graph
on the same tensors and equals the eager run; the graphed step refuses a
call without a generator and another TrainState.

The motion geometry and visualization: one bfloat16 --single_transformer
PIT step at a native window of 196 (394 merged rows) at full width cut to
its first layer against the plain route and against the same step on the
CPU (``chip_smoke``'s gates);
the generator's FK and a batched ``encode_pair`` on the card against the
CPU (features within 1e-4, foot contacts equal); ``python -m
hig_tpu_torch.visualize`` on an 8-layer caption-id run: 816 B1 launches
(a DDIM-50 pair and the capture's warm-up), its joints equal to serve's
decode of a replay.

Causal efficient attention and the native loader: the causal self-attention
and interaction blocks at the serving shape on the card against the same
blocks on the CPU (float32 with a train-mode call's gradients, and bf16),
launching no kernel; the causal model's DDIM sampler and PIT step, float32
and bf16, graphed against eager bit for bit; the native batch loader built
with g++ into ``hig_tpu_torch/_build/`` and loaded from there.

Distillation, SMPL and the legacy protocol: the distillation step graphed
against eager bit for bit over two stages (the teacher copied in place from
the student between them, each stage its own step and graph), plain and
fixed-w, with its exact B1 (teacher) and B2 (student) launches; the SMPL
joints-only ``lbs`` against the full one and both against the CPU, the
L-BFGS's first 5 iterates on the card (graphed equal to eager bit for
bit) against the CPU within 1e-4 and SMPLify3D's final objective within 1%; the legacy co-embeddings at the
reference's widths on the card against the CPU within 1e-4.

Parallelism: B2's rectangular form (a tensor-parallel rank's (D/2, D)
q|k|v weights at H/2 heads), float32, bfloat16 and B2-bf16a, self and
partner, against its twins, with its gradients; two gloo ranks sharing
cuda:0 taking DP PIT steps equal to the one-rank step.

Head width 128 and the streaming forms: every form at head width 128 (D =
512, 4 heads) against its plain version or twin under the same gates
(float32: B1, B2, B3, B4 with 77 and 300 keys; bfloat16: B1-bf16 and
B3-bf16 also past their whole forms' 128 rows, B2-bf16a at T = 91 and
197); B1-bf16's and B2-bf16a's streaming forms against their twins at 394
and 600 rows; each streaming form (and B3-bf16's) equal to its whole form
bit for bit at T = 1, 91, 196 and 320 (width 64) and 1, 65 and 128 (width
128); the whole forms' row caps of Python's routers equal the kernels';
widths 256 and 512 / 6 raise, naming 16, 32, 64 and 128; the ordered sum
at 1025 and 4096 terms.

Head widths 16 and 32 (32 and 16 heads at D = 512, packed 4 and 2 to a
64-column tile): every form in float32 and bfloat16 against its plain
version or twin under the same gates (B1-bf16 and B3-bf16 also past 320
rows, B2-bf16a at T = 91 and 394), the streaming forms bit for bit with
the whole forms at T = 1, 91 and 320, the routers' row caps equal the
kernels'; B4 at head width 128 (warp pairs) at 91, 196 and 394 rows,
self, partner and causal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hig_tpu_torch.ops import _build
from hig_tpu_torch.ops.bf16_sum import (
    ONE_LAUNCH_TERMS,
    bf16_sum,
    bf16_sum_plain,
    scratch_levels,
)
from hig_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from hig_tpu_torch.ops.fused_block import (
    BlockWeights,
    fused_attention_block,
    fused_attention_block_plain,
)
from hig_tpu_torch.ops.pallas_attention import (
    B3_ROUNDINGS,
    CORE_ROUNDINGS,
    b3_bf16_form,
    efficient_attention,
    efficient_attention_bf16_form,
    whole_max_t,
    fused_efficient_attention,
    fused_efficient_attention_plain,
    fused_projected_attention,
    fused_projected_attention_plain,
    weight_pieces,
)

pytestmark = pytest.mark.cuda
N_PAIRS, T, D, H = 8, 91, 512, 8
TOL = 1e-4
REL_TOL = 3e-5
LENGTHS = (91, 80, 64, 91, 33, 70, 12, 50)  # at T = 91; scaled to other T


def assert_close(got, want):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= TOL, err
    assert err <= REL_TOL * scale, (err, scale)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, T=T, pairs=N_PAIRS):
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen)).to(device)

    w = BlockWeights(*(
        1 + randn(D, std=0.1) if name.endswith("_g") else
        randn(D, D, std=D ** -0.5) if name.startswith("w") else randn(D, std=0.1)
        for name in BlockWeights._fields
    ))
    lengths = torch.tensor([max(1, L * T // 91) for L in LENGTHS * -(-pairs // N_PAIRS)][:pairs],
                           device=device)
    mask = (torch.arange(T, device=device) < lengths[:, None]).float()
    mask = mask[:, None, :].expand(pairs, 2, T).contiguous()
    return (w, randn(pairs, 2, T, D), mask, randn(pairs, 2, 1, D, std=0.5),
            randn(pairs, 2, 1, D, std=0.5))


@pytest.mark.parametrize("t", [1, 17, T, 196])
@pytest.mark.parametrize("interaction", [False, True], ids=["self", "interaction"])
def test_fused_block_kernel(cuda, interaction, t):
    w, x, mask, scale, shift = _inputs(cuda, t)
    before = fused_attention_block.launches
    got = fused_attention_block(x, mask, scale, shift, w, H, interaction)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == before + 1
    want = fused_attention_block_plain(x, mask, scale, shift, w, H, interaction)
    assert_close(got, want)


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
def test_projected_attention_kernel(cuda, same_source):
    w, x, mask, _, _ = _inputs(cuda)
    xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
    kv, kmask = (xn, mask) if same_source else (xn.flip(1).contiguous(),
                                               mask.flip(1).contiguous())
    args = (xn, kv, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, kmask)
    before = fused_projected_attention.launches
    got = fused_projected_attention(*args)
    torch.cuda.synchronize()
    assert fused_projected_attention.launches == before + 1
    assert_close(got, fused_projected_attention_plain(*args))


@pytest.mark.parametrize("t", [1, 17, T, 196])
@pytest.mark.parametrize("case", ["self", "partner", "causal", "tq_ne_tk"])
def test_flash_attention_kernel(cuda, case, t):
    """B4 as the quadratic blocks call it: self-attention reads q, k and v
    in place from one merged (..., T, 3D) product, the interaction block k
    and v from a (..., T, 2D) one with partner=True."""
    w, x, mask, _, _ = _inputs(cuda, t)
    Tk = max(1, t * 77 // 91) if case == "tq_ne_tk" else t
    if case == "partner":
        q = torch.nn.functional.linear(x, w.wq, w.bq)
        k, v = torch.nn.functional.linear(
            x, torch.cat([w.wk, w.wv]), torch.cat([w.bk, w.bv])).chunk(2, dim=-1)
    else:
        q, k, v = torch.nn.functional.linear(
            x, torch.cat([w.wq, w.wk, w.wv]), torch.cat([w.bq, w.bk, w.bv])).chunk(3, dim=-1)
    if case == "tq_ne_tk":
        k, v, mask = k[..., :Tk, :].contiguous(), v[..., :Tk, :].contiguous(), mask[..., :Tk]
    args = (q, k, v, H, mask, case == "causal", case == "partner")
    before = flash_attention.launches
    got = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert_close(got, flash_attention_plain(*args))


EVAL_PAIRS, EVAL_T = 52, 196  # an evaluation chunk: the 52-clip test split at T = 196


@pytest.mark.parametrize("case", ["b1_self", "b1_interaction", "b2_self", "b2_partner",
                                  "b4_self", "b4_partner"])
def test_kernels_at_the_evaluation_shape(cuda, case):
    """B1, B2 and B4 as generation calls them in an evaluation chunk: 104
    sequences of 196 tokens (not a multiple of the cores' 32-row tiles),
    ragged lengths."""
    w, x, mask, scale, shift = _inputs(cuda, EVAL_T, EVAL_PAIRS)
    F = torch.nn.functional
    if case.startswith("b1"):
        args = (x, mask, scale, shift, w, H, case == "b1_interaction")
        kernel, plain = fused_attention_block, fused_attention_block_plain
    elif case.startswith("b2"):
        xn = F.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
        kv, kmask = (xn, mask) if case == "b2_self" else (xn.flip(1).contiguous(),
                                                         mask.flip(1).contiguous())
        args = (xn, kv, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, kmask)
        kernel, plain = fused_projected_attention, fused_projected_attention_plain
    else:
        q = F.linear(x, w.wq, w.bq)
        k, v = F.linear(x, torch.cat([w.wk, w.wv]), torch.cat([w.bk, w.bv])).chunk(2, dim=-1)
        args = (q, k, v, H, mask, False, case == "b4_partner")
        kernel, plain = flash_attention, flash_attention_plain
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert_close(got, plain(*args))


@pytest.mark.parametrize("tq,tk,causal,partner", [
    (91, 300, False, False), (91, 300, True, False), (300, 91, True, False),
    (17, 91, True, False), (196, 300, True, True), (300, 600, True, False),
], ids=["tk300", "tk300_causal", "tq300_causal", "tq17_causal", "tq196_tk300_partner",
        "tq300_tk600_causal"])
def test_flash_attention_kernel_key_ranges(cuda, tq, tk, causal, partner):
    """B4 with more keys than one shared-memory tile holds (chunked online
    softmax) and causal with Tq != Tk, with ragged key masks."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((N_PAIRS, 2, n, D), generator=gen).to(cuda) for n in (tq, tk, tk))
    lengths = torch.tensor([max(1, L * tk // 91) for L in LENGTHS], device=cuda)
    mask = (torch.arange(tk, device=cuda) < lengths[:, None]).float()
    mask = mask[:, None, :].expand(N_PAIRS, 2, tk).contiguous()
    args = (q, k, v, H, mask, causal, partner)
    before = flash_attention.launches
    got = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert_close(got, flash_attention_plain(*args))


@pytest.mark.parametrize("Tk", [T, 77])
def test_efficient_attention_kernel(cuda, Tk):
    w, x, mask, _, _ = _inputs(cuda)
    gen = torch.Generator().manual_seed(1)
    k, v = (torch.randn((N_PAIRS, 2, Tk, D), generator=gen).to(cuda) for _ in range(2))
    args = (x, k, v, H, mask[..., :Tk])
    before = fused_efficient_attention.launches
    got = fused_efficient_attention(*args)
    torch.cuda.synchronize()
    assert fused_efficient_attention.launches == before + 1
    assert_close(got, efficient_attention(*args))


WIDTHS_NAMED = "16, 32, 64 and 128"


def test_kernels_refuse_unsupported_shapes(cuda):
    """Head widths other than 16, 32, 64 and 128 (256, and 512 / 6 heads:
    no width) raise, naming the widths taken; so do float64 and strided
    rows."""
    w, x, mask, scale, shift = _inputs(cuda)
    for heads in (2, 6):  # head width 256; D not a multiple of the heads
        with pytest.raises(ValueError, match=WIDTHS_NAMED):
            fused_attention_block(x, mask, scale, shift, w, heads)
        with pytest.raises(ValueError, match=WIDTHS_NAMED):
            fused_projected_attention(x, x, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, heads)
    with pytest.raises(ValueError):  # not contiguous
        fused_attention_block(x.transpose(0, 1), mask, scale, shift, w, H)
    with pytest.raises(ValueError):  # float64
        fused_projected_attention(x.double(), x.double(), w.wq, w.bq, w.wk, w.bk,
                                  w.wv, w.bv, H)
    for kernel in (flash_attention, fused_efficient_attention):
        with pytest.raises(ValueError, match=WIDTHS_NAMED):  # head width 256
            kernel(x, x, x, 2, mask)
        with pytest.raises(ValueError):  # float64
            kernel(x.double(), x.double(), x.double(), H, mask)
        with pytest.raises(ValueError):  # rows not evenly spaced
            kernel(x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1), H)
    with pytest.raises(ValueError):  # partner without an actor axis of 2
        flash_attention(x[:, 0], x[:, 0], x[:, 0], H, partner=True)


# --- bfloat16 forms ----------------------------------------------------------------

BF16 = torch.bfloat16


@pytest.fixture
def cuda_bf16(cuda):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return cuda


def bf16_close(got, twin, twin32, twin_cpu):
    """chip_smoke's kernel gates: (whether ``got`` meets them, the readings)."""
    def rms(t):
        return t.pow(2).mean().sqrt().item()

    d = got.float() - twin.float()
    max_abs, lim = d.abs().max().item(), 2 * 2 ** -8 * twin.float().abs().max().item()
    err, ref = rms(d), rms(twin.float() - twin32)
    floor = rms(twin.float().cpu() - twin_cpu.float())
    ok = got.dtype == BF16 and max_abs <= lim and err <= max(0.25 * ref, 1.5 * floor)
    return ok, (max_abs, lim, err, ref, floor)


def _bf16(t):
    return t.to(BF16)


# case → (form, variant, T, caption pairs)
BF16_CASES = {
    "b1_self": ("b1", "self", T, N_PAIRS),
    "b1_interaction": ("b1", "interaction", T, N_PAIRS),
    "b2_partner": ("b2", "partner", T, N_PAIRS),
    "b4_self": ("b4", "self", T, N_PAIRS),
    "b4_partner": ("b4", "partner", T, N_PAIRS),
    "b4_causal": ("b4", "causal", T, N_PAIRS),
    "b4_two_blocks": ("b4", "self", 196, N_PAIRS),
    "b1_self_t1": ("b1", "self", 1, N_PAIRS),
    "b1_interaction_t1": ("b1", "interaction", 1, N_PAIRS),
    "b1_self_t17": ("b1", "self", 17, N_PAIRS),
    "b1_interaction_t17": ("b1", "interaction", 17, N_PAIRS),
    "b1_self_t196": ("b1", "self", 196, N_PAIRS),
    "b1_interaction_t196": ("b1", "interaction", 196, N_PAIRS),
    "b1_self_eval": ("b1", "self", EVAL_T, EVAL_PAIRS),
    "b1_interaction_eval": ("b1", "interaction", EVAL_T, EVAL_PAIRS),
    "b4_partner_t196": ("b4", "partner", 196, N_PAIRS),
    "b4_causal_t196": ("b4", "causal", 196, N_PAIRS),
    "b4_tq91_tk77": ("b4", "tq_tk77", T, N_PAIRS),
    "b2_partner_t196": ("b2", "partner", 196, N_PAIRS),
    "b2_self": ("b2", "self", T, N_PAIRS),
    "b2_self_t196": ("b2", "self", 196, N_PAIRS),
    "b2_self_t320": ("b2", "self", 320, N_PAIRS),
    "b2_partner_t320": ("b2", "partner", 320, N_PAIRS),
    # B2-bf16 streams its keys, so it takes any T: a --single_transformer
    # model's merged timeline (two actors' masks end to end) at the
    # evaluation length is 392 rows
    "b2_self_t321": ("b2", "self", 321, N_PAIRS),
    "b2_self_t392": ("b2", "self", 392, N_PAIRS),
    "b2_partner_t392": ("b2", "partner", 392, N_PAIRS),
    "b2_merged_t392": ("b2", "merged", 196, N_PAIRS),
    "b2_merged_eval": ("b2", "merged", EVAL_T, EVAL_PAIRS),
    "b2_self_t512": ("b2", "self", 512, N_PAIRS),
    # the edges of its 128-row rounds
    "b2_self_t1": ("b2", "self", 1, N_PAIRS),
    "b2_self_t129": ("b2", "self", 129, N_PAIRS),
    "b3_self": ("b3", "self", T, N_PAIRS),
    "b3_tq91_tk77": ("b3", "tq_tk77", T, N_PAIRS),
    "b3_tq196_tk77": ("b3", "tq_tk77", 196, N_PAIRS),
    "b3_self_t1": ("b3", "self", 1, N_PAIRS),
    "b3_self_t17": ("b3", "self", 17, N_PAIRS),
    "b3_self_t196": ("b3", "self", 196, N_PAIRS),
    "b3_self_t320": ("b3", "self", 320, N_PAIRS),
    # past 320 rows the streaming form: a --single_transformer model's
    # merged timeline at a native window of 196 (394) and at the evaluation
    # length (392), more queries than the whole form holds over 77 keys, and
    # 91 queries over 394 keys
    "b3_self_t394": ("b3", "self", 394, N_PAIRS),
    "b3_self_t392": ("b3", "self", 392, N_PAIRS),
    "b3_tq321_tk77": ("b3", "tq_tk77", 321, N_PAIRS),
    "b3_tq91_tk394": ("b3", "tq91", 394, N_PAIRS),
    # B1-bf16's streaming form past its whole form's 320 rows
    "b1_self_t394": ("b1", "self", 394, N_PAIRS),
    "b1_interaction_t600": ("b1", "interaction", 600, N_PAIRS),
    # head width 128 (4 heads of 128 at D = 512): every form, B1-bf16,
    # B2-bf16a's and B3-bf16's whole forms up to 128 rows and their
    # streaming forms past them (197: the evaluation length plus one)
    "b1_self_hd128": ("b1", "self", T, N_PAIRS, D // 128),
    "b1_interaction_hd128": ("b1", "interaction", T, N_PAIRS, D // 128),
    "b1_self_t197_hd128": ("b1", "self", 197, N_PAIRS, D // 128),
    "b2_self_hd128": ("b2", "self", T, N_PAIRS, D // 128),
    "b2_partner_t197_hd128": ("b2", "partner", 197, N_PAIRS, D // 128),
    "b3_self_hd128": ("b3", "self", T, N_PAIRS, D // 128),
    "b3_tq91_tk77_hd128": ("b3", "tq_tk77", T, N_PAIRS, D // 128),
    "b3_self_t197_hd128": ("b3", "self", 197, N_PAIRS, D // 128),
    "b3_self_t394_hd128": ("b3", "self", 394, N_PAIRS, D // 128),
    "b4_self_hd128": ("b4", "self", T, N_PAIRS, D // 128),
    "b4_partner_t196_hd128": ("b4", "partner", 196, N_PAIRS, D // 128),
    "b4_causal_hd128": ("b4", "causal", T, N_PAIRS, D // 128),
}
# head widths 16 and 32 (32 and 16 heads at D = 512, packed 4 and 2 to a
# 64-column tile): every form, B1-bf16's streaming form past 320 rows,
# B3-bf16's past 320 queries and keys
for _hd in (16, 32):
    BF16_CASES.update({f"{name}_hd{_hd}": (*case, D // _hd) for name, case in {
        "b1_self": ("b1", "self", T, N_PAIRS),
        "b1_interaction": ("b1", "interaction", T, N_PAIRS),
        "b1_self_t394": ("b1", "self", 394, N_PAIRS),
        "b2_self": ("b2", "self", T, N_PAIRS),
        "b2_partner_t196": ("b2", "partner", 196, N_PAIRS),
        "b3_self": ("b3", "self", T, N_PAIRS),
        "b3_tq91_tk77": ("b3", "tq_tk77", T, N_PAIRS),
        "b3_self_t394": ("b3", "self", 394, N_PAIRS),
        "b4_self": ("b4", "self", T, N_PAIRS),
        "b4_partner_t196": ("b4", "partner", 196, N_PAIRS),
        "b4_causal": ("b4", "causal", T, N_PAIRS),
    }.items()})


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_forms_match_their_twins(cuda_bf16, case):
    form, variant, t, pairs, *heads = BF16_CASES[case]
    H = heads[0] if heads else globals()["H"]
    w, x, mask, scale, shift = _inputs(cuda_bf16, t, pairs)
    wb = BlockWeights(*[_bf16(a) for a in w])
    xb = _bf16(x)
    if form == "b1":
        fn, plain, counter = fused_attention_block, fused_attention_block_plain, \
            fused_attention_block
        args = (xb, mask, _bf16(scale), _bf16(shift), wb, H, variant == "interaction")
    elif form == "b2":
        fn, plain, counter = fused_projected_attention, fused_projected_attention_plain, \
            fused_projected_attention
        xn = _bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
        if variant == "merged":  # (pairs, 2T): both actors on one timeline
            xn, mask = xn.reshape(pairs, 2 * t, D), mask.reshape(pairs, 2 * t)
        kv, kmask = (xn, mask) if variant != "partner" else (xn.flip(1).contiguous(),
                                                             mask.flip(1).contiguous())
        args = (xn, kv, wb.wq, wb.bq, wb.wk, wb.bk, wb.wv, wb.bv, H, kmask)
    elif form == "b3":
        fn, plain, counter = fused_efficient_attention, fused_efficient_attention_plain, \
            fused_efficient_attention
        q, k, v = (torch.nn.functional.linear(xb, torch.cat([wb.wq, wb.wk, wb.wv]))
                   + torch.cat([wb.bq, wb.bk, wb.bv])).chunk(3, dim=-1)
        tk = 77 if variant == "tq_tk77" else t
        tq = 91 if variant == "tq91" else t
        args = (q[..., :tq, :].contiguous(), k[..., :tk, :].contiguous(),
                v[..., :tk, :].contiguous(), H, mask[..., :tk].contiguous())
    else:
        fn, plain, counter = flash_attention, flash_attention_plain, flash_attention
        qkv = (torch.nn.functional.linear(xb, torch.cat([wb.wq, wb.wk, wb.wv]))
               + torch.cat([wb.bq, wb.bk, wb.bv]))
        q, k, v = qkv.chunk(3, dim=-1)
        if variant == "tq_tk77":  # 91 queries over 77 keys
            q, k, v, mask = (q.contiguous(), k[..., :77, :].contiguous(),
                             v[..., :77, :].contiguous(), mask[..., :77].contiguous())
        args = (q, k, v, H, mask, variant == "causal", variant == "partner")
    stream = (form == "b1" and t > whole_max_t(D // H)) or \
        (form == "b3" and b3_bf16_form(tq, tk, D // H) == "stream")
    before = counter.launches_bf16_stream if stream else counter.launches_bf16
    before_f32 = counter.launches
    got = fn(*args)
    torch.cuda.synchronize()
    after = counter.launches_bf16_stream if stream else counter.launches_bf16
    assert (after, counter.launches) == (before + 1, before_f32)
    args32 = tuple(a.float() if torch.is_tensor(a) else a for a in args)
    cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    if form == "b1":
        args32 = args32[:4] + (BlockWeights(*[a.float() for a in wb]),) + args32[5:]
        cpu = cpu[:4] + (BlockWeights(*[a.cpu() for a in wb]),) + cpu[5:]
    twin, twin32, twin_cpu = plain(*args), plain(*args32), plain(*cpu)
    ok, readings = bf16_close(got, twin, twin32, twin_cpu)
    assert ok, readings
    if form == "b1" and t >= T:
        # planted controls: the twin without one core rounding fails the gates
        # (at T = 1 softmax_time(k) is exactly 1, so leaving its rounding out
        # changes nothing)
        for left_out in ("kh", "v", "att", "qh"):
            ok, readings = bf16_close(plain(*args, unrounded=(left_out,)), twin, twin32,
                                      twin_cpu)
            assert not ok, (left_out, readings)
    if form == "b3":
        # planted controls; at T = 1 softmax_time(k) is exactly 1 and the
        # state is the one bfloat16 v row, so the key side's roundings and
        # the state's change nothing there, and only the feature softmax's
        # are planted (on the CPU they read 0.62-1.03 of the bf16 effect
        # at T = 1 against the 0.25 limit)
        key_side = ("k_sub", "k_exp", "k_sum", "kh", "att")
        for left_out in (r for r in B3_ROUNDINGS if t > 1 or r not in key_side):
            ok, readings = bf16_close(plain(*args, unrounded=(left_out,)), twin, twin32,
                                      twin_cpu)
            assert not ok, (left_out, readings)
    if form == "b2" and t > 1:
        # the twin with B1-bf16's core roundings: B2's core must be float32
        # (at T = 1 the state is the one v row, whose rounding is y's)
        ok, readings = bf16_close(plain(*args, rounded=CORE_ROUNDINGS), twin, twin32, twin_cpu)
        assert not ok, readings


def test_bf16_block_refuses_long_sequences(cuda_bf16):
    """B1-bf16's whole form keeps one sequence's keys in shared memory: T up
    to 320 at head width 64 (128 at 128), and refuses more when asked for;
    past that the block takes its streaming form (one counted launch)."""
    for t, heads in ((321, H), (129, D // 128)):
        w, x, mask, scale, shift = _inputs(cuda_bf16, t, 1)
        args = (_bf16(x), mask, _bf16(scale), _bf16(shift),
                BlockWeights(*[_bf16(a) for a in w]), heads)
        with pytest.raises(ValueError, match="no form 'whole'"):
            fused_attention_block(*args, form="whole")
        before = (fused_attention_block.launches_bf16, fused_attention_block.launches_bf16_stream)
        got = fused_attention_block(*args)
        torch.cuda.synchronize()
        assert (fused_attention_block.launches_bf16,
                fused_attention_block.launches_bf16_stream) == (before[0], before[1] + 1)
        assert torch.isfinite(got.float()).all()


def test_bf16_projected_takes_long_sequences(cuda_bf16):
    """B2-bf16 streams its keys: it takes T = 321 and 1000 rows (past any
    shared memory) and counts each launch; B2-bf16a's whole form, which
    holds one sequence's keys, refuses T = 321 when asked for."""
    for t in (321, 1000):
        w, x, mask, _, _ = _inputs(cuda_bf16, t, 1)
        wb = BlockWeights(*[_bf16(a) for a in w])
        xb = _bf16(x)
        before = fused_projected_attention.launches_bf16
        got = fused_projected_attention(xb, xb, wb.wq, wb.bq, wb.wk, wb.bk, wb.wv, wb.bv, H,
                                        mask)
        torch.cuda.synchronize()
        assert fused_projected_attention.launches_bf16 == before + 1
        assert got.shape == xb.shape and torch.isfinite(got.float()).all()
    with torch.no_grad(), pytest.raises(ValueError, match="no form 'whole'"):
        fused_projected_attention(xb[..., :321, :].contiguous(), xb[..., :321, :].contiguous(),
                                  w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, mask[..., :321],
                                  form="whole")


def _b3_bf16_operands(device, tq, tk, seed=2, one_key=False):
    """Seeded bfloat16 q, k, v and a key mask of LENGTHS scaled to tk (the
    first pair's to one key with ``one_key``)."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((N_PAIRS, 2, tq, D), generator=gen).to(device, BF16)
    k, v = (torch.randn((N_PAIRS, 2, tk, D), generator=gen).to(device, BF16) for _ in range(2))
    lengths = torch.tensor([1 if one_key and i == 0 else max(1, L * tk // 91)
                            for i, L in enumerate(LENGTHS)], device=device)
    mask = (torch.arange(tk, device=device) < lengths[:, None]).float()
    return q, k, v, mask[:, None, :].expand(N_PAIRS, 2, tk).contiguous()


@pytest.mark.parametrize("tq,tk", [(394, 394), (321, 77), (91, 394), (640, 640), (1000, 1000)])
def test_bf16_efficient_streams_long_sequences(cuda_bf16, tq, tk):
    """Past 320 queries or keys B3-bf16 takes its streaming form, one
    launch counted in ``launches_bf16_stream``, within the gates of its
    twin; past 448 keys (640, 1000)
    the keys stream through its ring, as they no longer fit in shared
    memory beside it."""
    q, k, v, mask = _b3_bf16_operands(cuda_bf16, tq, tk)
    assert b3_bf16_form(tq, tk) == "stream"
    before = (fused_efficient_attention.launches_bf16,
              fused_efficient_attention.launches_bf16_stream)
    got = fused_efficient_attention(q, k, v, H, mask)
    torch.cuda.synchronize()
    assert (fused_efficient_attention.launches_bf16,
            fused_efficient_attention.launches_bf16_stream) == (before[0], before[1] + 1)
    args = (q, k, v, H, mask)
    twin = fused_efficient_attention_plain(*args)
    twin32 = fused_efficient_attention_plain(q.float(), k.float(), v.float(), H, mask)
    twin_cpu = fused_efficient_attention_plain(*(a.cpu() if torch.is_tensor(a) else a
                                                 for a in args))
    ok, readings = bf16_close(got, twin, twin32, twin_cpu)
    assert ok, readings


# B3-bf16's streaming form's ring edges (a key or query tile full, one row
# past, one short; the fourth and fifth tiles), Tq != Tk both ways, and a
# sequence whose mask keeps one key: (tq, tk, one_key)
B3_EDGES = [(t, t, False) for t in (63, 64, 65, 127, 128, 129, 191, 257)] + [
    (65, 257, False), (257, 65, False), (91, 91, True)]


def _edge_id(case) -> str:
    tq, tk, one_key = case
    return f"{tq}-{tk}" + ("-one_key" if one_key else "")


FORM_CASES = [(1, 1, False), (17, 17, False), (91, 91, False), (91, 77, False),
              (196, 196, False), (320, 320, False), (320, 129, False), *B3_EDGES]


@pytest.mark.parametrize("tq,tk,one_key", FORM_CASES, ids=[_edge_id(c) for c in FORM_CASES])
def test_bf16_efficient_stream_form_is_the_whole_form(cuda_bf16, tq, tk, one_key):
    """The streaming form rounds at the whole form's points and sums in its
    order, so where both run they agree bit for bit."""
    q, k, v, mask = _b3_bf16_operands(cuda_bf16, tq, tk, seed=3, one_key=one_key)
    whole = efficient_attention_bf16_form(q, k, v, H, mask, "whole")
    stream = efficient_attention_bf16_form(q, k, v, H, mask, "stream")
    torch.cuda.synchronize()
    assert torch.equal(whole, stream)
    q, k, v, mask = _b3_bf16_operands(cuda_bf16, 321, 8)
    with pytest.raises(ValueError, match="no form"):
        efficient_attention_bf16_form(q, k, v, H, mask, "whole")


LAZY_CASES = [(91, 91, False), (91, 77, False), (196, 196, False), (394, 394, False),
              *B3_EDGES]


@pytest.mark.parametrize("tq,tk,one_key", LAZY_CASES, ids=[_edge_id(c) for c in LAZY_CASES])
def test_bf16_lazy_forms_are_their_twin(cuda_bf16, tq, tk, one_key):
    """B3-bf16's lazy forms (``LAZY_KNORM``): one counted launch in
    ``launches_bf16_lazy``, the whole and streaming forms equal bit for bit
    where both run, within the gates of the lazy twin, where the eager
    twin sits off them; the float32 kernel, unchanged, is within TOL of
    the lazy float32 twin."""
    q, k, v, mask = _b3_bf16_operands(cuda_bf16, tq, tk, seed=4, one_key=one_key)
    args = (q, k, v, H, mask)
    before = fused_efficient_attention.launches_bf16_lazy
    got = fused_efficient_attention(*args, lazy=True)
    torch.cuda.synchronize()
    assert fused_efficient_attention.launches_bf16_lazy == before + 1
    if max(tq, tk) <= 320:
        whole = efficient_attention_bf16_form(*args, "whole", lazy=True)
        stream = efficient_attention_bf16_form(*args, "stream", lazy=True)
        assert torch.equal(whole, got) and torch.equal(stream, got)
    twin = fused_efficient_attention_plain(*args, lazy=True)
    twin32 = fused_efficient_attention_plain(q.float(), k.float(), v.float(), H, mask,
                                             lazy=True)
    twin_cpu = fused_efficient_attention_plain(*(a.cpu() if torch.is_tensor(a) else a
                                                 for a in args), lazy=True)
    ok, readings = bf16_close(got, twin, twin32, twin_cpu)
    assert ok, readings
    ok, _ = bf16_close(fused_efficient_attention_plain(*args), twin, twin32, twin_cpu)
    assert not ok
    f32 = tuple(a.float() for a in (q, k, v))
    before = fused_efficient_attention.launches
    got32 = fused_efficient_attention(*f32, H, mask, lazy=True)
    assert fused_efficient_attention.launches == before + 1
    assert_close(got32, efficient_attention(*f32, H, mask, lazy=True))


def test_b3_softmax_division_is_ieee_over_its_domain(cuda):
    """B3-bf16's softmax quotients (a bfloat16 exponential over a rounded
    sum) take a remainder correction of the correctly rounded reciprocal
    in place of the IEEE division where ``b3_div_ok`` holds: over every such
    pair of bfloat16 values x in [0, 1] and s in [1, 2^16] the two agree
    bit for bit."""
    from hig_tpu_torch.ops import _build

    mismatches = torch.zeros(1, dtype=torch.int32, device=cuda)
    _build.launch("efficient_attention", (mismatches,), (),
                  torch.cuda.current_stream(cuda).cuda_stream, entry="b3_division_mismatches")
    assert int(mismatches.item()) == 0


def test_lazy_flag_keys_the_sampler_graphs(cuda):
    """A sampler captures one graph per value of ``LAZY_KNORM`` and never
    replays one under the other."""
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models import attention as tatt
    from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
    from hig_tpu_torch.models.text_encoder import ClipTextConfig
    from hig_tpu_torch.train import trainer as tt

    cfg = ModelConfig(num_layers=1, latent_dim=128, num_heads=2, text_latent_dim=64,
                      text_ff_size=128, ff_size=256, cap_id=True,
                      clip=ClipTextConfig(width=32, heads=2, layers=1))
    model = InteractionModel(cfg).to(cuda).eval()
    sample = tt.make_sampler(model, g.make_schedule(g.linear_betas(100)), 20, 263, "ddim", 3)
    cond, lengths = torch.zeros((2, 2), dtype=torch.long), torch.tensor([20, 11])
    noise = torch.randn((2, 2, 20, 263), generator=torch.Generator().manual_seed(0))
    try:
        first = sample(cond, lengths, noise=noise)
        tatt.LAZY_KNORM = True
        sample(cond, lengths, noise=noise)
    finally:
        tatt.LAZY_KNORM = False
    assert sorted(key[-1] for key in sample.graphs) == [False, True]
    assert torch.equal(sample(cond, lengths, noise=noise), first)


def test_bf16_without_a_form_raises(cuda_bf16):
    """No form takes bfloat16 beside float32 operands."""
    w, x, mask, scale, shift = _inputs(cuda_bf16)
    xb = _bf16(x)
    for mixed in ((xb, x, x), (x, xb, xb), (xb, xb, x)):  # mixed dtypes
        with pytest.raises(ValueError, match="all bfloat16"):
            fused_efficient_attention(*mixed, H, mask)
    with pytest.raises(ValueError):  # float32 weights
        fused_attention_block(xb, mask, _bf16(scale), _bf16(shift), w, H)
    wb = BlockWeights(*[_bf16(a) for a in w])
    with pytest.raises(ValueError):  # bfloat16 weights on float32 activations
        fused_projected_attention(x, x, wb.wq, wb.bq, wb.wk, wb.bk, wb.wv, wb.bv, H, mask)
    with pytest.raises(ValueError):  # float32 keys
        flash_attention(xb, x, x, H, mask)


# --- gradients ---------------------------------------------------------------------


def _grads(fn, inputs, seed=3):
    out = fn()
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(out.device)
    return out, torch.autograd.grad(out, inputs, g)


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        assert_close(a, b)


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
def test_projected_attention_gradients(cuda, same_source):
    """B2 under autograd: gradients to x (through LayerNorm, twice over when
    kv_src is q_src) and to the q/k/v weights and biases."""
    w, x, mask, _, _ = _inputs(cuda)
    leaves = [x.requires_grad_(), w.wq.requires_grad_(), w.bq.requires_grad_(),
              w.wk.requires_grad_(), w.wv.requires_grad_(), w.bv.requires_grad_()]

    def run(fn):
        xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
        kv, kmask = (xn, mask) if same_source else (xn.flip(1), mask.flip(1))
        return fn(xn, kv, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, kmask)

    before = fused_projected_attention.launches
    out, got = _grads(lambda: run(fused_projected_attention), leaves)
    assert out.grad_fn is not None
    assert fused_projected_attention.launches == before + 1
    _, want = _grads(lambda: run(fused_projected_attention_plain), leaves)
    _assert_grads_close(got, want)


RECT_FORMS = ("f32", "bf16", "bf16a")


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
@pytest.mark.parametrize("form", RECT_FORMS)
def test_rectangular_projected_attention(cuda, form, same_source):
    """B2's rectangular form: a tensor-parallel rank's (D/2, D) q|k|v
    weights at H/2 heads (rank 1's rows), each form against its plain twin
    (float32 within TOL and REL_TOL; bfloat16 and bfloat16 activations on
    float32 weights under the bfloat16 gates), counted in
    ``launches_rect`` alone; float32 and bfloat16 gradients through
    its recompute backward equal the plain route's."""
    w, x, mask, _, _ = _inputs(cuda)
    half = slice(D // 2, D)
    ws = [t[half].contiguous() for t in (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)]
    xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
    if form != "f32":
        xn = _bf16(xn)
    if form == "bf16":
        ws = [_bf16(t) for t in ws]
    kv, kmask = (xn, mask) if same_source else (xn.flip(1).contiguous(),
                                                mask.flip(1).contiguous())
    args = (xn, kv, *ws, H // 2, kmask)
    counts = dict(torch_counts := {a: getattr(fused_projected_attention, a) for a in
                                   ("launches", "launches_bf16", "launches_mixed",
                                    "launches_rect")})
    with torch.no_grad():
        got = fused_projected_attention(*args)
        torch.cuda.synchronize()
    counts["launches_rect"] += 1
    assert {a: getattr(fused_projected_attention, a) for a in torch_counts} == counts
    assert got.shape == (*x.shape[:-1], D // 2)
    twin = fused_projected_attention_plain(*args)
    if form == "f32":
        assert_close(got, twin)
    else:
        twin32 = fused_projected_attention_plain(xn.float(), kv.float(),
                                                 *[t.float() for t in ws], H // 2, kmask)
        cpu = fused_projected_attention_plain(*[a.cpu() if torch.is_tensor(a) else a
                                                for a in args])
        ok, readings = bf16_close(got, twin, twin32, cpu)
        assert ok, readings
    if form == "bf16a":
        return  # no backward (JAX's VJP of this form fails too)
    leaves = [t.detach().requires_grad_() for t in ws]

    def run(fn):
        return fn(xn, kv, *leaves, H // 2, kmask)

    _, got = _grads(lambda: run(fused_projected_attention), leaves)
    _, want = _grads(lambda: run(fused_projected_attention_plain), leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # the backward recomputes the plain version


def test_two_gloo_ranks_on_one_card_take_the_one_rank_step(cuda, tmp_path):
    """Two ranks share cuda:0 over gloo (NCCL refuses two ranks on one
    device): a DP PIT step pair at heads of 64 (tests/_torch_parallel_worker.py),
    losses and gradient norms equal across ranks and within rtol 1e-5 of
    the one-rank eager step on the card, each rank launching B2 once per
    self-attention and interaction block a step."""
    import json
    import socket
    import subprocess
    import sys

    from tests import _torch_parallel_worker as w
    from hig_tpu_torch.train import trainer as tt

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [open(tmp_path / f"log{r}.txt", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, w.__file__, str(r), "2", port, str(tmp_path),
                               "cuda"], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            p.kill()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, open(tmp_path / f"log{r}.txt").read()[-3000:]
    got = [json.load(open(tmp_path / f"card{r}.json")) for r in range(2)]
    assert got[0]["losses"] == got[1]["losses"]
    assert [(g["backend"], g["device"]) for g in got] == [("gloo", "cuda:0")] * 2
    layers = w.CARD["num_layers"]
    assert [g["launches"] for g in got] == [w.STEPS * layers * 2] * 2
    trainer = tt.Trainer(w.cfg_of(str(tmp_path), w.CARD), "cuda", w.CLIP, graph=False)
    want = w.run_steps(trainer, trainer.init_state(), [w.step_inputs(i) for i in range(w.STEPS)])
    np.testing.assert_allclose(got[0]["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("Tk", [T, 77])
def test_efficient_attention_gradients(cuda, Tk):
    _, x, mask, _, _ = _inputs(cuda)
    gen = torch.Generator().manual_seed(1)
    k, v = (torch.randn((N_PAIRS, 2, Tk, D), generator=gen).to(cuda).requires_grad_()
            for _ in range(2))
    q = x.requires_grad_()
    out, got = _grads(lambda: fused_efficient_attention(q, k, v, H, mask[..., :Tk]), (q, k, v))
    assert out.grad_fn is not None
    _, want = _grads(lambda: efficient_attention(q, k, v, H, mask[..., :Tk]), (q, k, v))
    _assert_grads_close(got, want)


@pytest.mark.parametrize("Tk,pairs", [(T, N_PAIRS), (77, N_PAIRS), (T, 64)],
                         ids=["t91", "tk77", "train_shape"])
def test_efficient_attention_bf16_gradients(cuda_bf16, Tk, pairs):
    """B3-bf16 under autograd (the core of every bfloat16 efficient train
    step; the training shape is a PIT step's 32 pairs under both caption
    assignments): its backward is XLA's bfloat16 VJP of the core, which the
    plain route's backward is too, so the gradients equal the plain route's
    on the card, and the same backward on the CPU within one bfloat16 ulp of
    its largest magnitude (float32 sums in another order)."""
    _, x, mask, _, _ = _inputs(cuda_bf16, pairs=pairs)
    gen = torch.Generator().manual_seed(1)
    k, v = (torch.randn((pairs, 2, Tk, D), generator=gen).to(cuda_bf16, BF16).requires_grad_()
            for _ in range(2))
    q = _bf16(x).requires_grad_()
    m = mask[..., :Tk]
    before = fused_efficient_attention.launches_bf16
    out, got = _grads(lambda: fused_efficient_attention(q, k, v, H, m), (q, k, v))
    assert out.grad_fn is not None and out.dtype == BF16
    assert fused_efficient_attention.launches_bf16 == before + 1
    _, want = _grads(lambda: fused_efficient_attention_plain(q, k, v, H, m), (q, k, v))
    leaves = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    _, cpu = _grads(lambda: fused_efficient_attention_plain(*leaves, H, m.cpu()), leaves)
    for a, b, c in zip(got, want, cpu):
        assert a.dtype == BF16
        assert torch.equal(a, b)
        err = (a.float().cpu() - c.float()).abs().max().item()
        assert err <= 2 ** -8 * c.float().abs().max().item(), err


# The ordered bfloat16 sum over the axes the bfloat16 backwards sum at the
# training shape (64 pairs, 8 heads of 64): B3-bf16's feature and time
# softmaxes, B4-bf16's key softmax (at T = 196 too); one term; the most terms
# the kernel takes; a transposed (non-contiguous) input; the padding's two
# ends (33, 95, 97 terms, strided and contiguous); contiguous rows that fill
# no last block (1001 rows of 64 terms, 128 a block); 394 terms 512 apart (a
# --single_transformer step's time softmax).
SUM_CASES = {"features": ((64, 2, T, H, 64), -1), "time": ((64, 2, T, H, 64), -3),
             "keys": ((64, 2, T, T, H), -2), "keys_t196": ((8, 2, 196, 196, H), -2),
             "one_term": ((4, 1, 8), 1), "max_terms": ((3, ONE_LAUNCH_TERMS, 5), 1),
             # past one launch's two levels of windows: 1025 and 4096 terms,
             # strided and contiguous
             "n1025": ((3, 1025, 5), 1), "n4096": ((2, 4096, 3), 1),
             "n4096_rows": ((5, 4096), 1),
             "transposed": ((6, 40, 33), 1), "n33": ((6, 33, 40), 1), "n95": ((6, 95, 40), 1),
             "n97": ((6, 97, 40), 1), "n33_rows": ((301, 33), 1), "n95_rows": ((301, 95), 1),
             "n97_rows": ((301, 97), 1), "ragged_rows": ((1001, 64), 1),
             "t394_stride512": ((4, 394, 512), 1)}


@pytest.mark.parametrize("case", list(SUM_CASES))
def test_bf16_sum_kernel_is_its_plain_version(cuda, case):
    """The ordered bfloat16 sum's kernel against its plain version on the
    card and on the CPU, bit for bit: the same float32 adds, each rounded
    to bfloat16, in the same order. Each launch counted: one up to 1024
    terms, one more a further level of windows."""
    shape, dim = SUM_CASES[case]
    gen = torch.Generator().manual_seed(7)
    x = (1e-2 * torch.randn(shape, generator=gen)).to(BF16).float().to(cuda)
    if case == "transposed":
        x = x.transpose(1, 2)
    before = bf16_sum.launches
    got = bf16_sum(x, dim)
    assert bf16_sum.launches == before + 1 + len(scratch_levels(x.shape[dim]))
    assert got.dtype == torch.float32 and got.shape[dim] == 1
    assert torch.equal(got, bf16_sum_plain(x, dim))
    assert torch.equal(got.cpu(), bf16_sum_plain(x.cpu(), dim))


def test_bf16_sum_kernel_refuses_what_it_does_not_take(cuda):
    """It takes any number of terms, in float32 holding bfloat16 values only."""
    for dtype in (BF16, torch.float64):
        with pytest.raises(ValueError, match="float32"):
            bf16_sum(torch.zeros(2, 8, device=cuda, dtype=dtype), 1)


# label: a labeling vote's 64 pairs under both assignments; eval: a chunk of 52 pairs
MIXED_SHAPES = {"serve": (T, N_PAIRS), "label": (T, 128), "eval": (196, 52),
                "t1": (1, N_PAIRS), "t17": (17, N_PAIRS), "t196": (196, N_PAIRS),
                "t320": (320, N_PAIRS),
                # its streaming form past the whole form's rows
                "t394": (394, N_PAIRS), "t600": (600, N_PAIRS),
                # head width 128: the whole form, and streaming past 128 rows
                "serve_hd128": (T, N_PAIRS, D // 128), "t197_hd128": (197, N_PAIRS, D // 128),
                # widths 16 and 32: the whole form, and streaming past 320 rows
                "serve_hd16": (T, N_PAIRS, D // 16), "t394_hd16": (394, N_PAIRS, D // 16),
                "serve_hd32": (T, N_PAIRS, D // 32), "t394_hd32": (394, N_PAIRS, D // 32)}


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
@pytest.mark.parametrize("shape", list(MIXED_SHAPES))
def test_mixed_projected_attention_matches_its_twin(cuda_bf16, shape, same_source):
    """B2-bf16a: bfloat16 activations with float32 weights, under the
    bfloat16 forms' gates against its twin; the twin with B1-bf16's core
    roundings fails them (from T = 17: with one key that twin reads as the
    kernel's own)."""
    t, pairs, *heads = MIXED_SHAPES[shape]
    H = heads[0] if heads else globals()["H"]
    w, x, mask, _, _ = _inputs(cuda_bf16, t, pairs)
    xn = _bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
    kv, kmask = (xn, mask) if same_source else (xn.flip(1).contiguous(),
                                                mask.flip(1).contiguous())
    args = (xn, kv, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, kmask)
    stream = t > whole_max_t(D // H)

    def counts():
        f = fused_projected_attention
        return (f.launches_mixed_stream if stream else f.launches_mixed, f.launches_bf16,
                f.launches)

    before = counts()
    with torch.no_grad():
        got = fused_projected_attention(*args)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, *before[1:])
        twin = fused_projected_attention_plain(*args)
        twin32 = fused_projected_attention_plain(xn.float(), kv.float(), *args[2:])
        cpu = fused_projected_attention_plain(*[a.cpu() if torch.is_tensor(a) else a
                                                for a in args])
        ok, readings = bf16_close(got, twin, twin32, cpu)
        assert ok, readings
        if t > 1:
            control = fused_projected_attention_plain(*args, rounded=CORE_ROUNDINGS)
            ok, readings = bf16_close(control, twin, twin32, cpu)
            assert not ok, readings


def test_mixed_projected_attention_refuses_long_sequences(cuda_bf16):
    """B2-bf16a's whole form keeps one sequence's keys in shared memory: T
    up to 320, and refuses more when asked for; past that B2-bf16a takes its
    streaming form, counted in ``launches_mixed_stream``."""
    w, x, mask, _, _ = _inputs(cuda_bf16, 321, 1)
    xb = _bf16(x)
    args = (xb, xb, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, mask)
    with torch.no_grad():
        with pytest.raises(ValueError, match="no form 'whole'"):
            fused_projected_attention(*args, form="whole")
        before = (fused_projected_attention.launches_mixed,
                  fused_projected_attention.launches_mixed_stream)
        got = fused_projected_attention(*args)
        torch.cuda.synchronize()
    assert (fused_projected_attention.launches_mixed,
            fused_projected_attention.launches_mixed_stream) == (before[0], before[1] + 1)
    assert torch.isfinite(got.float()).all()


def test_weight_split_kernel_is_its_plain_version(cuda):
    """B2-bf16a's weight split on the card against the plain split, bit for
    bit: seeded block weights with edge values written in (signed zeros,
    tiny and huge magnitudes, bfloat16 rounding ties). One launch, counted."""
    w = _inputs(cuda)[0]
    edges = torch.tensor([0.0, -0.0, 2.0 ** -126, 2.0 ** -100 * (1 + 2.0 ** -23), 3e38,
                          -3.38e38, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -9 + 2.0 ** -17,
                          -(1 + 2.0 ** -8)], device=cuda)
    ws = [a.clone() for a in (w.wq, w.wk, w.wv)]
    for i, a in enumerate(ws):
        a.view(-1)[i::97][:len(edges)] = edges
    before = weight_pieces.launches
    got = weight_pieces(*ws)
    torch.cuda.synchronize()
    assert weight_pieces.launches == before + 1
    want = weight_pieces(*[a.cpu() for a in ws])
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


# --- head width 128 and the streaming forms ----------------------------------------

H128 = D // 128  # 4 heads of 128


FLOAT32_WIDTH_CASES = ["b1_self", "b1_interaction", "b2_self", "b2_partner", "b3_t91",
                       "b3_tk77", "b4_self", "b4_partner", "b4_causal", "b4_tq_ne_tk",
                       "b4_tk300"]


@pytest.mark.parametrize("case", FLOAT32_WIDTH_CASES)
def test_float32_kernels_at_head_width_128(cuda, case):
    """B1, B2, B3 and B4 in float32 at head width 128 (the library built
    with HIG_HD = 128), one counted launch each, within TOL and REL_TOL of
    their plain versions at the serving shape (B4 also over 300 keys, past
    its shared-memory tile of 128)."""
    float32_kernel_case(cuda, case, H128)


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("case", FLOAT32_WIDTH_CASES)
def test_float32_kernels_at_narrow_head_widths(cuda, case, hd):
    """The same at head widths 16 and 32 (32 and 16 heads at D = 512; B4
    over 300 keys, past its tile of 256)."""
    float32_kernel_case(cuda, case, D // hd)


@pytest.mark.parametrize("variant", ["self", "partner", "causal"])
@pytest.mark.parametrize("t", [T, 196, 394])
def test_b4_pairs_at_head_width_128(cuda, t, variant):
    """B4 at head width 128 gives each 16-row query tile a pair of warps
    that sum their partial scores in shared memory: at 91, 196 and 394 rows
    (over one, two and four tiles of 128 resident keys), self, partner and
    causal, within TOL and REL_TOL of its plain version."""
    w, x, mask, _, _ = _inputs(cuda, t)
    q, k, v = torch.nn.functional.linear(x, torch.cat([w.wq, w.wk, w.wv]),
                                         torch.cat([w.bq, w.bk, w.bv])).chunk(3, dim=-1)
    args = (q, k, v, H128, mask, variant == "causal", variant == "partner")
    before = flash_attention.launches
    got = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert_close(got, flash_attention_plain(*args))


def float32_kernel_case(cuda, case: str, heads: int) -> None:
    """One float32 kernel case of FLOAT32_WIDTH_CASES at ``heads`` heads of
    D: a counted launch within TOL and REL_TOL of the plain version."""
    w, x, mask, scale, shift = _inputs(cuda)
    F = torch.nn.functional
    q, k, v = F.linear(x, torch.cat([w.wq, w.wk, w.wv]),
                       torch.cat([w.bq, w.bk, w.bv])).chunk(3, dim=-1)
    if case.startswith("b1"):
        kernel, plain = fused_attention_block, fused_attention_block_plain
        args = (x, mask, scale, shift, w, heads, case == "b1_interaction")
    elif case.startswith("b2"):
        kernel, plain = fused_projected_attention, fused_projected_attention_plain
        xn = F.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
        kv, kmask = (xn, mask) if case == "b2_self" else (xn.flip(1).contiguous(),
                                                         mask.flip(1).contiguous())
        args = (xn, kv, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, heads, kmask)
    elif case.startswith("b3"):
        kernel, plain = fused_efficient_attention, efficient_attention
        tk = 77 if case == "b3_tk77" else T
        args = (q.contiguous(), k[..., :tk, :].contiguous(), v[..., :tk, :].contiguous(), heads,
                mask[..., :tk].contiguous())
    else:
        kernel, plain = flash_attention, flash_attention_plain
        if case == "b4_tk300":
            gen = torch.Generator().manual_seed(2)
            k, v = (torch.randn((N_PAIRS, 2, 300, D), generator=gen).to(cuda) for _ in "kv")
            mask = (torch.arange(300, device=cuda) < 250).float().expand(N_PAIRS, 2, 300)
        elif case == "b4_tq_ne_tk":
            k, v, mask = k[..., :77, :].contiguous(), v[..., :77, :].contiguous(), mask[..., :77]
        args = (q, k, v, heads, mask, case == "b4_causal", case == "b4_partner")
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert_close(got, plain(*args))


# (form, head width, T): the whole form's rows at the serving and evaluation
# lengths and at each width's cap, one tile short of it, and T = 1
STREAM_EQUAL_CASES = [(f, hd, t) for f in ("b1_self", "b1_interaction", "b2a", "b3")
                      for hd, t in ((64, 1), (64, T), (64, 196), (64, 320), (128, 1),
                                    (128, 65), (128, 128), (16, 1), (16, T), (16, 320),
                                    (32, 1), (32, T), (32, 320))]


@pytest.mark.parametrize("form,hd,t", STREAM_EQUAL_CASES,
                         ids=[f"{f}_hd{hd}_t{t}" for f, hd, t in STREAM_EQUAL_CASES])
def test_streaming_forms_are_the_whole_forms(cuda_bf16, form, hd, t):
    """B1-bf16's, B2-bf16a's and B3-bf16's streaming forms take the whole
    forms' rounding points in their order, so where both run (up to
    ``whole_max_t`` rows: 320 at width 64, 128 at 128) they agree bit for
    bit, each counted in its own way."""
    heads = D // hd
    w, x, mask, scale, shift = _inputs(cuda_bf16, t)
    wb = BlockWeights(*[_bf16(a) for a in w])
    xb = _bf16(x)
    with torch.no_grad():
        if form.startswith("b1"):
            def run(f):
                return fused_attention_block(xb, mask, _bf16(scale), _bf16(shift), wb, heads,
                                             form == "b1_interaction", form=f)
        elif form == "b2a":
            xn = _bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))

            def run(f):
                return fused_projected_attention(xn, xn, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv,
                                                 heads, mask, form=f)
        else:
            q, k, v = (torch.nn.functional.linear(xb, torch.cat([wb.wq, wb.wk, wb.wv]))
                       + torch.cat([wb.bq, wb.bk, wb.bv])).chunk(3, dim=-1)

            def run(f):
                return efficient_attention_bf16_form(q.contiguous(), k.contiguous(),
                                                     v.contiguous(), heads, mask, f)
        whole, stream = run("whole"), run("stream")
        torch.cuda.synchronize()
    assert torch.equal(whole, stream)


@pytest.mark.parametrize("hd", [64, 128, 16, 32])
def test_whole_form_rows_are_the_kernels(cuda, hd):
    """``whole_max_t`` (the routers' table, WHOLE_MAX_T) is each kernel's
    own (``hig_*_max_t`` of the width's library, from its layout)."""
    import ctypes

    for lib, entry in (("fused_block", "fused_block_bf16_max_t"),
                       ("projected_attention", "projected_attention_bf16a_max_t"),
                       ("efficient_attention", "efficient_attention_bf16_max_t")):
        fn = getattr(_build.load(_build.library_name(lib, hd)), f"hig_{entry}")
        fn.restype, fn.argtypes = ctypes.c_int, []
        assert fn() == whole_max_t(hd), (lib, hd)


def test_mixed_projected_attention_refuses_grad(cuda_bf16):
    """JAX's VJP of the mixed form fails: the port's raises under grad."""
    w, x, mask, _, _ = _inputs(cuda_bf16)
    xb = _bf16(x).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_projected_attention(xb, xb, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, mask)


@pytest.mark.parametrize("case", ["self", "partner", "causal"])
def test_flash_attention_gradients(cuda, case):
    """B4 under autograd as the quadratic blocks call it: q, k and v are
    views of one merged projection, read in place, and their gradients reach
    the projection's weight and bias and x."""
    w, x, mask, _, _ = _inputs(cuda)
    weight = torch.cat([w.wq, w.wk, w.wv]).requires_grad_()
    bias = torch.cat([w.bq, w.bk, w.bv]).requires_grad_()
    leaves = (x.requires_grad_(), weight, bias)

    def run(fn):
        q, k, v = torch.nn.functional.linear(x, weight, bias).chunk(3, dim=-1)
        return fn(q, k, v, H, mask, case == "causal", case == "partner")

    before = flash_attention.launches
    out, got = _grads(lambda: run(flash_attention), leaves)
    assert out.grad_fn is not None
    assert flash_attention.launches == before + 1
    _, want = _grads(lambda: run(flash_attention_plain), leaves)
    _assert_grads_close(got, want)


def test_fused_block_refuses_grad(cuda):
    w, x, mask, scale, shift = _inputs(cuda)
    w = BlockWeights(*(t.requires_grad_() for t in w))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_attention_block(x, mask, scale, shift, w, H)
    with torch.no_grad():
        assert fused_attention_block(x, mask, scale, shift, w, H).shape == x.shape


# --- whole training steps ------------------------------------------------------------


@pytest.fixture
def plain_route(monkeypatch):
    """Routes the model's attention blocks through the plain versions."""
    from hig_tpu_torch.models import attention
    from hig_tpu_torch.ops import pallas_attention

    def use_plain():
        monkeypatch.setattr(attention, "fused_projected_attention",
                            pallas_attention.fused_projected_attention_plain)
        monkeypatch.setattr(attention, "flash_attention", flash_attention_plain)
        monkeypatch.setattr(attention, "fused_attention_block", fused_attention_block_plain)

    return use_plain


def _step_grads(model, pit, batch, t, noise):
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train import trainer

    loss_fn = trainer.make_loss_fn(model, g.make_schedule(g.linear_betas(1000)), pit)
    loss, _ = trainer.compute_grads(model, loss_fn, batch, t=t, noise=noise)
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def _train_case(device, cfg, pairs, seed=0):
    """The model of ``cfg`` in train mode (CLIP frozen) and a batch with
    explicit t and noise."""
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

    model = InteractionModel(cfg)
    load_flax_tree(model, random_flax_tree(cfg, seed)["params"])
    model.to(device).train().freeze_clip()
    gen = torch.Generator().manual_seed(seed)
    cap_ids = torch.randint(0, len(CAPS), (pairs, 2), generator=gen)
    tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64))[cap_ids].to(device)
    with torch.no_grad():
        feats = model.clip_tower(tokens.reshape(-1, 77)).reshape(pairs, 2, 77, -1)
    lengths = torch.tensor([max(2, L * T // 91) for L in LENGTHS] * (pairs // 8 + 1))[:pairs]
    batch = {"motion": torch.randn((pairs, 2, T, cfg.input_feats), generator=gen).to(device),
             "lengths": lengths.to(device), "tokens": tokens, "tower_feats": feats}
    t = torch.randint(0, 1000, (pairs,), generator=gen).to(device)
    noise = torch.randn((pairs, 2, T, cfg.input_feats), generator=gen).to(device)
    return model, batch, t, noise


def _assert_step_grads_close(got, want):
    scale = max(float(v.abs().max()) for v in want.values())
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        if name.endswith("_block.key.bias"):  # exact gradient 0
            assert float(got[name].abs().max()) <= 1e-6 * scale, name
            continue
        assert err <= 1e-3 * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("efficient", [True, False], ids=["efficient_b2", "no_eff_b4"])
@pytest.mark.parametrize("pit", [True, False], ids=["pit", "supervised"])
def test_full_width_train_step_grads_match_plain_route(cuda, plain_route, efficient, pit):
    """The flagship model (latent 512, 8 layers, 12-layer CLIP frozen), 8
    caption pairs: loss and every gradient through the kernels (16 launches
    of B2 or B4 per step, none of B1) against the plain route."""
    from hig_tpu_torch.models.interaction_model import ModelConfig

    model, batch, t, noise = _train_case(cuda, ModelConfig(efficient=efficient), 8)
    kernel = fused_projected_attention if efficient else flash_attention
    counts = (kernel.launches, fused_attention_block.launches)
    loss, got = _step_grads(model, pit, batch, t, noise)
    assert (kernel.launches - counts[0], fused_attention_block.launches - counts[1]) == (16, 0)
    plain_route()
    want_loss, want = _step_grads(model, pit, batch, t, noise)
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    _assert_step_grads_close(got, want)


def test_every_attention_block_gets_qkv_gradients(cuda, plain_route):
    """One denoiser step through B2 (efficient model, train mode) and one
    through B4 (no_eff): every self-attention and interaction block's q/k/v
    weights get a nonzero gradient, equal to the plain route's. A kernel
    wrapper whose output is cut off from autograd leaves them without one.
    Only the model's forward is used, so the test runs on any tree."""
    from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
    from hig_tpu_torch.models.text_encoder import ClipTextConfig
    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

    cfg = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=2, text_latent_dim=64,
               text_ff_size=128, num_text_layers=1, clip=ClipTextConfig(width=64, layers=1))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 2, T, 263), generator=gen).to(cuda)
    target = torch.randn((4, 2, T, 263), generator=gen).to(cuda)
    t = torch.tensor([3, 250, 500, 999], device=cuda)
    lengths = torch.tensor([91, 60, 33, 80], device=cuda)
    xf_proj = torch.randn((4, 2, 512), generator=gen).to(cuda)
    xf_out = torch.randn((4, 2, 77, 64), generator=gen).to(cuda)

    def step_grads(model):
        model.zero_grad(set_to_none=True)
        pred = model.denoise(x, t, lengths, xf_proj, xf_out)
        ((pred - target) ** 2).mean().backward()
        return {n: p.grad for n, p in model.named_parameters()}

    models, got = {}, {}
    for efficient in (True, False):
        mcfg = ModelConfig(**cfg, efficient=efficient)
        models[efficient] = load_flax_tree(InteractionModel(mcfg),
                                           random_flax_tree(mcfg, 0)["params"]).to(cuda).train()
        got[efficient] = step_grads(models[efficient])
    plain_route()
    for efficient, model in models.items():
        want = step_grads(model)
        for i in range(2):
            for block in ("sa_block", "int_ca_block"):
                for proj in ("query", "key", "value"):
                    name = f"denoiser.layers.{i}.{block}.{proj}.weight"
                    assert got[efficient][name] is not None, f"no gradient for {name}"
                    assert float(got[efficient][name].abs().max()) > 0, name
                    err = float((got[efficient][name] - want[name]).abs().max())
                    assert err <= 1e-3 * float(want[name].abs().max()), (name, err)


# --- the pipeline's paths: labeling, guided sampling, caption-id training ------------


def _seeded_model(device, **fields):
    from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

    cfg = ModelConfig(**fields)
    return load_flax_tree(InteractionModel(cfg), random_flax_tree(cfg, 0)["params"]).to(device)


def test_labeling_scorer_through_b1_matches_plain_route(cuda, plain_route):
    """The flagship caption-id model scoring 8 pairs under both caption
    assignments (one denoiser forward: 16 B1 launches, none of B2-B4): the
    (B, 2) summed losses within 1e-4 of their largest magnitude."""
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train import labeling

    model = _seeded_model(cuda, cap_id=True, fused_blocks=True)
    encode, score = labeling.make_assignment_scorer(model, g.make_schedule(g.linear_betas(1000)))
    gen = torch.Generator().manual_seed(0)
    cap_ids = torch.randint(0, 43, (N_PAIRS, 2), generator=gen).to(cuda)
    motion = torch.randn((N_PAIRS, 2, T, 263), generator=gen).to(cuda)
    noise = torch.randn((N_PAIRS, 2, T, 263), generator=gen).to(cuda)
    lengths = torch.tensor(LENGTHS, device=cuda)
    xf_proj, xf_out = encode(cap_ids, cap_ids.flip(1))
    counts = (fused_attention_block.launches, fused_projected_attention.launches,
              flash_attention.launches)
    got = score(motion, lengths, xf_proj, xf_out, 860, noise=noise)
    assert (fused_attention_block.launches - counts[0], fused_projected_attention.launches
            - counts[1], flash_attention.launches - counts[2]) == (16, 0, 0)
    plain_route()
    want = score(motion, lengths, xf_proj, xf_out, 860, noise=noise)
    assert got.shape == (N_PAIRS, 2)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_guided_ddim_step_through_b1_matches_plain_route(cuda, plain_route):
    """One guided DDIM step (w = 2.5) of the flagship model with null
    conditioning: one denoiser call over the 8 conditional and 8 null pairs
    (16 B1 launches), within 1e-3 of the output's largest magnitude; the
    guided step scales the denoiser's rounding by up to |1 − w| + w = 4."""
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.train.trainer import make_sampler

    model = _seeded_model(cuda, fused_blocks=True, cond_drop_prob=0.1).eval()
    gen = torch.Generator().manual_seed(1)
    cap_ids = torch.randint(0, len(CAPS), (N_PAIRS, 2), generator=gen)
    tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64))[cap_ids].to(cuda)
    noise = torch.randn((N_PAIRS, 2, T, 263), generator=gen).to(cuda)
    # the eager loop: a graph would replay the kernels on the plain route too
    sample = make_sampler(model, g.make_schedule(g.linear_betas(1000)), T=T, dim_pose=263,
                          ddim_steps=1, guidance_scale=2.5, graph=False)
    lengths = torch.tensor(LENGTHS, device=cuda)
    before = fused_attention_block.launches
    got = sample(tokens, lengths, noise=noise)
    assert fused_attention_block.launches - before == 16
    plain_route()
    want = sample(tokens, lengths, noise=noise)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


def test_cap_id_pit_step_grads_match_plain_route(cuda, plain_route):
    """A PIT step of the flagship caption-id model on 8 pairs (16 B2
    launches, none of B1): loss within 1e-4 relative, every gradient within
    1e-3 of its leaf's largest magnitude. Over the single caption token the
    text cross-attention's query, key and norm get an exact gradient of 0,
    like the key biases: within 1e-6 of the largest gradient."""
    model = _seeded_model(cuda, cap_id=True).train()
    gen = torch.Generator().manual_seed(2)
    batch = {"motion": torch.randn((N_PAIRS, 2, T, 263), generator=gen).to(cuda),
             "lengths": torch.tensor(LENGTHS, device=cuda),
             "cap_ids": torch.randint(0, 43, (N_PAIRS, 2), generator=gen).to(cuda)}
    t = torch.randint(0, 1000, (N_PAIRS,), generator=gen).to(cuda)
    noise = torch.randn((N_PAIRS, 2, T, 263), generator=gen).to(cuda)
    counts = (fused_projected_attention.launches, fused_attention_block.launches)
    loss, got = _step_grads(model, True, batch, t, noise)
    assert (fused_projected_attention.launches - counts[0],
            fused_attention_block.launches - counts[1]) == (16, 0)
    plain_route()
    want_loss, want = _step_grads(model, True, batch, t, noise)
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    scale = max(float(v.abs().max()) for v in want.values())
    zero = ("_block.key.bias", ".ca_block.key.weight", ".ca_block.query.weight",
            ".ca_block.query.bias", ".ca_block.norm.weight", ".ca_block.norm.bias")
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name.endswith(zero):
            assert float(got[name].abs().max()) <= 1e-6 * scale, name
            continue
        assert float((got[name] - w).abs().max()) <= 1e-3 * float(w.abs().max()), name


# --- the sampler as one CUDA graph per shape ------------------------------------------

GRAPH_MODEL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=2, text_latent_dim=64,
                   text_ff_size=128, num_text_layers=1, text_num_heads=2,
                   clip={"width": 64, "heads": 2, "layers": 1})
GRAPH_PAIRS, GRAPH_T = 4, 40
# case → (model fields, sampler, grid steps, guidance weight); a 100-step schedule
GRAPH_CASES = {
    "ddim_fused": (dict(fused_blocks=True), "ddim", 10, 1.0),
    "ddim_fused_bf16": (dict(fused_blocks=True, compute_dtype="bfloat16"), "ddim", 10, 1.0),
    "ddim_guided": (dict(fused_blocks=True, cond_drop_prob=0.1), "ddim", 10, 2.5),
    "dpm_projected": (dict(), "dpm", 10, 1.0),
    "ddim_no_eff": (dict(efficient=False), "ddim", 10, 1.0),
    "ddpm_fused": (dict(fused_blocks=True), "ddpm", 0, 1.0),
    "ddim_no_cross_attn_fused": (dict(fused_blocks=True, interaction=False), "ddim", 10, 1.0),
    "ddim_single_transformer": (dict(single_transformer=True), "ddim", 10, 1.0),
    "ddim_single_transformer_bf16": (dict(single_transformer=True, compute_dtype="bfloat16"),
                                     "ddim", 10, 1.0),
    "ddpm_single_transformer_guided": (dict(single_transformer=True, cond_drop_prob=0.1),
                                       "ddpm", 0, 2.5),
}


def _graph_case(device, case, graph=True):
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train.trainer import make_sampler

    fields, sampler, steps, w = GRAPH_CASES[case]
    model = _seeded_model(device, **GRAPH_MODEL, **fields).eval()
    sched = g.make_schedule(g.linear_betas(100))
    return [make_sampler(model, sched, T=GRAPH_T, dim_pose=263, sampler=sampler,
                         ddim_steps=steps or 50, guidance_scale=w, graph=graph)
            for graph in ((True, False) if graph else (False,))]


def _graph_inputs(device, pairs=GRAPH_PAIRS):
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.models.tokenizer import tokenize

    tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64)[np.arange(2 * pairs) % 43])
    lengths = torch.tensor([GRAPH_T, 31, 17, 26, 9, 40][:pairs])
    return tokens.reshape(pairs, 2, -1).to(device), lengths.to(device)


def _launches(fn):
    from hig_tpu_torch.utils.graphs import launch_counts

    before = launch_counts()
    out = fn()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graphed_sampler_equals_the_eager_loop(cuda, case):
    """Two calls of the graphed sampler (the capture, then a replay) and of
    the eager loop (``graph=False``) from one generator seed each: equal
    outputs bit for bit and equal generator states after each call (DDPM
    draws its step noise in the graph), one graph, and a replay credits
    the eager call's launch counts."""
    graphed, eager = _graph_case(cuda, case)
    tokens, lengths = _graph_inputs(cuda)
    gens = [torch.Generator(device=cuda).manual_seed(5) for _ in range(2)]
    for _ in range(2):
        got, got_counts = _launches(lambda: graphed(tokens, lengths, generator=gens[0]))
        want, want_counts = _launches(lambda: eager(tokens, lengths, generator=gens[1]))
        assert torch.equal(got, want)
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert got_counts == want_counts and sum(want_counts.values()) > 0
    assert len(graphed.graphs) == 1


def test_a_second_shape_captures_a_second_graph(cuda):
    graphed, eager = _graph_case(cuda, "ddim_fused")
    tokens, lengths = _graph_inputs(cuda)
    for pairs in (GRAPH_PAIRS, 3, GRAPH_PAIRS):
        noise = torch.randn((pairs, 2, GRAPH_T, 263), device=cuda)
        got = graphed(tokens[:pairs], lengths[:pairs], noise=noise)
        assert torch.equal(got, eager(tokens[:pairs], lengths[:pairs], noise=noise))
    assert sorted(key[0][0] for key in graphed.graphs) == [3, GRAPH_PAIRS]


def test_graphed_ddpm_refuses_what_it_cannot_replay(cuda):
    graphed, = _graph_case(cuda, "ddpm_fused")[:1]
    tokens, lengths = _graph_inputs(cuda)
    noise = torch.randn((GRAPH_PAIRS, 2, GRAPH_T, 263), device=cuda)
    with pytest.raises(ValueError, match="graph=False"):
        graphed(tokens, lengths, noise=noise, step_noise=lambda i: torch.zeros_like(noise))
    with pytest.raises(ValueError, match="generator"):
        graphed(tokens, lengths, noise=noise)
    assert graphed.graphs == {}


@pytest.mark.parametrize("case", ["ddim_fused", "dpm_projected", "ddim_no_eff"])
def test_eager_sampler_on_the_plain_route_launches_no_kernel(cuda, plain_route, case):
    plain_route()
    eager, = _graph_case(cuda, case, graph=False)
    tokens, lengths = _graph_inputs(cuda)
    out, counts = _launches(lambda: eager(tokens, lengths,
                                          generator=torch.Generator(device=cuda).manual_seed(0)))
    assert counts == {} and torch.isfinite(out).all()


# --- the train step as one CUDA graph per batch shape ---------------------------------

TRAIN_GRAPH_MODEL = dict(latent_dim=128, ff_size=256, num_layers=2, num_heads=2,
                         text_latent_dim=64, text_ff_size=128, num_text_layers=1,
                         text_num_heads=2, lr=1e-3)
TRAIN_GRAPH_PAIRS, TRAIN_GRAPH_STEPS = 4, 3
# case → (ExperimentConfig fields, PIT): every route a train step takes
TRAIN_GRAPH_CASES = {
    "pit_b2": (dict(), True),
    "pit_no_eff_b4": (dict(no_eff=True), True),
    "pit_cap_id_b2": (dict(cap_id=True), True),
    "cfg_loss_aware_supervised_b2": (dict(label_path="labels.json", cond_drop_prob=0.5,
                                          loss_aware_sampler=True), False),
    "pit_bf16_b3": (dict(compute_dtype="bfloat16"), True),
    "pit_bf16_no_eff_b4": (dict(compute_dtype="bfloat16", no_eff=True), True),
    "pit_grad_accum_2_ema_b2": (dict(grad_accum=2, ema_decay=0.9), True),
    "pit_no_cross_attn_b2": (dict(no_cross_attn=True), True),
    "supervised_single_transformer_b2": (dict(single_transformer=True,
                                              label_path="labels.json"), False),
    "pit_single_transformer_bf16_b3": (dict(single_transformer=True,
                                            compute_dtype="bfloat16"), True),
}


def _train_graph_setup(device, case):
    """(config, make_state(), a step maker, a history maker, batch(pairs))
    of ``case`` at TRAIN_GRAPH_MODEL's widths."""
    from hig_tpu_torch.config import ExperimentConfig, model_config
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.diffusion import timestep_samplers as tss
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.models.text_encoder import ClipTextConfig
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.train import trainer as tt
    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree, reduce_bf16_in_float32

    fields, pit = TRAIN_GRAPH_CASES[case]
    cfg = ExperimentConfig(**TRAIN_GRAPH_MODEL, **fields)
    mcfg = model_config(cfg, ClipTextConfig(width=64, heads=2, layers=1))
    if mcfg.dtype != torch.float32:
        reduce_bf16_in_float32()
    sched = g.make_schedule(g.linear_betas(1000))

    def make_state():
        model = InteractionModel(mcfg)
        load_flax_tree(model, random_flax_tree(mcfg, 0)["params"])
        model.to(device).train()
        ema = None
        if cfg.ema_decay > 0:
            ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return tt.TrainState(model=model, optimizer=tt.make_optimizer(cfg, model), ema=ema)

    def make_step(graph):
        return tt.make_train_step(sched, pit, cfg.grad_accum, cfg.ema_decay,
                                  cfg.loss_aware_sampler, graph=graph)

    def history():
        return tss.LossSecondMomentState.create(1000, device=device) \
            if cfg.loss_aware_sampler else None

    def batch(model, pairs=TRAIN_GRAPH_PAIRS, seed=0):
        gen = torch.Generator().manual_seed(seed)
        cap_ids = torch.randint(0, len(CAPS), (pairs, 2), generator=gen)
        out = {"motion": torch.randn((pairs, 2, GRAPH_T, 263), generator=gen).to(device),
               "lengths": torch.tensor([GRAPH_T, 31, 17, 26, 9, 40][:pairs], device=device)}
        if cfg.cap_id:
            out["cap_ids"] = cap_ids.to(device)
            return out
        out["tokens"] = torch.from_numpy(tokenize(CAPS).astype(np.int64))[cap_ids].to(device)
        with torch.no_grad():
            feats = model.clip_tower(out["tokens"].reshape(-1, 77))
        out["tower_feats"] = feats.reshape(pairs, 2, 77, -1)
        return out

    return cfg, make_state, make_step, history, batch


def _train_state_tensors(state, history):
    opt = state.optimizer
    out = {f"param.{n}": p for n, p in state.model.named_parameters()}
    out.update({f"exp_avg.{i}": m for i, m in enumerate(opt.exp_avg)})
    out.update({f"exp_avg_sq.{i}": v for i, v in enumerate(opt.exp_avg_sq)})
    out.update({f"ema.{n}": e for n, e in (state.ema or {}).items()})
    if history is not None:
        out.update(history_losses=history.losses, history_counts=history.counts)
    return out


def _train_run(step, state, batches, history, seed=10):
    """One step per batch, each from a fresh CUDA generator seeded seed + i
    (the trainer's per-step generator): the metrics, the launch counts and
    the generator's state after each step."""
    from hig_tpu_torch.train.trainer import TRAIN_METRICS

    rows = []
    for i, batch in enumerate(batches):
        gen = torch.Generator(device=batch["motion"].device).manual_seed(seed + i)
        if history is None:
            metrics, counts = _launches(lambda: step(state, batch, gen))
        else:
            (metrics, history), counts = _launches(lambda: step(state, batch, gen,
                                                                ts_state=history))
        rows.append((torch.stack([metrics[k] for k in TRAIN_METRICS]), counts, gen.get_state()))
    return rows, history


def _assert_runs_equal(got, want):
    (rows_g, tensors_g), (rows_w, tensors_w) = got, want
    for (m_g, c_g, s_g), (m_w, c_w, s_w) in zip(rows_g, rows_w, strict=True):
        assert torch.equal(m_g, m_w), (m_g, m_w)
        assert c_g == c_w and sum(c_w.values()) > 0, (c_g, c_w)
        assert torch.equal(s_g, s_w)
    assert tensors_g.keys() == tensors_w.keys()
    differ = [n for n in tensors_w if not torch.equal(tensors_g[n], tensors_w[n])]
    assert not differ, differ


@pytest.mark.parametrize("case", list(TRAIN_GRAPH_CASES))
def test_graphed_train_step_equals_the_eager_step(cuda, case):
    """TRAIN_GRAPH_STEPS steps from one seeded state and per-step generator
    seeds, graphed (the first step eager on the capture stream, then the
    capture; replays after) and eager (``graph=False``), twice eager to
    show the eager step repeats itself: metrics, generator states,
    parameters, Adam's moments, EMA and history bit for bit, and each
    replay credits the eager step's launch counts."""
    _, make_state, make_step, history, batch = _train_graph_setup(cuda, case)
    runs = []
    for graph in (False, False, True):
        state, step = make_state(), make_step(graph)
        batches = [batch(state.model)] * TRAIN_GRAPH_STEPS
        rows, hist = _train_run(step, state, batches, history())
        runs.append((rows, {n: t.clone() for n, t in _train_state_tensors(state, hist).items()}))
        assert len(step.graphs) == (1 if graph else 0)
    _assert_runs_equal(runs[1], runs[0])
    _assert_runs_equal(runs[2], runs[0])


def test_a_second_batch_shape_captures_a_second_train_graph(cuda):
    _, make_state, make_step, history, batch = _train_graph_setup(cuda, "pit_b2")
    runs = []
    for graph in (True, False):
        state, step = make_state(), make_step(graph)
        batches = [batch(state.model, pairs) for pairs in (4, 3, 4, 3)]
        rows, hist = _train_run(step, state, batches, history())
        runs.append((rows, {n: t.clone() for n, t in _train_state_tensors(state, hist).items()}))
        if graph:
            # a key: (the inputs' (name, shape, dtype), last "tower_feats"; LAZY_KNORM)
            assert sorted(key[0][-1][1][0] for key in step.graphs) == [3, 4]
    _assert_runs_equal(*runs)


def test_graphed_train_step_rolls_back_in_place(cuda, tmp_path):
    """Two steps, a checkpoint, two steps, ``restore_state`` into the same
    state, two more steps: the graphed run equals the eager run bit for bit,
    keeps its one graph, and every tensor it replays on keeps its storage."""
    from hig_tpu_torch.train import checkpoint as ckpt

    _, make_state, make_step, history, batch = _train_graph_setup(
        cuda, "pit_grad_accum_2_ema_b2")
    runs = []
    for graph in (True, False):
        state, step = make_state(), make_step(graph)
        b = batch(state.model)
        path = str(tmp_path / f"latest_{graph}.pt")
        rows, _ = _train_run(step, state, [b, b], None)
        ckpt.save_state(path, state, epoch=0, total_it=2)
        more, _ = _train_run(step, state, [b, b], None, seed=20)
        ptrs = {n: t.data_ptr() for n, t in _train_state_tensors(state, None).items()}
        state, _, it = ckpt.restore_state(path, state)
        assert it == 2 == state.step
        assert {n: t.data_ptr() for n, t in _train_state_tensors(state, None).items()} == ptrs
        after, _ = _train_run(step, state, [b, b], None, seed=30)
        runs.append((rows + more + after,
                     {n: t.clone() for n, t in _train_state_tensors(state, None).items()}))
        assert len(step.graphs) == (1 if graph else 0)
    _assert_runs_equal(*runs)


def test_graphed_train_step_refuses_what_it_cannot_replay(cuda):
    _, make_state, make_step, history, batch = _train_graph_setup(cuda, "pit_b2")
    state, step = make_state(), make_step(True)
    b = batch(state.model)
    with pytest.raises(ValueError, match="generator"):
        step(state, b)
    step(state, b, torch.Generator(device=cuda).manual_seed(0))
    with pytest.raises(ValueError, match="TrainState it captured"):
        step(make_state(), b, torch.Generator(device=cuda).manual_seed(0))


def test_train_cli_profile_traces_the_replayed_steps(cuda, tmp_path):
    """``python -m hig_tpu_torch.train --profile`` on the card (caption ids,
    small widths, 8 steps): the trace of steps [5, 8) holds the port's B2
    kernels (replays of the step's graph), ``step_times.jsonl`` counts
    every step, and the step was captured once."""
    import json
    import os

    import chip_smoke
    from hig_tpu_torch.train.__main__ import main

    data = str(tmp_path / "data")
    chip_smoke.write_train_data(data)
    argv = ["--data_root", data, "--checkpoints_dir", str(tmp_path / "runs"), "--name", "prof",
            "--cap_id", "--batch_size", "4", "--limit_data_num", "8", "--num_epochs", "4",
            "--log_every", "1", "--profile"]
    for k, v in TRAIN_GRAPH_MODEL.items():
        if k != "lr":
            argv += [f"--{k}", str(v)]
    trainer, state = main(argv)
    root = trainer.cfg.save_root
    assert state.step == 8 and len(trainer.graphs) == 1
    with open(os.path.join(root, "profile", "trace.json")) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    assert sum("hig::linear_attention_core" in k for k in kernels) == 3 * 2 * 2  # steps × layers × blocks
    with open(os.path.join(root, "step_times.jsonl")) as f:
        assert json.loads(f.readline())["steps"] == 8


def test_graphed_single_person_step_and_sampler_equal_eager(cuda):
    """The single-person model: TRAIN_GRAPH_STEPS steps of
    make_single_train_step graphed against eager (and eager against eager),
    bit for bit as above, then make_single_sampler's DDIM call graphed (the
    capture and a replay) against its eager loop."""
    from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths, single_model_config
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import SingleMotionModel
    from hig_tpu_torch.models.text_encoder import ClipTextConfig
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.train import trainer as tt
    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

    cfg = add_dataset_paths(ExperimentConfig(**TRAIN_GRAPH_MODEL, dataset_name="t2m"))
    mcfg = single_model_config(cfg, ClipTextConfig(width=64, heads=2, layers=1))
    sched = g.make_schedule(g.linear_betas(1000))
    gen = torch.Generator().manual_seed(0)
    pairs = 2 * TRAIN_GRAPH_PAIRS
    tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64)[np.arange(pairs) * 5 % 43])
    batch = {"motion": torch.randn((pairs, 61, 263), generator=gen).to(cuda),
             "lengths": torch.tensor([61, 40, 25, 61, 12, 33, 50, 61], device=cuda),
             "tokens": tokens.to(cuda)}

    def make_state():
        model = SingleMotionModel(mcfg)
        load_flax_tree(model, random_flax_tree(mcfg, 0)["params"])
        model.to(cuda).train()
        return tt.TrainState(model=model, optimizer=tt.make_optimizer(cfg, model))

    runs = []
    for graph in (False, False, True):
        state, step = make_state(), tt.make_single_train_step(sched, graph=graph)
        rows, _ = _train_run(step, state, [batch] * TRAIN_GRAPH_STEPS, None)
        runs.append((rows, {n: t.clone() for n, t in _train_state_tensors(state, None).items()}))
        assert len(step.graphs) == (1 if graph else 0)
    _assert_runs_equal(runs[1], runs[0])
    _assert_runs_equal(runs[2], runs[0])

    model = state.model.eval()
    graphed, eager = (tt.make_single_sampler(model, sched, T=61, dim_pose=263, sampler="ddim",
                                             ddim_steps=10, graph=graph)
                      for graph in (True, False))
    noise = torch.randn((pairs, 61, 263), device=cuda)
    for _ in range(2):
        got, got_counts = _launches(lambda: graphed(batch["tokens"], batch["lengths"],
                                                    noise=noise))
        want, want_counts = _launches(lambda: eager(batch["tokens"], batch["lengths"],
                                                    noise=noise))
        assert torch.equal(got, want) and torch.isfinite(got).all()
    assert got_counts == want_counts and sum(want_counts.values()) > 0
    assert len(graphed.graphs) == 1


# --- causal efficient attention and the native loader ----------------------------------


def _causal_block(interaction: bool):
    """A causal efficient block at full width (fused, which a causal block
    ignores) with torch's seeded default init, and its serving inputs."""
    from hig_tpu_torch.models.attention import (
        EfficientInteractionAttention,
        EfficientSelfAttention,
    )

    torch.manual_seed(0)
    cls = EfficientInteractionAttention if interaction else EfficientSelfAttention
    block = cls(D, H, 4 * D, fused=True, causal=True)
    w, x, mask, _, _ = _inputs("cpu")
    emb = torch.randn((N_PAIRS, 2, 4 * D), generator=torch.Generator().manual_seed(1))
    return block, x, emb, mask


@pytest.mark.parametrize("interaction", [False, True], ids=["self", "interaction"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_block_matches_its_cpu_twin(cuda_bf16, dtype, interaction):
    """A causal efficient block at the serving shape on the card against the
    same block on the CPU, launching no kernel. float32 within TOL and
    REL_TOL, with the gradients of a train-mode call within 1e-3 of each
    leaf's largest magnitude (the key bias, whose exact gradient is 0,
    within 1e-6 of the largest gradient); bfloat16 (weights cast) within 2 bfloat16 ulps
    of the largest magnitude and 0.25 of the bfloat16 effect in rms (the
    CPU twin's distance from the float32 block on the same inputs)."""
    import copy

    from hig_tpu_torch.utils.graphs import launch_counts
    from hig_tpu_torch.weights import cast_floating

    block, x, emb, mask = _causal_block(interaction)
    before = launch_counts()
    if dtype == "float32":
        card = copy.deepcopy(block).to(cuda_bf16)
        with torch.no_grad():
            assert_close(card(x.to(cuda_bf16), emb.to(cuda_bf16), mask.to(cuda_bf16)).cpu(),
                         block(x, emb, mask))
        grads = []
        for b, dev in ((card, cuda_bf16), (block, "cpu")):
            b.train()
            leaf = x.to(dev).requires_grad_()
            b(leaf, emb.to(dev), mask.to(dev)).square().mean().backward()
            grads.append({"x": leaf.grad.cpu(),
                          **{n: p.grad.cpu() for n, p in b.named_parameters()}})
        scale = max(g.abs().max().item() for g in grads[1].values())
        for name, want in grads[1].items():
            err = (grads[0][name] - want).abs().max().item()
            if name == "key.bias":  # an exact gradient of 0: rounding noise
                assert err <= 1e-6 * scale, name
                continue
            assert err <= 1e-3 * want.abs().max().item(), name
    else:
        b16 = cast_floating(copy.deepcopy(block), torch.bfloat16).eval()
        args = [t.bfloat16() for t in (x, emb, mask)]
        with torch.no_grad():
            got = b16.to(cuda_bf16)(*(t.to(cuda_bf16) for t in args)).float().cpu()
            twin = cast_floating(copy.deepcopy(block), torch.bfloat16).eval()(*args).float()
            twin32 = block.eval()(*(t.float() for t in args))
        ulp = 2.0 ** -8
        assert (got - twin).abs().max().item() <= 2 * ulp * twin.abs().max().item()
        rms = (got - twin).pow(2).mean().sqrt().item()
        assert rms <= 0.25 * (twin - twin32).pow(2).mean().sqrt().item()
    torch.cuda.synchronize()
    assert launch_counts() == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_causal_sampler_and_step_equal_eager(cuda_bf16, dtype, monkeypatch):
    """The causal efficient model's DDIM sampler and PIT train step, graphed
    against eager bit for bit, launching no attention kernel (a bfloat16
    step only the ordered sum of its softmax backwards): two sampler calls
    each from one generator seed, then TRAIN_GRAPH_STEPS steps from one
    seeded state (metrics, parameters, Adam's moments)."""
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.train.trainer import make_sampler

    model = _seeded_model(cuda_bf16, **GRAPH_MODEL, causal=True, fused_blocks=True,
                          compute_dtype=dtype).eval()
    sched = g.make_schedule(g.linear_betas(100))
    fns = [make_sampler(model, sched, T=GRAPH_T, dim_pose=263, sampler="ddim", ddim_steps=10,
                        graph=graph) for graph in (True, False)]
    tokens, lengths = _graph_inputs(cuda_bf16)
    gens = [torch.Generator(device=cuda_bf16).manual_seed(5) for _ in range(2)]
    for _ in range(2):
        (got, got_counts), (want, want_counts) = (
            _launches(lambda f=f, gen=gen: f(tokens, lengths, generator=gen))
            for f, gen in zip(fns, gens))
        assert torch.equal(got, want) and got_counts == want_counts == {}
    assert len(fns[0].graphs) == 1

    monkeypatch.setitem(TRAIN_GRAPH_CASES, "pit_causal", (dict(causal=True,
                                                                compute_dtype=dtype), True))
    _, make_state, make_step, history, batch = _train_graph_setup(cuda_bf16, "pit_causal")
    runs = []
    for graph in (False, True):
        state, step = make_state(), make_step(graph)
        rows, hist = _train_run(step, state, [batch(state.model)] * TRAIN_GRAPH_STEPS, history())
        # the ordered bfloat16 sum of a bfloat16 step's softmax backwards, nothing else
        assert all(set(counts) == ({"bf16_sum.launches"} if dtype == "bfloat16" else set())
                   for _, counts, _ in rows), rows
        runs.append(([m for m, _, _ in rows], [c for _, c, _ in rows],
                     _train_state_tensors(state, hist)))
    (m_e, c_e, t_e), (m_g, c_g, t_g) = runs
    assert c_e == c_g and all(torch.equal(a, b) for a, b in zip(m_g, m_e, strict=True))
    assert not [n for n in t_e if not torch.equal(t_g[n], t_e[n])]


def test_native_loader_builds_and_loads_from_the_package(cuda):
    """The native batch loader built with g++ from native/loader.cpp into
    hig_tpu_torch/_build/ and loaded from there (never the tracked
    native/libhig_loader.so): a batch of 16 clips at window 60, the same
    from 1 and 8 threads, normalized and role-swapped."""
    import os

    from hig_tpu_torch.data import native_loader as nl
    from hig_tpu_torch.ops._build import BUILD_DIR

    lib = nl.load()
    assert lib._name == nl.library_path() and os.path.dirname(lib._name) == BUILD_DIR
    rng = np.random.default_rng(0)
    mean = rng.standard_normal(263 + 4).astype(np.float32)
    std = (1 + rng.random(263 + 4)).astype(np.float32)
    store = nl.NativeClipStore(mean, std)
    clips = [rng.standard_normal((2, int(n), 263)).astype(np.float32)
             for n in rng.integers(40, 130, 16)]
    for c in clips:
        store.add_clip(c)
    idx, swaps = np.arange(16), (np.arange(16) % 3 == 0).astype(np.uint8)
    one = store.sample_batch(idx, window=60, seed=1, epoch=2, swap_flags=swaps, num_threads=1)
    eight = store.sample_batch(idx, window=60, seed=1, epoch=2, swap_flags=swaps,
                               num_threads=8)
    for a, b in zip(one, eight):
        np.testing.assert_array_equal(a, b)
    motion, lengths = one
    assert motion.shape == (16, 2, 61, 263)
    np.testing.assert_array_equal(lengths, np.minimum([c.shape[1] for c in clips], 61))
    c = clips[0]  # swapped: actor 1 first; its init row normalized by the init stats
    np.testing.assert_allclose(motion[0, 0, 0, :4], (c[1, -1, :4] - mean[-4:]) / std[-4:],
                               rtol=1e-6)


# --- the motion geometry, the data tools and visualization --------------------------------


def test_single_transformer_bf16_step_at_window_196_matches_its_cpu_twin(cuda_bf16):
    """One bfloat16 --single_transformer PIT step at a native window of 196
    (394 merged rows: B3-bf16's streaming form), full width cut to its first
    layer: chip_smoke's gates (loss and gradients within 0.2 of the bfloat16
    effect from the plain route on the card, the control route above it;
    within 0.7 from the same step on the CPU)."""
    import chip_smoke

    failures = []
    row = chip_smoke.single_transformer_step_gate(cuda_bf16, failures)
    assert not failures, failures
    assert row["merged_rows"] == 394 and row["b3_bf16_launches"] >= 1


def test_encode_pair_on_the_card_matches_the_cpu(cuda):
    """The generator's FK and a batched encode_pair on the card against the
    same on the CPU: joints within 1e-5, features within 1e-4, the foot
    contacts exactly equal."""
    from hig_tpu_torch.data.synthetic import generate_pair
    from hig_tpu_torch.utils import motion_codec as codec

    pairs = {}
    for device in ("cuda", "cpu"):
        rng = np.random.RandomState(4)
        pairs[device] = [generate_pair(rng, 120, c, device) for c in range(6)]
    for (a1, a2), (b1, b2) in zip(pairs["cuda"], pairs["cpu"]):
        assert (a1.cpu() - b1).abs().max() <= 1e-5 and (a2.cpu() - b2).abs().max() <= 1e-5
    feats = {d: codec.encode_pair(torch.stack([p[0] for p in ps]), torch.stack([p[1] for p in ps]),
                                  0.002, codec.t2m_spec()).cpu()
             for d, ps in pairs.items()}
    assert feats["cuda"].shape == (6, 2, 120, 263)
    assert (feats["cuda"] - feats["cpu"]).abs().max() <= 1e-4
    assert torch.equal(feats["cuda"][..., :-1, -4:], feats["cpu"][..., :-1, -4:])


def test_visualize_launches_b1_for_each_denoiser_block(cuda, tmp_path):
    """python -m hig_tpu_torch.visualize on a caption-id run of 8 layers
    (head width 64, narrow otherwise): its capturing DDIM-50 call launches B1
    16 × 50 = 800 times plus the capture's warm-up's 16, and no other
    kernel; its joints equal serve's decode of a replay on the same seed."""
    from hig_tpu_torch import serve, visualize
    from hig_tpu_torch.data.synthetic import generate_dataset
    from hig_tpu_torch.train.__main__ import main as train_main

    data, runs = str(tmp_path / "data"), str(tmp_path / "runs")
    generate_dataset(data, clips_per_class=1, min_frames=90, max_frames=91)
    widths = dict(num_layers=8, latent_dim=128, ff_size=256, num_heads=2, text_latent_dim=64,
                  text_ff_size=128, text_num_heads=1, num_text_layers=1)
    train_main(["--data_root", data, "--checkpoints_dir", runs, "--name", "vis", "--cap_id",
                "--batch_size", "4", "--num_epochs", "1", "--limit_data_num", "4",
                *[a for k, v in widths.items() for a in (f"--{k}", str(v))]])
    opt = os.path.join(runs, "ntu_mul", "vis", "opt.txt")
    counters = (fused_attention_block, fused_projected_attention, fused_efficient_attention,
                flash_attention)
    for c in counters:
        c.launches = c.launches_bf16 = 0
    made = visualize.main(["--opt_path", opt, "--no-gif", "--motion_length", "90", "--sampler",
                           "ddim", "--ddim_steps", "50", "--class_id", "3", "--result_path",
                           str(tmp_path / "vis")])
    assert fused_attention_block.launches == 800 + 16
    assert all(c.launches == c.launches_bf16 == 0 for c in counters[1:])
    assert fused_attention_block.launches_bf16 == 0
    joints = np.load(made["path"])
    cond = serve.conditioning_for([dict(zip(("caption1", "caption2"), made["captions"]))],
                                  cap_id=True)
    out = made["sample"](torch.from_numpy(cond), torch.tensor([91]),
                         generator=torch.Generator(device="cuda").manual_seed(0))
    mean, std = serve.load_stats(os.path.join(os.path.dirname(opt), "meta"), 263)
    assert np.array_equal(joints, serve.decode(out, mean, std)[1][0].cpu().numpy())


# --- distillation, SMPL, the legacy protocol -------------------------------------------

DISTILL_PAIRS, DISTILL_STEPS = 4, 3


def _distill_setup(device, distill_w):
    from hig_tpu_torch.config import ExperimentConfig, model_config
    from hig_tpu_torch.diffusion import gaussian as g
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.models.text_encoder import ClipTextConfig
    from hig_tpu_torch.train import trainer as tt
    from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

    cfg = ExperimentConfig(**TRAIN_GRAPH_MODEL, cap_id=True, label_path="labels.json",
                           cond_drop_prob=0.5)
    mcfg = model_config(cfg, ClipTextConfig(width=64, heads=2, layers=1))
    sched = g.make_schedule(g.linear_betas(1000))

    def make():
        student = load_flax_tree(InteractionModel(mcfg), random_flax_tree(mcfg, 0)["params"])
        teacher = InteractionModel(dataclasses.replace(mcfg, fused_blocks=True))
        load_flax_tree(teacher, random_flax_tree(mcfg, 1)["params"])
        return student.to(device).train(), teacher.to(device).eval().requires_grad_(False)

    gen = torch.Generator().manual_seed(3)
    batch = {"motion": torch.randn((DISTILL_PAIRS, 2, GRAPH_T, 263), generator=gen).to(device),
             "lengths": torch.tensor([GRAPH_T, 31, 17, 26], device=device),
             "cap_ids": torch.randint(0, 43, (DISTILL_PAIRS, 2), generator=gen).to(device)}
    return cfg, sched, make, batch, tt


@pytest.mark.parametrize("distill_w", [1.0, 2.5], ids=["branchwise", "fixed_w"])
def test_graphed_distill_step_equals_eager_across_a_stage_change(cuda, distill_w):
    """Two stages (DDIM-50 → 25, then 25 → 13 from the student copied into
    the teacher in place), DISTILL_STEPS steps each, graphed and eager:
    metrics, generator states, the student's parameters and Adam moments
    and the teacher's parameters bit for bit; each step launches B1 4 × 2
    times (two teacher calls of 2 layers × 2 blocks) and B2 4 times (the
    student), nothing else."""
    from hig_tpu_torch.diffusion import distill as pd

    cfg, sched, make, batch, tt = _distill_setup(cuda, distill_w)
    runs = []
    for graph in (False, False, True):
        student, teacher = make()
        rows, tensors = [], {}
        for stage, (n, prev) in enumerate(((25, 50), (13, 25))):
            state = tt.TrainState(model=student, optimizer=tt.make_optimizer(cfg, student))
            step = pd.make_distill_step(sched, pd.distill_grids(1000, n, prev), teacher,
                                        distill_w, graph=graph)
            for i in range(DISTILL_STEPS):
                gen = torch.Generator(device=cuda).manual_seed(10 * stage + i)
                metrics, counts = _launches(lambda: step(state, batch, gen))
                rows.append((torch.stack([metrics[k] for k in pd.DISTILL_METRICS]), counts,
                             gen.get_state()))
                assert counts == {"fused_attention_block.launches": 8,
                                  "fused_projected_attention.launches": 4}, counts
            assert len(step.graphs) == (1 if graph else 0)
            tensors.update({f"{stage}.exp_avg.{k}": m.clone()
                            for k, m in enumerate(state.optimizer.exp_avg)})
            teacher.load_state_dict(student.state_dict())
        tensors.update({f"student.{k}": v.clone() for k, v in student.state_dict().items()})
        tensors.update({f"teacher.{k}": v.clone() for k, v in teacher.state_dict().items()})
        runs.append((rows, tensors))
    _assert_runs_equal(runs[1], runs[0])
    _assert_runs_equal(runs[2], runs[0])


def test_smpl_joints_only_lbs_and_lbfgs_on_the_card_match_the_cpu(cuda):
    """The 6890-vertex synthetic model: the joints-only lbs against the full
    lbs on the card (1e-5) and both against the CPU (1e-5); the L-BFGS on
    the card, each evaluation a graph replay, equal to the eager one bit for
    bit and against the CPU, its first 5 iterates within 1e-4 and the same
    line-search steps; SMPLify3D's final objective within 1%."""
    from hig_tpu_torch.smpl import lbs as tl
    from hig_tpu_torch.smpl.lbfgs import lbfgs_run
    from hig_tpu_torch.smpl.prior import synthetic_gmm_prior
    from hig_tpu_torch.smpl.smplify import SMPLify3D

    cpu_model = tl.synthetic_smpl_model(6890)
    model = cpu_model.to(cuda)
    gen = torch.Generator().manual_seed(0)
    betas, pose = 0.5 * torch.randn(12, 10, generator=gen), 0.3 * torch.randn(12, 72, generator=gen)
    v_cpu, j_cpu = tl.lbs(cpu_model, betas, pose)
    v, j = tl.lbs(model, betas.to(cuda), pose.to(cuda))
    j_only = tl.lbs_joints(model, betas.to(cuda), pose.to(cuda))
    for got, want in ((j_only, j), (j.cpu(), j_cpu), (v.cpu(), v_cpu)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()

    def objective(p):
        x = p["x"]
        return (100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum() + (p["s"] ** 2).sum()

    p0 = {"x": 0.5 * torch.randn(6, generator=gen), "s": torch.randn(4, generator=gen)}
    runs = [lbfgs_run(objective, {k: v.to(d) for k, v in p0.items()}, 5, record_iterates=True,
                      graph=graph)[2]
            for d, graph in ((cuda, True), (cuda, False), ("cpu", False))]
    assert runs[0].linesearch_steps == runs[1].linesearch_steps == runs[2].linesearch_steps
    for graphed, eager, want in zip(*(r.iterates for r in runs)):
        for k in want:
            assert torch.equal(graphed[k], eager[k])  # a replay is the eager evaluation
            assert (graphed[k].cpu() - want[k]).abs().max() <= 1e-4 * want[k].abs().max()
    j3d = j_cpu[:, :22] + 0.02 * torch.randn(12, 22, 3, generator=gen)
    conf = torch.ones(22)
    losses = []
    for m, d in ((model, cuda), (cpu_model, "cpu")):
        fit = SMPLify3D(model=m, prior=synthetic_gmm_prior().to(d), num_iters=5, camera_outer=2)
        losses.append(float(fit(torch.zeros(12, 72, device=d), torch.zeros(12, 10, device=d),
                                j3d.to(d), conf.to(d)).final_loss))
    assert abs(losses[0] - losses[1]) <= 0.01 * losses[1], losses


def test_legacy_embeddings_on_the_card_match_the_cpu(cuda):
    """CoEmbeddingEvaluator at the reference's widths (seeded weights) on 8
    clips of 64 frames and their captions: the text and motion embeddings
    on the card within 1e-4 of the CPU's."""
    from hig_tpu_torch.data.word_vectorizer import WordVectorizer
    from hig_tpu_torch.eval.legacy_protocol import CoEmbeddingEvaluator, vectorize_tokens

    wv = WordVectorizer()
    tokens = [["a/DET", "person/NOUN", "walks/VERB", "left/ADV"][: 1 + k % 4] for k in range(8)]
    vecs = [vectorize_tokens(t, 20, wv) for t in tokens]
    gen = torch.Generator().manual_seed(1)
    inputs = (torch.randn(8, 64, 263, generator=gen), torch.tensor([64, 60, 33, 48, 8, 12, 64, 40]),
              np.stack([v[0] for v in vecs]), np.stack([v[1] for v in vecs]),
              np.array([v[2] for v in vecs]))
    out = [CoEmbeddingEvaluator(263, device=d).get_co_embeddings(*inputs) for d in (cuda, "cpu")]
    for got, want in zip(*out):
        assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
