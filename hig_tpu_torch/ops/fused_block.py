"""B1: one whole efficient self-attention or interaction block, forward.

Counterpart of ``hig_tpu/ops/fused_block.py`` (``_block_kernel`` at :48,
``fused_attention_block`` at :99):

    xn = LayerNorm_attn(x)
    q, k, v = xn·Wq+bq, kvn·Wk+bk, kvn·Wv+bv      (kvn = partner or self)
    k += (1-mask)·(-1e6);  v *= mask
    per head: y_h = softmax_feat(q_h) · [softmax_time(k_h)ᵀ v_h]
    out = x + SiLU(LayerNorm_styl(y)·(1+scale) + shift)·Wo + bo

In the interaction variant kv and the key mask are the other actor's
(``flip`` on the actor axis of the (B, 2, T, D) layout).

Kernel note (``csrc/fused_block.cu`` over ``csrc/linear_attention.cuh``).
The TPU kernel ran the whole block per sequence in VMEM. On the H100 a
(91, 512) f32 activation tile is 186 KB and one (512, 512) weight 1 MB
against 227 KB of shared memory, and one block per sequence would fill 16
of 132 SMs. So the block is five launches on the caller's stream: a row
pass writes LayerNorm_attn(x); a GEMM writes the (N·T, 3D) q|k|v product;
the per-(sequence, head, 32 queries) attention core, shared with B2 and
B3, reads the partner's k/v rows (sequence n ^ 1) so no flipped copy is
made; a row pass turns y in place into SiLU(LayerNorm_styl(y)·(1+scale) +
shift); a GEMM adds bo and the residual. Each row is normalized once, so
the GEMMs' main loops only copy (a 3-stage cp.async ring) and multiply.
Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8): each
float32 operand is split into hi = cvt.rna.tf32(x) and lo =
cvt.rna.tf32(x − hi), summed as lo·hi + hi·lo + hi·hi in float32, which
keeps float32-level error. At N = 16, T = 91, D = 512 the block is 3.24
GFLOP against 10 MB, so the card's bound is its 3xTF32 rate (495 / 3
TFLOP/s): 0.020 ms.

bfloat16 form (B1-bf16, ``hig_fused_block_bf16`` in the same library). The
Pallas kernel takes any dtype dt and rounds to it at fixed points: x and
the partner are upcast and LayerNorm_attn runs in float32; q|k|v =
dot(xn.astype(dt), W) with float32 accumulation, plus the bias, stays
float32; the softmaxes are float32, then att = dot(kh.astype(dt),
v.astype(dt)) and y = dot(qh.astype(dt), att.astype(dt)), each with float32
accumulation; the gate is float32; out = dot(z.astype(dt), Wo) + bo, and
(x + out).astype(dt). The bfloat16 form rounds at exactly those points, in
four launches designed for the H100: the row pass writes xn as bfloat16;
one kernel per (sequence, head) projects the partner's (or its own) xn
rows onto the head's columns of Wk | Wv and its own onto Wq on wgmma
(bfloat16 operands from a TMA ring, float32 accumulators plus the bias),
keeps k (float32) and the rounded v in shared memory, takes the column max
and sums over all T keys once, normalizes kh before rounding it, builds the
rounded 64 × 64 state once (wgmma), and multiplies each q tile's rounded
feature softmax by it from registers (exact products of rounded values);
so the float32 q|k|v never reaches device memory. The gate's row pass
writes z as bfloat16, and a wgmma GEMM fed by TMA adds bo and the float32
residual before it stores bfloat16. LayerNorm keeps float32 statistics
under ``fast_ln`` too, as the Pallas kernel does. The kernel holds one
sequence's keys in shared memory: T up to ``whole_max_t(hd)`` (320 at
head width 64, 128 at 128). Past that its streaming form runs
(``hig_fused_block_bf16_stream``, counted in ``launches_bf16_stream``):
the same block and rounding points, its projection writing each key row's
float32 k and rounded v to a device scratch, the column max and sums over
all T keys read from there in the whole form's order, then E built and the
state's wgmma steps taken a 64-row tile at a time, so it equals the whole
form bit for bit where both run. :func:`fused_attention_block_plain` on
bfloat16 inputs is its twin with the same rounding points; products of
rounded values are taken in float32.

Head widths. Every form takes a head width of 16, 32, 64 or 128
(``HEAD_WIDTHS``), each from its own build of the library; at 16 and 32 a
block of the kernel takes one 64-column tile of 64 // hd packed heads
(``csrc/common.cuh``), so the whole form's rows are width 64's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from hig_tpu_torch.ops import _build
from hig_tpu_torch.ops.pallas_attention import (
    CORE_ROUNDINGS,
    FORMS,
    check_cuda_operand,
    check_cuda_width,
    efficient_attention,
    round_bf16,
    tile_width,
    whole_max_t,
    whole_or_stream,
)
from hig_tpu_torch.utils.graphs import counted

LN_EPS = 1e-6


class BlockWeights(NamedTuple):
    """A block's parameters in torch layout (Linear weights are (out, in))."""

    ln_g: torch.Tensor
    ln_b: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    styl_g: torch.Tensor
    styl_b: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor


def _fused_block_bf16_plain(x, key_mask, scale, shift, w: BlockWeights, num_heads: int,
                            interaction: bool, unrounded=()):
    """B1-bf16's twin: the Pallas kernel's rounding points (module doc),
    but those of the core (``CORE_ROUNDINGS``) named in ``unrounded``."""
    f32 = torch.float32
    D = x.shape[-1]
    mask = key_mask.to(f32).expand(x.shape[:-1])
    xf = x.float()
    xn = F.layer_norm(xf, (D,), w.ln_g.float(), w.ln_b.float(), LN_EPS)
    kvn = xn
    if interaction:
        kvn, mask = xn.flip(-3), mask.flip(-2)
    xb, kvb = round_bf16(xn), round_bf16(kvn)
    q = xb @ w.wq.float().T + w.bq.float()
    k = kvb @ w.wk.float().T + w.bk.float()
    v = kvb @ w.wv.float().T + w.bv.float()
    y = efficient_attention(q, k, v, num_heads, mask,
                            tuple(n for n in CORE_ROUNDINGS if n not in unrounded))
    z = F.layer_norm(y, (D,), w.styl_g.float(), w.styl_b.float(), LN_EPS)
    z = F.silu(z * (1 + scale.float()) + shift.float())
    out = round_bf16(z) @ w.wo.float().T + w.bo.float()
    return (xf + out).to(x.dtype)


def fused_attention_block_plain(x, key_mask, scale, shift, w: BlockWeights,
                                num_heads: int, interaction: bool = False, unrounded=()):
    """Plain PyTorch version of B1; on bfloat16 x, the twin of B1-bf16.

    x (..., T, D) — (B, 2, T, D) for the interaction variant; key_mask
    broadcastable to (..., T), x's own mask; scale/shift (..., 1, D).
    ``unrounded`` leaves out roundings of the bfloat16 core, for the
    planted controls that show the kernel's gates fail such a form.
    """
    if x.dtype == torch.bfloat16:
        return _fused_block_bf16_plain(x, key_mask, scale, shift, w, num_heads, interaction,
                                       unrounded)
    if unrounded:
        raise ValueError("only the bfloat16 twin has roundings to leave out")
    D = x.shape[-1]
    mask = key_mask.to(x.dtype).expand(x.shape[:-1])
    xn = F.layer_norm(x, (D,), w.ln_g, w.ln_b, LN_EPS)
    kvn = xn
    if interaction:
        kvn, mask = xn.flip(-3), mask.flip(-2)
    q = F.linear(xn, w.wq, w.bq)
    k = F.linear(kvn, w.wk, w.bk)
    v = F.linear(kvn, w.wv, w.bv)
    y = efficient_attention(q, k, v, num_heads, mask)
    z = F.layer_norm(y, (D,), w.styl_g, w.styl_b, LN_EPS) * (1 + scale) + shift
    return x + F.linear(F.silu(z), w.wo, w.bo)


def fused_attention_block(x, key_mask, scale, shift, w: BlockWeights,
                          num_heads: int, interaction: bool = False, form: str | None = None):
    """One fused efficient-attention block (B1 forward); see the module doc.

    CPU tensors take the plain version; CUDA tensors launch the kernel: the
    float32 form, or for bfloat16 x, scale, shift and weights the bfloat16
    form, whole (``launches_bf16``) or past its rows streaming
    (``launches_bf16_stream``; ``form`` picks one where both run); other
    dtypes raise. B1 has no backward (the
    JAX kernel has no VJP either), so on CUDA tensors it raises when grad is
    enabled and an input requires grad, rather than return an output cut
    off from autograd; training takes B2.
    """
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, key_mask, scale, shift, w, num_heads,
                                           interaction)
    lead, (T, D) = x.shape[:-2], x.shape[-2:]
    if interaction and (x.dim() != 4 or x.shape[1] != 2):
        raise ValueError(f"the interaction variant takes (B, 2, T, D), got {tuple(x.shape)}")
    hd = check_cuda_width(D, num_heads)
    if D % 128 or D > 1024:
        raise ValueError(f"the CUDA block takes D a multiple of 128 up to 1024, got {D}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the fused-block kernel takes float32 or bfloat16 x, got {dt}")
    if dt == torch.bfloat16:
        form = form or whole_or_stream(T, hd)
        if form not in FORMS or (form == "whole" and T > whole_max_t(hd)):
            raise ValueError(f"B1-bf16 has no form {form!r} at T={T}, head width {hd}")
    check_cuda_operand("x", x, dtype=dt)
    N = x.numel() // (T * D)
    mask = key_mask.to(torch.float32).expand(*lead, T).reshape(N, T).contiguous()
    scale = scale.expand(*lead, 1, D).reshape(N, D).contiguous()
    shift = shift.expand(*lead, 1, D).reshape(N, D).contiguous()
    check_cuda_operand("key_mask", mask)
    for name, t in (("scale", scale), ("shift", shift)):
        check_cuda_operand(name, t, dtype=dt)
    shapes = ((D,), (D,), (D, D), (D,), (D, D), (D,), (D, D), (D,), (D,), (D,), (D, D), (D,))
    for name, t, shape in zip(BlockWeights._fields, w, shapes):
        check_cuda_operand(name, t, shape, dtype=dt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, shift, *w)):
        raise RuntimeError(
            "the fused-block kernel (B1) has no backward: call it under torch.no_grad(), "
            "or put the model in train mode, where its blocks take the projected-attention "
            "kernel (B2)"
        )
    y = torch.empty((N * T, D), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if dt == torch.float32:
        qkv = torch.empty((N * T, 3 * D), device=x.device, dtype=torch.float32)
        _build.launch("fused_block", (x, mask, scale, shift, *w, qkv, y, out),
                      (N, T, D, int(interaction)), stream, hd=hd)
        fused_attention_block.launches += 1
        return out
    xz = torch.empty((N * T, D), device=x.device, dtype=torch.bfloat16)  # xn, then z
    launch_bf16((x, mask, scale, shift, *w, xz, y, out), N, T, D, interaction, stream,
                hd=hd, form=form)
    if form == "stream":
        fused_attention_block.launches_bf16_stream += 1
    else:
        fused_attention_block.launches_bf16 += 1
    return out


def launch_bf16(tensors, N: int, T: int, D: int, interaction: bool, stream: int,
                part: int = -1, hd: int = 64, form: str = "whole") -> None:
    """Launch B1-bf16's ``form`` at head width ``hd`` on ``tensors`` (x,
    mask, scale, shift, the 12 weights, xz, y, out; checked by
    :func:`fused_attention_block`; the streaming form's scratch is made
    here): all four launches, or with ``part`` 0..3 only that one (row pass,
    q|k|v + core, gate row pass, Wo GEMM), to time it alone. Counts
    nothing."""
    if form == "stream":
        x = tensors[0]
        tw = tile_width(hd)
        rows = (N * (D // tw), -(-T // 64) * 64, tw)
        tensors = (*tensors, torch.empty(rows, device=x.device, dtype=torch.float32),
                   torch.empty(rows, device=x.device, dtype=torch.bfloat16))
    _build.launch("fused_block", tensors, (N, T, D, int(interaction), part), stream,
                  entry="fused_block_bf16" + ("_stream" if form == "stream" else ""), hd=hd)


counted(fused_attention_block, "launches", "launches_bf16", "launches_bf16_stream")
