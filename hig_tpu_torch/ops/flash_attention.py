"""B4: quadratic (softmax) attention with an online softmax, forward, and the
plain quadratic attention it is held against.

Counterpart of ``hig_tpu/ops/flash_attention.py`` (``_flash_kernel`` at :53,
``flash_attention`` at :156): softmax(q·kᵀ/√hd + bias)·v per (sequence,
head), with a −1e6 bias at padded keys and, when ``causal``, at keys after
the query. Like the JAX ``custom_vjp`` (``_flash_bwd`` at :141), the
forward launches the kernel and saves its inputs, and the backward
recomputes the plain version under autograd (:func:`flash_attention_backward`,
with the same ``causal`` and ``partner`` flags); ``key_mask`` gets no
gradient. q, k and v may be views of one merged projection, which the kernel
reads in place: their gradients flow back through the views to it.

Kernel note (``csrc/flash_attention.cu``). The TPU kernel transposes to an
(N·H, T, hd) layout and pads T to multiples of 8/128 because Mosaic needs
aligned blocks. On the H100 the kernel reads each head's 64 columns in
place through a row stride instead, so self-attention reads the three
column blocks of one merged q|k|v product and no copy is made; with
``partner`` it reads k, v and the key mask of sequence n ^ 1 (the other
actor), so the interaction block needs no flipped copy either. One block
per (sequence, head, up to 128 queries), one warp per 16 query rows (128
blocks of 6 warps at N = 16, H = 8, T = 91). The block copies the head's
keys and values into shared memory once (cp.async, a commit group per 32
keys); each warp runs q·kᵀ and P·v on the tensor cores in 3xTF32
(mma.sync m16n8k8, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x − hi), lo·hi +
hi·lo + hi·hi in float32) with the online softmax in the accumulator
registers; key ranges past 256 go through in tiles, and causal blocks skip
keys past their last query when key 0 is unmasked. The work there is 0.27
GFLOP against 12 MB, so the card's bound is bytes: 3.6 µs at 3.35 TB/s.

bfloat16 form (B4-bf16, ``hig_flash_attention_bf16``). The Pallas kernel
upcasts q and k to float32 (scores, the online softmax and its running sum
stay float32), walks the keys in blocks of bk = min(128, Tk rounded up to
8), and in each block rounds p = exp(s − running max) to the dtype for
dot(p, v) with float32 accumulation; the output is acc / l in the dtype.
Where p is rounded depends on the block's running max, so B4-bf16 walks the
same key blocks. Its design for the H100 (``csrc/flash_attention.cu``): a
work item is one (sequence, head) with all its query rows, 64 per consumer
warpgroup (up to 4, longer query ranges in passes), so k and v are read
once per (sequence, head); persistent blocks, one per SM, walk over the
items. Each key block (128 rows of k and of v, rows past Tk zero-filled)
comes by TMA into a 2-stage ring with mbarriers, q tiles into a double
buffer per warpgroup, so loads overlap the products. S = q·kᵀ and O += P·V
run on wgmma (bfloat16 operands, float32 accumulators: the upcast
operands' products, exact), P the register A operand taken from the score
registers once p is rounded; the 1/8 scale on the float32 scores, where it
is exact; exp on the special-function unit (float32-level error). Padded
keys of a sequence whose key 0 has mask 1 are skipped: their weight
exp(−1e6 − max) is exactly 0. q, k and v are read in place from the merged
bfloat16 q|k|v product. :func:`flash_attention_plain` on bfloat16 inputs
is its twin, block for block.

Head widths (``csrc/flash_attention.cu``, a library per width). B4 takes
16, 32 and 64 with one warp per 16 query rows, and 128 with a pair of
warps per 16 rows, each holding half of q's depth (split into TF32 parts
once) and half of O's columns, their partial scores summed in shared
memory so that both run the same online softmax. B4-bf16 takes a 16- or
32-wide head from the 64-column tile that holds it (4 or 2 heads packed,
width 64's TMA boxes and descriptors): its depth steps for S, its columns
of O; so D must be a multiple of 64 there.
"""

from __future__ import annotations

import math

import torch

from hig_tpu_torch.models.embeddings import constant, reduced, round_bf16, softmax, softmax_vjp
from hig_tpu_torch.ops import _build
from hig_tpu_torch.ops.pallas_attention import (
    MASK_BIAS,
    HandBackward,
    check_cuda_operand,
    check_cuda_width,
    needs_grad,
    recompute_grads,
    split_heads,
)
from hig_tpu_torch.utils.graphs import counted


def causal_bias(Tq: int, Tk: int | None = None, device=None) -> torch.Tensor:
    """(Tq, Tk, 1) additive logit bias, −1e6 where key j > query i."""
    Tk = Tq if Tk is None else Tk
    i = torch.arange(Tq, device=device)[:, None]
    j = torch.arange(Tk, device=device)[None, :]
    return ((j > i).to(torch.float32) * MASK_BIAS)[..., None]


def quadratic_attention(query, key, value, num_heads: int, logit_bias=None):
    """Standard softmax attention; ``logit_bias`` (..., Tq, Tk, 1) added raw.

    query (..., Tq, D), key/value (..., Tk, D); scale 1/√(D/num_heads), in
    bfloat16 computed in bfloat16 as JAX computes it, with ``jax.nn.softmax``'s
    op chain (``embeddings.softmax``).
    """
    D = query.shape[-1]
    q = split_heads(query, num_heads)
    k = split_heads(key, num_heads)
    v = split_heads(value, num_heads)
    if not reduced(query.dtype):
        scale = 1.0 / math.sqrt(D // num_heads)
    else:
        scale = 1.0 / torch.sqrt(constant(D // num_heads, query.dtype, query.device))
    logits = torch.einsum("...nhd,...mhd->...nmh", q, k) * scale
    if logit_bias is not None:
        logits = logits + logit_bias
    y = torch.einsum("...nmh,...mhd->...nhd", softmax(logits, -2), v)
    return y.reshape(*y.shape[:-2], D)


def pallas_key_block(Tk: int) -> int:
    """The key block of the Pallas kernel's online softmax."""
    return min(128, max(8, -(-Tk // 8) * 8))


def _flash_bf16_plain(query, key, value, num_heads: int, key_mask, causal: bool,
                      partner: bool):
    """B4-bf16's twin: the Pallas kernel's key blocks and rounding points."""
    f32 = torch.float32
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    hd = D // num_heads
    mask = torch.ones((*lead, Tk), dtype=f32, device=query.device)
    if key_mask is not None:
        mask = key_mask.to(f32).expand(*lead, Tk)
    if partner:
        key, value, mask = key.flip(-3), value.flip(-3), mask.flip(-2)
    bk = pallas_key_block(Tk)
    pad = -Tk % bk
    # padded keys are zeros with a zero mask, as the kernel's padding
    key = torch.nn.functional.pad(key, (0, 0, 0, pad))
    value = torch.nn.functional.pad(value, (0, 0, 0, pad))
    mask = torch.nn.functional.pad(mask, (0, pad))
    q = split_heads(query.float() * (1.0 / float(hd) ** 0.5), num_heads)
    k, v = split_heads(key.float(), num_heads), split_heads(value.float(), num_heads)
    m = torch.full((*lead, Tq, num_heads, 1), -1e30, dtype=f32, device=query.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*lead, Tq, num_heads, hd), dtype=f32, device=query.device)
    iq = torch.arange(Tq, device=query.device)[:, None, None]
    for j0 in range(0, Tk + pad, bk):
        s = torch.einsum("...nhd,...mhd->...nhm", q, k[..., j0:j0 + bk, :, :])
        s = s + ((1.0 - mask[..., None, None, j0:j0 + bk]) * MASK_BIAS)
        if causal:
            ik = torch.arange(j0, j0 + bk, device=query.device)
            s = s + torch.where(ik > iq, MASK_BIAS, 0.0)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("...nhm,...mhd->...nhd", p.to(value.dtype).float(),
                          v[..., j0:j0 + bk, :, :])
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(*lead, Tq, D).to(query.dtype)


def flash_attention_plain(query, key, value, num_heads: int, key_mask=None,
                          causal: bool = False, partner: bool = False):
    """Plain PyTorch version of B4; arguments as :func:`flash_attention`. On
    bfloat16 inputs, the twin of B4-bf16, whose gradient under autograd is
    B4-bf16's backward (:func:`flash_attention_bf16_backward`)."""
    if query.dtype == torch.bfloat16:
        if not needs_grad(query, key, value):
            return _flash_bf16_plain(query, key, value, num_heads, key_mask, causal, partner)
        return HandBackward.apply(
            lambda q, k, v: _flash_bf16_plain(q, k, v, num_heads, key_mask, causal, partner),
            lambda q, k, v, g: flash_attention_bf16_backward(q, k, v, key_mask, g, num_heads,
                                                             causal, partner),
            query, key, value)
    Tq, Tk = query.shape[-2], key.shape[-2]
    mask = None
    if key_mask is not None:
        mask = key_mask.to(query.dtype).expand(*query.shape[:-2], Tk)
    if partner:
        key, value = key.flip(-3), value.flip(-3)
        mask = None if mask is None else mask.flip(-2)
    bias = None
    if mask is not None:
        bias = (1.0 - mask)[..., None, :, None] * MASK_BIAS
    if causal:
        c = causal_bias(Tq, Tk, query.device)
        bias = c if bias is None else bias + c
    return quadratic_attention(query, key, value, num_heads, logit_bias=bias)


def row_stride(name: str, t: torch.Tensor, dtype=torch.float32) -> int:
    """The row stride of a ``dtype`` CUDA tensor (..., T, D) whose rows are
    contiguous and evenly spaced, as a column slice of a wider buffer is;
    raises for any other layout."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    ld = t.stride(-2)
    if t.stride(-1) != 1 or ld % (16 // t.element_size()) or ld < t.shape[-1]:
        raise ValueError(f"{name} must have contiguous rows, got strides {t.stride()}")
    rows = t.shape[-2]
    for size, stride in zip(reversed(t.shape[:-2]), reversed(t.stride()[:-2])):
        if size != 1 and stride != rows * ld:
            raise ValueError(f"{name} must have evenly spaced rows, got strides {t.stride()}")
        rows *= size
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return ld


def flash_attention_bf16_backward(query, key, value, key_mask, grad_out, num_heads: int,
                                  causal: bool, partner: bool):
    """B4-bf16's backward: the gradients of query, key and value (bfloat16)
    as XLA differentiates ``_flash_bwd``'s reference (einsum attention,
    ``hig_tpu/ops/flash_attention.py:26-38``) on bfloat16 operands, op by
    op: the scores s = bf16(q·kᵀ)·bf16(1/√hd) plus the mask's and the causal
    bias of bf16(−1e6), each rounded, the softmax op chain, then its
    transpose: dv = wᵀ·g, dw = g·vᵀ, ds = softmax_vjp(dw)·scale, dq = ds·k,
    dk = dsᵀ·q, each product a float32 sum rounded. Torch's autograd
    through the twin (the Pallas kernel's float32 online softmax) sits as
    far from this as bfloat16 from float32."""
    r = round_bf16
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    mask = torch.ones((*lead, Tk), dtype=torch.float32, device=query.device)
    if key_mask is not None:
        mask = key_mask.float().expand(*lead, Tk)
    if partner:
        key, value, mask = key.flip(-3), value.flip(-3), mask.flip(-2)
    q, k, v, g = (split_heads(t.float(), num_heads) for t in (query, key, value, grad_out))
    scale = r(constant(1.0 / math.sqrt(D // num_heads), torch.float32, query.device))
    big = r(constant(MASK_BIAS, torch.float32, query.device))
    s = r(r(torch.einsum("...nhd,...mhd->...nmh", q, k)) * scale)
    s = r(s + (1.0 - mask)[..., None, :, None] * big)
    if causal:
        s = r(s + (causal_bias(Tq, Tk, query.device) < 0) * big)
    e = r(torch.exp(r(s - s.amax(-2, keepdim=True))))  # over the keys
    z = r(e.sum(-2, keepdim=True))
    w = r(e / z)
    dv = r(torch.einsum("...nmh,...nhd->...mhd", w, g))
    dw = r(torch.einsum("...nhd,...mhd->...nmh", g, v))
    ds = r(softmax_vjp(dw, e, z, -2) * scale)
    dq = r(torch.einsum("...nmh,...mhd->...nhd", ds, k)).reshape(query.shape)
    dk = r(torch.einsum("...nmh,...nhd->...mhd", ds, q)).reshape(key.shape)
    dv = dv.reshape(value.shape)
    if partner:
        dk, dv = dk.flip(-3), dv.flip(-3)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def flash_attention_backward(saved, grad_out, num_heads: int, causal: bool, partner: bool,
                             needs=(True,) * 3):
    """B4's backward (``_flash_bwd``): ``saved`` is (query, key, value,
    key_mask); returns the gradients of the first three (None where
    ``needs`` is False): by autograd through the plain version in float32,
    by :func:`flash_attention_bf16_backward` in bfloat16."""
    *operands, mask = saved
    if operands[0].dtype == torch.bfloat16:
        grads = flash_attention_bf16_backward(*operands, mask, grad_out, num_heads, causal,
                                              partner)
        return tuple(g if n else None for g, n in zip(grads, needs))
    return recompute_grads(
        lambda q, k, v: flash_attention_plain(q, k, v, num_heads, mask, causal, partner),
        operands, needs, grad_out)


def _launch_flash(query, key, value, mask, num_heads, causal, partner):
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    N = query.numel() // (Tq * D)
    out = torch.empty((*lead, Tq, D), device=query.device, dtype=query.dtype)
    bf16 = query.dtype == torch.bfloat16
    _build.launch("flash_attention", (query, key, value, mask, out),
                  (N, num_heads, Tq, Tk, query.stride(-2), key.stride(-2), D, int(partner),
                   int(causal)),
                  torch.cuda.current_stream(query.device).cuda_stream,
                  entry="flash_attention_bf16" if bf16 else None, hd=D // num_heads)
    return out


class FlashAttention(torch.autograd.Function):
    """B4 under autograd: the forward launches the kernel and saves its
    inputs (views stay views), the backward is :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, query, key, value, mask, num_heads, causal, partner):
        ctx.save_for_backward(query, key, value, mask)
        ctx.flags = num_heads, causal, partner
        return _launch_flash(query, key, value, mask, num_heads, causal, partner)

    @staticmethod
    def backward(ctx, grad_out):
        grads = flash_attention_backward(ctx.saved_tensors, grad_out, *ctx.flags,
                                         ctx.needs_input_grad[:3])
        return (*grads, None, None, None, None)


def flash_attention(query, key, value, num_heads: int, key_mask=None,
                    causal: bool = False, partner: bool = False):
    """Quadratic attention through kernel B4.

    query (..., Tq, D); key/value (..., Tk, D); key_mask broadcastable to
    (..., Tk), 0/1, the mask of key's own sequences. ``causal`` masks keys
    after the query. ``partner`` attends to the other actor: k, v and the
    mask are taken flipped on the actor axis (the axis before T, of size 2).
    Returns (..., Tq, D). CPU tensors take the plain version; CUDA tensors
    launch the kernel, under autograd through :class:`FlashAttention`, which
    reads q, k and v in place as long as each has evenly spaced contiguous
    rows (k and v at one stride): the float32 form, or for bfloat16 q, k and
    v the bfloat16 form (``launches_bf16``); other dtypes raise.
    """
    if query.device.type == "cpu":
        return flash_attention_plain(query, key, value, num_heads, key_mask, causal, partner)
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    for name, t in (("key", key), ("value", value)):
        if tuple(t.shape) != (*lead, Tk, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(*lead, Tk, D)}")
    if partner and (not lead or lead[-1] != 2):
        raise ValueError(f"partner attention takes (..., 2, T, D), got {tuple(query.shape)}")
    check_cuda_width(D, num_heads)
    dt = query.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the flash-attention kernel takes float32 or bfloat16, got {dt}")
    row_stride("query", query, dt)
    ldkv = row_stride("key", key, dt)
    if row_stride("value", value, dt) != ldkv:
        raise ValueError("the CUDA kernel takes key and value at one row stride; got "
                         f"{key.stride(-2)} and {value.stride(-2)}")
    if key_mask is None:
        mask = torch.ones((*lead, Tk), device=query.device, dtype=torch.float32)
    else:
        mask = key_mask.to(torch.float32).expand(*lead, Tk).contiguous()
    check_cuda_operand("key_mask", mask)
    out = FlashAttention.apply(query, key, value, mask, num_heads, causal, partner)
    if dt == torch.bfloat16:
        flash_attention.launches_bf16 += 1
    else:
        flash_attention.launches += 1
    return out


counted(flash_attention, "launches", "launches_bf16")
