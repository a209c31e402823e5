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
"""

from __future__ import annotations

import math

import torch

from hig_tpu_torch.ops import _build
from hig_tpu_torch.ops.pallas_attention import (
    MASK_BIAS,
    check_cuda_operand,
    check_cuda_width,
    recompute_grads,
    split_heads,
)


def causal_bias(Tq: int, Tk: int | None = None, device=None) -> torch.Tensor:
    """(Tq, Tk, 1) additive logit bias, −1e6 where key j > query i."""
    Tk = Tq if Tk is None else Tk
    i = torch.arange(Tq, device=device)[:, None]
    j = torch.arange(Tk, device=device)[None, :]
    return ((j > i).to(torch.float32) * MASK_BIAS)[..., None]


def quadratic_attention(query, key, value, num_heads: int, logit_bias=None):
    """Standard softmax attention; ``logit_bias`` (..., Tq, Tk, 1) added raw.

    query (..., Tq, D), key/value (..., Tk, D); scale 1/√(D/num_heads).
    """
    D = query.shape[-1]
    q = split_heads(query, num_heads)
    k = split_heads(key, num_heads)
    v = split_heads(value, num_heads)
    logits = torch.einsum("...nhd,...mhd->...nmh", q, k) * (1.0 / math.sqrt(D // num_heads))
    if logit_bias is not None:
        logits = logits + logit_bias
    y = torch.einsum("...nmh,...mhd->...nhd", logits.softmax(dim=-2), v)
    return y.reshape(*y.shape[:-2], D)


def flash_attention_plain(query, key, value, num_heads: int, key_mask=None,
                          causal: bool = False, partner: bool = False):
    """Plain PyTorch version of B4; arguments as :func:`flash_attention`."""
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


def row_stride(name: str, t: torch.Tensor) -> int:
    """The row stride of a float32 CUDA tensor (..., T, D) whose rows are
    contiguous and evenly spaced, as a column slice of a wider buffer is;
    raises for any other layout."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    ld = t.stride(-2)
    if t.stride(-1) != 1 or ld % 4 or ld < t.shape[-1]:
        raise ValueError(f"{name} must have contiguous rows, got strides {t.stride()}")
    rows = t.shape[-2]
    for size, stride in zip(reversed(t.shape[:-2]), reversed(t.stride()[:-2])):
        if size != 1 and stride != rows * ld:
            raise ValueError(f"{name} must have evenly spaced rows, got strides {t.stride()}")
        rows *= size
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return ld


def flash_attention_backward(saved, grad_out, num_heads: int, causal: bool, partner: bool,
                             needs=(True,) * 3):
    """B4's backward (``_flash_bwd``): ``saved`` is (query, key, value,
    key_mask); returns the gradients of the first three."""
    *operands, mask = saved
    return recompute_grads(
        lambda q, k, v: flash_attention_plain(q, k, v, num_heads, mask, causal, partner),
        operands, needs, grad_out)


def _launch_flash(query, key, value, mask, num_heads, causal, partner):
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    N = query.numel() // (Tq * D)
    out = torch.empty((*lead, Tq, D), device=query.device, dtype=torch.float32)
    _build.launch("flash_attention", (query, key, value, mask, out),
                  (N, num_heads, Tq, Tk, query.stride(-2), key.stride(-2), D, int(partner),
                   int(causal)),
                  torch.cuda.current_stream(query.device).cuda_stream)
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
    rows (k and v at one stride).
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
    row_stride("query", query)
    ldkv = row_stride("key", key)
    if row_stride("value", value) != ldkv:
        raise ValueError("the CUDA kernel takes key and value at one row stride; got "
                         f"{key.stride(-2)} and {value.stride(-2)}")
    if key_mask is None:
        mask = torch.ones((*lead, Tk), device=query.device, dtype=torch.float32)
    else:
        mask = key_mask.to(torch.float32).expand(*lead, Tk).contiguous()
    check_cuda_operand("key_mask", mask)
    out = FlashAttention.apply(query, key, value, mask, num_heads, causal, partner)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
