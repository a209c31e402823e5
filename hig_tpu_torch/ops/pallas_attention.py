"""B2: efficient attention with the Q/K/V projections fused in; B3: the
efficient-attention core alone; and the plain linear-attention core both
are held against.

Counterpart of ``hig_tpu/ops/pallas_attention.py``: the projected kernel
(``_proj_kernel`` at :116, ``fused_projected_attention`` at :202) and the
core kernel (``_kernel`` at :46, ``fused_efficient_attention`` at :238).

Gradients. Like the JAX ``custom_vjp``s (``_proj_fused_bwd`` at :176,
``_fused_bwd`` at :97), the forward launches the kernel and saves its inputs,
and the backward recomputes the plain version under autograd
(:func:`projected_attention_backward`, :func:`efficient_attention_backward`):
no backward is a kernel. ``key_mask`` gets no gradient.

Kernel note (``csrc/projected_attention.cu``). The TPU kernel ran one grid
step per sequence with the three (D, D) weights resident in VMEM. On the
H100 one f32 (512, 512) weight is 1 MB and a block has 227 KB of shared
memory, and 16 sequences would fill 16 of 132 SMs, so the work is two
launches: the q|k|v GEMM of B1 (96×64 tiles, a 3-stage cp.async ring,
3xTF32 products on the tensor cores through mma.sync m16n8k8; 16 × 24 =
384 blocks at N = 16, T = 91, D = 512) and the attention core of B1 (one
block per (head, sequence, 32 queries), 384 blocks, which builds the
64×64 KᵀV state on the tensor cores while the next 32 keys arrive by
cp.async). At the serving shape the work is 2.5 GFLOP against 12 MB, so
the bound is the card's 3xTF32 rate (495 / 3 TFLOP/s): 0.015 ms; the
q|k|v intermediate (9 MB) stays in L2 between the two launches.

Kernel note (``csrc/efficient_attention.cu``). The TPU kernel ran one grid
step per (sequence, head) on an (N·H, T, hd) copy of q, k and v. On the
H100 B3 is one launch of the same core, which reads each head's columns of
the (N, T, D) tensors in place (row stride D): 384 blocks at N = 16, H = 8,
T = 91. The work is ~0.19 GFLOP against ~12 MB, so the bound is bytes
(~3.6 µs at 3.35 TB/s); the core reads q, k and v once from device memory
(k again, from L2, for its column max and in each query block of a head)
and keeps the KᵀV state in shared memory.

bfloat16 form of B2 (B2-bf16, ``hig_projected_attention_bf16``). The
Pallas kernel takes q/k/v = dot(x, W) with float32 accumulation plus the
bias, keeps the whole core in float32 (its two dots take no cast) and
stores the output in the input dtype. B2-bf16 does the same: the q|k|v
GEMM takes bfloat16 operands (mma.sync m16n8k16, float32 accumulators) and
writes float32, the core is B2's 3xTF32 float32 core, and it stores y as
bfloat16. :func:`fused_projected_attention_plain` on bfloat16 inputs is its
twin. B3 has no bfloat16 form (no model path calls it): its wrapper raises
on a bfloat16 tensor on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hig_tpu_torch.models.embeddings import linear
from hig_tpu_torch.ops import _build

HEAD_DIM = 64  # the only head width the CUDA core takes
MASK_BIAS = -1000000.0


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def efficient_attention(query, key, value, num_heads: int, key_mask=None):
    """Shared plain core of the linear-attention family.

    query (..., T, D), key/value (..., N, D); key_mask (..., N) 0/1.
    softmax(Q over features) · [softmax(K over time)ᵀ V].
    """
    D = query.shape[-1]
    q = split_heads(query, num_heads)
    if key_mask is not None:
        key = key + (1.0 - key_mask[..., None]) * MASK_BIAS
        value = value * key_mask[..., None]
    k = split_heads(key, num_heads).softmax(dim=-3)  # over the time axis
    v = split_heads(value, num_heads)
    q = q.softmax(dim=-1)
    attention = torch.einsum("...nhd,...nhl->...hdl", k, v)
    y = torch.einsum("...nhd,...hdl->...nhl", q, attention)
    return y.reshape(*y.shape[:-2], D)


def merged_qkv(xn, wq, bq, wk, bk, wv, bv):
    """One (D, 3D) product instead of three (D, D) ones; q, k, v order."""
    w = torch.cat([wq, wk, wv], dim=0)
    b = torch.cat([bq, bk, bv])
    return linear(xn, w, b).chunk(3, dim=-1)


def fused_projected_attention_plain(q_src, kv_src, wq, bq, wk, bk, wv, bv,
                                    num_heads: int, key_mask=None):
    """Plain PyTorch version of B2. Weights are torch Linear (out, in). On
    bfloat16 inputs, the twin of B2-bf16: the products of the rounded
    operands in float32, the float32 core, the output rounded."""
    if q_src.dtype == torch.bfloat16:
        mask = None if key_mask is None else key_mask.float()

        def proj(x, w, b):
            return x.float() @ w.float().T + b.float()

        q = proj(q_src, wq, bq)
        k, v = proj(kv_src, wk, bk), proj(kv_src, wv, bv)
        return efficient_attention(q, k, v, num_heads, mask).to(q_src.dtype)
    if kv_src is q_src:
        q, k, v = merged_qkv(q_src, wq, bq, wk, bk, wv, bv)
    else:
        q = F.linear(q_src, wq, bq)
        k = F.linear(kv_src, wk, bk)
        v = F.linear(kv_src, wv, bv)
    return efficient_attention(q, k, v, num_heads, key_mask)


def check_cuda_operand(name: str, t: torch.Tensor, shape=None, dtype=torch.float32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_cuda_width(D: int, num_heads: int) -> None:
    if D % num_heads or D // num_heads != HEAD_DIM:
        raise ValueError(
            f"the CUDA kernels take a head dim of {HEAD_DIM}; "
            f"got D={D}, heads={num_heads}"
        )


def recompute_grads(plain, operands, needs, grad_out, same=()):
    """The backward of a kernel whose JAX VJP recomputes its plain version.

    Gradients of ``plain(*operands)`` against ``grad_out``, by autograd
    through the plain version, for the operands whose ``needs`` flag is set
    (None for the others). ``same`` holds (i, j) pairs where operand j is
    operand i: j then reuses i's leaf, i's gradient holds both shares and
    j's is None.
    """
    leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(operands, needs)]
    for i, j in same:
        leaves[j] = leaves[i]
    aliased = {j for _, j in same}
    wanted = [i for i, leaf in enumerate(leaves) if leaf.requires_grad and i not in aliased]
    with torch.enable_grad():
        out = plain(*leaves)
    grads = torch.autograd.grad(out, [leaves[i] for i in wanted], grad_out, allow_unused=True)
    result = [None] * len(leaves)
    for i, g in zip(wanted, grads):
        result[i] = g
    return tuple(result)


def projected_attention_backward(saved, grad_out, num_heads: int, merged: bool,
                                 needs=(True,) * 8):
    """B2's backward (``_proj_fused_bwd``): ``saved`` is (q_src, kv_src, wq,
    bq, wk, bk, wv, bv, key_mask); returns the gradients of the first eight.
    ``merged`` says that kv_src is q_src, so the recompute takes the plain
    version's merged q|k|v product and q_src's gradient holds kv_src's share."""
    *operands, mask = saved

    def plain(q_src, kv_src, wq, bq, wk, bk, wv, bv):
        return fused_projected_attention_plain(q_src, kv_src, wq, bq, wk, bk, wv, bv,
                                               num_heads, mask)

    return recompute_grads(plain, operands, needs, grad_out, ((0, 1),) if merged else ())


def _launch_projected(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask):
    T, D = q_src.shape[-2:]
    N = q_src.numel() // (T * D)
    qkv = torch.empty((N * T, 3 * D), device=q_src.device, dtype=torch.float32)
    out = torch.empty_like(q_src)
    bf16 = q_src.dtype == torch.bfloat16
    _build.launch("projected_attention", (q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, qkv, out),
                  (N, T, D), torch.cuda.current_stream(q_src.device).cuda_stream,
                  entry="projected_attention_bf16" if bf16 else None)
    return out


class ProjectedAttention(torch.autograd.Function):
    """B2 under autograd: the forward launches the kernel and saves its
    inputs, the backward is :func:`projected_attention_backward`."""

    @staticmethod
    def forward(ctx, q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, num_heads, merged):
        ctx.save_for_backward(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask)
        ctx.num_heads, ctx.merged = num_heads, merged
        return _launch_projected(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask)

    @staticmethod
    def backward(ctx, grad_out):
        grads = projected_attention_backward(ctx.saved_tensors, grad_out, ctx.num_heads,
                                             ctx.merged, ctx.needs_input_grad[:8])
        return (*grads, None, None, None)


def fused_projected_attention(q_src, kv_src, wq, bq, wk, bk, wv, bv,
                              num_heads: int, key_mask=None):
    """Efficient attention with the QKV projections fused in (B2).

    q_src (..., T, D) and kv_src (..., T, D), already normalized; weights in
    torch Linear layout (out, in); key_mask broadcastable to (..., T), the
    mask of kv_src's tokens. Returns the pre-gate output (..., T, D).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    under autograd through :class:`ProjectedAttention`: the float32 form,
    or for bfloat16 activations and weights the bfloat16 form
    (``launches_bf16``); other dtypes raise.
    """
    if q_src.device.type == "cpu":
        return fused_projected_attention_plain(q_src, kv_src, wq, bq, wk, bk, wv, bv,
                                               num_heads, key_mask)
    lead, (T, D) = q_src.shape[:-2], q_src.shape[-2:]
    if tuple(kv_src.shape) != tuple(q_src.shape):
        raise ValueError(
            f"the CUDA kernel takes q_src and kv_src of one shape; got "
            f"{tuple(q_src.shape)} and {tuple(kv_src.shape)}"
        )
    check_cuda_width(D, num_heads)
    dt = q_src.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the projected-attention kernel takes float32 or bfloat16, got {dt}")
    check_cuda_operand("q_src", q_src, dtype=dt)
    check_cuda_operand("kv_src", kv_src, dtype=dt)
    for name, w, b in (("query", wq, bq), ("key", wk, bk), ("value", wv, bv)):
        check_cuda_operand(f"{name} weight", w, (D, D), dtype=dt)
        check_cuda_operand(f"{name} bias", b, (D,), dtype=dt)
    if key_mask is None:
        mask = torch.ones((*lead, T), device=q_src.device, dtype=torch.float32)
    else:
        mask = key_mask.to(torch.float32).expand(*lead, T).contiguous()
    check_cuda_operand("key_mask", mask)
    out = ProjectedAttention.apply(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, num_heads,
                                   kv_src is q_src)
    if dt == torch.bfloat16:
        fused_projected_attention.launches_bf16 += 1
    else:
        fused_projected_attention.launches += 1
    return out


fused_projected_attention.launches = 0
fused_projected_attention.launches_bf16 = 0
B3_BF16 = ("the efficient-attention kernel (B3) has no bfloat16 form: no model path calls it "
           "(ROADMAP.md, Queue B: 'B3-bf16, not ported')")


def efficient_attention_backward(saved, grad_out, num_heads: int, needs=(True,) * 3):
    """B3's backward (``_fused_bwd``): ``saved`` is (query, key, value,
    key_mask); returns the gradients of the first three."""
    *operands, mask = saved
    return recompute_grads(lambda q, k, v: efficient_attention(q, k, v, num_heads, mask),
                           operands, needs, grad_out)


def _launch_efficient(query, key, value, mask):
    (Tq, D), Tk = query.shape[-2:], key.shape[-2]
    N = query.numel() // (Tq * D)
    out = torch.empty_like(query)
    _build.launch("efficient_attention", (query, key, value, mask, out), (N, Tq, Tk, D),
                  torch.cuda.current_stream(query.device).cuda_stream)
    return out


class EfficientAttention(torch.autograd.Function):
    """B3 under autograd: the forward launches the kernel and saves its
    inputs, the backward is :func:`efficient_attention_backward`."""

    @staticmethod
    def forward(ctx, query, key, value, mask, num_heads):
        ctx.save_for_backward(query, key, value, mask)
        ctx.num_heads = num_heads
        return _launch_efficient(query, key, value, mask)

    @staticmethod
    def backward(ctx, grad_out):
        grads = efficient_attention_backward(ctx.saved_tensors, grad_out, ctx.num_heads,
                                             ctx.needs_input_grad[:3])
        return (*grads, None, None)


def fused_efficient_attention(query, key, value, num_heads: int, key_mask=None):
    """Efficient attention through kernel B3.

    query (..., Tq, D); key/value (..., Tk, D); key_mask broadcastable to
    (..., Tk), 0/1. Returns (..., Tq, D). CPU tensors take the plain
    :func:`efficient_attention`; CUDA tensors launch the kernel, under
    autograd through :class:`EfficientAttention`. A bfloat16 tensor raises
    on every device (:data:`B3_BF16`).
    """
    if torch.bfloat16 in (query.dtype, key.dtype, value.dtype):
        raise ValueError(B3_BF16)
    if query.device.type == "cpu":
        return efficient_attention(query, key, value, num_heads, key_mask)
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    check_cuda_width(D, num_heads)
    check_cuda_operand("query", query)
    for name, t in (("key", key), ("value", value)):
        check_cuda_operand(name, t, (*lead, Tk, D))
    if key_mask is None:
        mask = torch.ones((*lead, Tk), device=query.device, dtype=torch.float32)
    else:
        mask = key_mask.to(torch.float32).expand(*lead, Tk).contiguous()
    check_cuda_operand("key_mask", mask)
    out = EfficientAttention.apply(query, key, value, mask, num_heads)
    fused_efficient_attention.launches += 1
    return out


fused_efficient_attention.launches = 0
