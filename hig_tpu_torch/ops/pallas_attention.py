"""B2: efficient attention with the Q/K/V projections fused in; B3: the
efficient-attention core alone; and the plain linear-attention core both
are held against.

Counterpart of ``hig_tpu/ops/pallas_attention.py``: the projected kernel
(``_proj_kernel`` at :116, ``fused_projected_attention`` at :202) and the
core kernel (``_kernel`` at :46, ``fused_efficient_attention`` at :238).

Gradients. Like the JAX ``custom_vjp``s (``_proj_fused_bwd`` at :176,
``_fused_bwd`` at :97), the forward launches the kernel and saves its inputs,
and the backward recomputes the plain version
(:func:`projected_attention_backward`, :func:`efficient_attention_backward`):
no backward is a kernel. ``key_mask`` gets no gradient. B3-bf16's backward
is the VJP of its bfloat16 op chain as XLA takes it, written out
(:func:`efficient_attention_bf16_backward`). B2 on bfloat16 activations with
float32 weights has none: JAX's VJP of that form fails (its recompute is
float32, its cotangent bfloat16), so the wrapper raises when a gradient is
asked of it.

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
stores the output in the input dtype. B2-bf16 does the same in one launch
designed for the H100: one block per (sequence, head) projects the head's
k | v from kv_src and q from q_src on ``wgmma`` (bfloat16 operands from a
TMA ring, float32 accumulators plus the bias), keeps k and v in float32 in
shared memory, builds softmax_time(k) and the 64 × 64 state once in float32
(3xTF32 on ``mma.sync``), takes each 64-row q tile's feature softmax in its
accumulator registers and multiplies it by the state at 3xTF32, and stores
y rounded once. It streams the keys, two 64-row tiles a round, and builds
the state as an online softmax over time (a running column max and sum,
the state rescaled when the max rises, divided by the sum at the end), so
it takes any T, as the Pallas kernel does: a ``--single_transformer``
model's merged timeline is 392 rows at the evaluation length.
:func:`fused_projected_attention_plain` on bfloat16 inputs is its twin;
``rounded`` makes the twin round the core as B1-bf16's Pallas kernel does,
a planted control that the kernel's gates must fail.

B2 on bfloat16 activations with float32 weights (B2-bf16a,
``hig_projected_attention_bf16a``): the Pallas kernel's dot of a bfloat16
row and a float32 weight promotes the row, so q, k, v and the core are
float32 and only y is rounded. B2-bf16's kernel, holding one sequence's
keys whole rather than streaming them, with each float32 weight
split into three bfloat16 pieces (:func:`split_bf16_pieces`; its kernel,
one pass a call, behind :func:`weight_pieces`): a bfloat16 activation
times a piece is exact in float32, so each product is three ``wgmma``
products into float32 accumulators, and T is at most :data:`BF16_MAX_T`.
The port's bfloat16 models reach it in eval mode on float32 master weights
(``--blocks projected`` labeling); :func:`fused_projected_attention_plain`
on those dtypes is its twin. Counted in ``launches_mixed``.

bfloat16 form of B3 (B3-bf16, ``hig_efficient_attention_bf16``). The
Pallas kernel runs the core on bfloat16 q, k, v and mask, so XLA rounds
after each op: the mask bias, each softmax's subtraction, ``exp``, sum (a
float32 sum, rounded) and division, the state (a float32 accumulation of
bfloat16 products, rounded) and y (rounded once). The kernel rounds at
those points: one block of two warpgroups per (sequence, head) takes the
head's columns of q, k and v into shared memory through TMA, the key
passes there, the state and y on ``wgmma`` (products of bfloat16 values
are exact): the whole form, for Tq and Tk up to :data:`BF16_MAX_T`. Above
that the streaming form runs (``hig_efficient_attention_bf16_stream``):
the same rounding points, the column max and the rounded exponentials'
float32 sum taken in two passes over the keys in device memory, then E =
softmax_time(k) recomputed and streamed with v through shared memory in
128-row rounds into the state's float32 accumulator, so it takes any T (a
``--single_transformer`` model's merged timeline is 394 rows at a native
window of 196) and equals the whole form bit for bit where both run
(:func:`b3_bf16_form` picks).
:func:`fused_efficient_attention_plain` on bfloat16 inputs is its twin, and
``unrounded`` leaves out rounding points (:data:`B3_ROUNDINGS`) for the
planted controls. The twin is also JAX's ``efficient_attention`` on
bfloat16 inputs (its einsum route), so B3-bf16 is the core of a bfloat16
model's efficient blocks in train mode (``models/attention.py``).

Lazy forms (``lazy``: JAX's ``LAZY_KNORM``, passed down by the model). JAX
then normalizes the keys after the time contraction: exp(k − max), the
state eᵀv, z = Σ e (``jnp.sum`` upcasts bfloat16: a float32 sum rounded),
the state divided by z. The float32 kernel already divides its state
after the contraction and serves both orders; B3-bf16's two kernels take a
``LAZY`` template flag (``hig_efficient_attention_bf16[_stream]_lazy``,
counted in ``launches_bf16_lazy``) that keeps the rounded exponentials and
divides the rounded state by its row's z at the store, rounding again. The
lazy twin (:data:`B3_LAZY_ROUNDINGS`) and the lazy bfloat16 backward are
JAX's lazy chain and its VJP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hig_tpu_torch.models.embeddings import constant, linear, round_bf16, softmax_vjp
from hig_tpu_torch.ops import _build
from hig_tpu_torch.ops.bf16_sum import bf16_sum
from hig_tpu_torch.utils.graphs import counted

HEAD_DIM = 64  # the only head width the CUDA core takes
MASK_BIAS = -1000000.0
# Rows of one sequence that B1-bf16, B2-bf16a and B3-bf16's whole form keep
# in shared memory whole: the most they take (the ablations' training and
# labeling reach 2 × 91 = 182). B2-bf16 and B3-bf16's streaming form take
# any T.
BF16_MAX_T = 320
# B3-bf16's two forms (the module doc): "whole" up to BF16_MAX_T rows,
# "stream" at any T.
B3_FORMS = ("whole", "stream")
# The roundings of the core that efficient_attention can take (B1-bf16's):
# softmax_time(k), v, the state and softmax_feat(q).
CORE_ROUNDINGS = ("kh", "v", "att", "qh")
# B3-bf16's rounding points past the mask: each softmax's subtraction, exp,
# sum and division ("qh", "kh"), and the state.
B3_ROUNDINGS = ("q_sub", "q_exp", "q_sum", "qh", "k_sub", "k_exp", "k_sum", "kh", "att")
# Its lazy forms' (``lazy``, JAX's LAZY_KNORM): the keys' subtraction, exp and
# sum without the division, the state of the exponentials ("att") and the
# state divided by the sum ("att_z").
B3_LAZY_ROUNDINGS = ("q_sub", "q_exp", "q_sum", "qh", "k_sub", "k_exp", "k_sum", "att",
                     "att_z")


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def efficient_attention(query, key, value, num_heads: int, key_mask=None, rounded=(),
                        lazy: bool = False):
    """Shared plain core of the linear-attention family.

    query (..., T, D), key/value (..., N, D); key_mask (..., N) 0/1.
    softmax(Q over features) · [softmax(K over time)ᵀ V]. ``rounded``
    names roundings to bfloat16 (:data:`CORE_ROUNDINGS`) taken on float32
    operands, as B1-bf16's Pallas kernel takes them. ``lazy`` (JAX's
    ``LAZY_KNORM``) normalizes after the time contraction, in JAX's order:
    m = the time max (no gradient), e = exp(k − m), the state eᵀv divided
    by z = Σ e.
    """
    def r(name, t):
        return round_bf16(t) if name in rounded else t

    if lazy and rounded:
        raise ValueError("the lazy core takes no B1-bf16 roundings")
    D = query.shape[-1]
    q = split_heads(query, num_heads)
    if key_mask is not None:
        key = key + (1.0 - key_mask[..., None]) * MASK_BIAS
        value = value * key_mask[..., None]
    v = split_heads(value, num_heads)
    if lazy:
        k = split_heads(key, num_heads)
        e = torch.exp(k - k.amax(dim=-3, keepdim=True).detach())
        attention = torch.einsum("...nhd,...nhl->...hdl", e, v) / e.sum(dim=-3)[..., None]
        y = torch.einsum("...nhd,...hdl->...nhl", q.softmax(dim=-1), attention)
        return y.reshape(*y.shape[:-2], D)
    k = split_heads(key, num_heads).softmax(dim=-3)  # over the time axis
    q = q.softmax(dim=-1)
    attention = torch.einsum("...nhd,...nhl->...hdl", r("kh", k), r("v", v))
    y = torch.einsum("...nhd,...hdl->...nhl", r("qh", q), r("att", attention))
    return y.reshape(*y.shape[:-2], D)


def merged_qkv(xn, wq, bq, wk, bk, wv, bv):
    """One (D, 3D) product instead of three (D, D) ones; q, k, v order."""
    w = torch.cat([wq, wk, wv], dim=0)
    b = torch.cat([bq, bk, bv])
    return linear(xn, w, b).chunk(3, dim=-1)


def fused_projected_attention_plain(q_src, kv_src, wq, bq, wk, bk, wv, bv,
                                    num_heads: int, key_mask=None, rounded=()):
    """Plain PyTorch version of B2. Weights are torch Linear (out, in). On
    bfloat16 inputs, the twin of B2-bf16: the products of the rounded
    operands in float32, the float32 core, the output rounded; with
    ``rounded`` (:data:`CORE_ROUNDINGS`), the core rounded at those points
    as B1-bf16's is (a planted control)."""
    if q_src.dtype == torch.bfloat16:
        mask = None if key_mask is None else key_mask.float()

        def proj(x, w, b):
            return x.float() @ w.float().T + b.float()

        q = proj(q_src, wq, bq)
        k, v = proj(kv_src, wk, bk), proj(kv_src, wv, bv)
        return efficient_attention(q, k, v, num_heads, mask, rounded).to(q_src.dtype)
    if rounded:
        raise ValueError("only the bfloat16 twin has roundings to take")
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


def split_bf16_pieces(w: torch.Tensor):
    """The three bfloat16 pieces of float32 ``w``: hi = bf16(w), mid =
    bf16(w − hi), lo = bf16(w − hi − mid), each rounded to nearest even
    (both differences are exact in float32). hi + mid + lo = w exactly for
    2^-110 ≤ |w| ≤ 3.39e38 (the largest bfloat16), and a bfloat16 value
    times a piece is exact in float32, so three bfloat16 products give
    B2-bf16a its float32-accurate q, k and v. The plain version of the
    split kernel (:func:`weight_pieces`)."""
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def weight_pieces(wq, wk, wv):
    """B2-bf16a's weight pieces, (3, 3 Dout, D) bfloat16: piece p (hi, mid,
    lo) of [wq; wk; wv], float32 (Dout, D) each. CPU tensors take the plain
    :func:`split_bf16_pieces`; CUDA tensors launch the split kernel that
    B2-bf16a's entry launches before its own (counted in ``launches``)."""
    if wq.device.type == "cpu":
        return torch.stack([torch.cat(p) for p in
                            zip(*(split_bf16_pieces(w) for w in (wq, wk, wv)))])
    Dout, D = wq.shape
    for name, w in (("query", wq), ("key", wk), ("value", wv)):
        check_cuda_operand(f"{name} weight", w, (Dout, D))
    pieces = torch.empty((3, 3 * Dout, D), device=wq.device, dtype=torch.bfloat16)
    _build.launch("projected_attention", (wq, wk, wv, pieces), (D, Dout),
                  torch.cuda.current_stream(wq.device).cuda_stream, entry="split_bf16_pieces")
    weight_pieces.launches += 1
    return pieces


counted(weight_pieces, "launches")


def _launch_projected(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask):
    T, D = q_src.shape[-2:]
    Dout = wq.shape[0]
    N = q_src.numel() // (T * D)
    out = q_src.new_empty((*q_src.shape[:-1], Dout))
    stream = torch.cuda.current_stream(q_src.device).cuda_stream
    if q_src.dtype == torch.bfloat16:
        if wq.dtype == torch.bfloat16:
            _build.launch("projected_attention",
                          (q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, out),
                          (N, T, D, Dout), stream, entry="projected_attention_bf16")
            return out
        # B2-bf16a: the weights split into pieces (scratch), then the kernel
        pieces = torch.empty((3, 3 * Dout, D), device=q_src.device, dtype=torch.bfloat16)
        _build.launch("projected_attention",
                      (q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, pieces, out),
                      (N, T, D, Dout), stream, entry="projected_attention_bf16a")
        return out
    qkv = torch.empty((N * T, 3 * Dout), device=q_src.device, dtype=torch.float32)
    _build.launch("projected_attention", (q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, qkv, out),
                  (N, T, D, Dout), stream)
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
    torch Linear layout (out, in), (Dout, D) with Dout = 64 · num_heads: the
    square model's (D, D), or a tensor-parallel rank's own heads, (D / S,
    D) at num_heads / S heads (the rectangular form); key_mask broadcastable
    to (..., T), the mask of kv_src's tokens. Returns the pre-gate output
    (..., T, Dout) in the activations' dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel, under autograd through :class:`ProjectedAttention`:
    the float32 form, for bfloat16 activations and weights the bfloat16
    form (``launches_bf16``), or for bfloat16 activations with float32
    weights B2-bf16a (``launches_mixed``), which has no backward and raises,
    on either device, when grad is enabled and an input requires it.
    B2-bf16 takes any T, B2-bf16a T up to :data:`BF16_MAX_T`; other dtypes
    raise. A rectangular launch (Dout ≠ D, a tensor-parallel rank's heads)
    of any form is counted in ``launches_rect`` instead.
    """
    adt, wdt = q_src.dtype, wq.dtype
    mixed = adt == torch.bfloat16 and wdt == torch.float32
    if mixed and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q_src, kv_src, wq, bq, wk, bk, wv, bv)):
        raise RuntimeError(
            "projected attention on bfloat16 activations with float32 weights has no "
            "backward (JAX's VJP of this form fails too): call it under torch.no_grad(), "
            "or put the model in train mode, where a bfloat16 model's efficient blocks "
            "take the einsum route through the efficient-attention kernel (B3-bf16)")
    if q_src.device.type == "cpu":
        return fused_projected_attention_plain(q_src, kv_src, wq, bq, wk, bk, wv, bv,
                                               num_heads, key_mask)
    lead, (T, D) = q_src.shape[:-2], q_src.shape[-2:]
    if tuple(kv_src.shape) != tuple(q_src.shape):
        raise ValueError(
            f"the CUDA kernel takes q_src and kv_src of one shape; got "
            f"{tuple(q_src.shape)} and {tuple(kv_src.shape)}"
        )
    Dout = wq.shape[0]
    check_cuda_width(Dout, num_heads)
    if D % HEAD_DIM:
        raise ValueError(f"the projected-attention kernel takes an input width divisible by "
                         f"{HEAD_DIM}, got {D}")
    if (adt, wdt) not in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                          (torch.bfloat16, torch.float32)):
        raise ValueError("the projected-attention kernel takes float32 activations and "
                         "weights, bfloat16 ones, or bfloat16 activations with float32 "
                         f"weights; got {adt} and {wdt}")
    if mixed and T > BF16_MAX_T:
        raise ValueError(f"projected attention on bfloat16 activations with float32 weights "
                         f"takes T up to {BF16_MAX_T}, got {T}")
    check_cuda_operand("q_src", q_src, dtype=adt)
    check_cuda_operand("kv_src", kv_src, dtype=adt)
    for name, w, b in (("query", wq, bq), ("key", wk, bk), ("value", wv, bv)):
        check_cuda_operand(f"{name} weight", w, (Dout, D), dtype=wdt)
        check_cuda_operand(f"{name} bias", b, (Dout,), dtype=wdt)
    if key_mask is None:
        mask = torch.ones((*lead, T), device=q_src.device, dtype=torch.float32)
    else:
        mask = key_mask.to(torch.float32).expand(*lead, T).contiguous()
    check_cuda_operand("key_mask", mask)
    if mixed:
        out = _launch_projected(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask)
    else:
        out = ProjectedAttention.apply(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, num_heads,
                                       kv_src is q_src)
    if Dout != D:
        fused_projected_attention.launches_rect += 1
    elif mixed:
        fused_projected_attention.launches_mixed += 1
    elif adt == torch.bfloat16:
        fused_projected_attention.launches_bf16 += 1
    else:
        fused_projected_attention.launches += 1
    return out


counted(fused_projected_attention, "launches", "launches_bf16", "launches_mixed",
        "launches_rect")



def fused_efficient_attention_plain(query, key, value, num_heads: int, key_mask=None,
                                    unrounded=(), lazy: bool = False):
    """Plain PyTorch version of B3: :func:`efficient_attention`. On bfloat16
    q, k and v, the twin of B3-bf16: float32 values rounded to bfloat16
    where XLA rounds the Pallas kernel's bfloat16 ops (the module doc), but
    at the points of :data:`B3_ROUNDINGS` named in ``unrounded``; output
    bfloat16. Under autograd the twin's gradient is B3-bf16's backward
    (:func:`efficient_attention_bf16_backward`); a twin with roundings left
    out (a planted control) is differentiated by autograd. ``lazy`` (JAX's
    ``LAZY_KNORM``) takes the lazy core: in bfloat16 rounded where XLA
    rounds JAX's lazy chain (:data:`B3_LAZY_ROUNDINGS`)."""
    if query.dtype != torch.bfloat16:
        if unrounded:
            raise ValueError("only the bfloat16 twin has roundings to leave out")
        return efficient_attention(query, key, value, num_heads, key_mask, lazy=lazy)
    known = B3_LAZY_ROUNDINGS if lazy else B3_ROUNDINGS
    unknown = set(unrounded) - set(known)
    if unknown:
        raise ValueError(f"B3-bf16 has no rounding {sorted(unknown)}; it has {known}")
    if unrounded or not needs_grad(query, key, value):
        return _b3_bf16_twin(query, key, value, num_heads, key_mask, unrounded, lazy)
    return HandBackward.apply(
        lambda q, k, v: _b3_bf16_twin(q, k, v, num_heads, key_mask, lazy=lazy),
        lambda q, k, v, g: efficient_attention_bf16_backward(q, k, v, key_mask, g, num_heads,
                                                             **lazy_kw(lazy)),
        query, key, value)


def lazy_kw(lazy: bool) -> dict:
    """The ``lazy`` keyword of B3's functions, given only when set: the
    eager call keeps the plain signature (a substitute core or backward
    without the keyword still fits it)."""
    return {"lazy": True} if lazy else {}


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class HandBackward(torch.autograd.Function):
    """``forward(q, k, v)`` computed without autograd, with the gradients of
    q, k and v from ``backward(q, k, v, grad_out)``: a plain version under
    its bfloat16 backward."""

    @staticmethod
    def forward(ctx, forward, backward, query, key, value):
        ctx.save_for_backward(query, key, value)
        ctx.hand_backward = backward
        return forward(query, key, value)

    @staticmethod
    def backward(ctx, grad_out):
        return (None, None, *ctx.hand_backward(*ctx.saved_tensors, grad_out))


def _b3_bf16_twin(query, key, value, num_heads: int, key_mask=None, unrounded=(),
                  lazy: bool = False):
    p = _b3_bf16_parts(query, key, value, num_heads, key_mask, unrounded, lazy)
    y = torch.einsum("...nhd,...hdl->...nhl", p["qh"], p["att"])
    return y.reshape(*y.shape[:-2], query.shape[-1]).to(torch.bfloat16)


def _b3_bf16_parts(query, key, value, num_heads: int, key_mask=None, unrounded=(),
                   lazy: bool = False) -> dict:
    """The twin's values before y, float32 holding bfloat16 values: each
    softmax's exp e, sum z and quotient (eq, zq, qh over the features; ek,
    zk, kh over time), the masked value vh (heads split) and the state att.
    ``lazy``: ek and zk without the quotient, the state of the exponentials
    (``state``, rounded) and att = state / zk (rounded), zk a float32 sum
    rounded (``jnp.sum`` upcasts bfloat16), kept over time."""
    def r(name, t):
        return t if name in unrounded else round_bf16(t)

    def softmax(x, dim, which):
        e = r(f"{which}_exp", torch.exp(r(f"{which}_sub", x - x.amax(dim, keepdim=True))))
        z = r(f"{which}_sum", e.sum(dim, keepdim=True))
        return e, z, r(f"{which}h", e / z)

    k, v = key.float(), value.float()
    if key_mask is not None:  # the mask, its bias and both products are bfloat16
        m = round_bf16(key_mask.float())[..., None]
        k = round_bf16(k + (1.0 - m) * round_bf16(constant(MASK_BIAS, torch.float32, k.device)))
        v = v * m
    eq, zq, qh = softmax(split_heads(query.float(), num_heads), -1, "q")
    vh = split_heads(v, num_heads)
    kk = split_heads(k, num_heads)
    if lazy:
        ek = r("k_exp", torch.exp(r("k_sub", kk - kk.amax(-3, keepdim=True))))
        zk = r("k_sum", ek.sum(-3, keepdim=True))
        state = r("att", torch.einsum("...nhd,...nhl->...hdl", ek, vh))
        att = r("att_z", state / zk.squeeze(-3)[..., None])
        return dict(eq=eq, zq=zq, qh=qh, ek=ek, zk=zk, vh=vh, state=state, att=att)
    ek, zk, kh = softmax(kk, -3, "k")  # over the time axis
    att = r("att", torch.einsum("...nhd,...nhl->...hdl", kh, vh))
    return dict(eq=eq, zq=zq, qh=qh, ek=ek, zk=zk, kh=kh, vh=vh, att=att)


def efficient_attention_bf16_backward(query, key, value, key_mask, grad_out, num_heads: int,
                                      lazy: bool = False):
    """B3-bf16's backward: the gradients of query, key and value (bfloat16)
    as XLA differentiates JAX's ``efficient_attention`` (and the Pallas
    kernel's ``_fused_bwd`` reference) on bfloat16 operands: the forward
    recomputed with the twin's roundings, then its op chain transposed op
    by op, each op rounded. The state's and y's products transpose into
    products of bfloat16 values, each a float32 sum rounded; each softmax
    into :func:`~hig_tpu_torch.models.embeddings.softmax_vjp` (exp, sum and
    division, no gradient through the max); the mask bias passes dk through
    and the mask multiplies dv. Torch's autograd through the twin would
    round elsewhere, and the float32 VJP rounded once sits as far from this
    as bfloat16 from float32.

    ``lazy``: XLA's VJP of JAX's lazy chain. The division of the state by
    z transposes into d_state = d_att / z and, for z, −Σ_l (d_att · z⁻²) ·
    state, z⁻² = 1 / (z · z), each op rounded and the sum over l the
    ordered bfloat16 sum (the transpose of z's broadcast); z's float32 sum
    passes its gradient to every exponential; the exponentials' gradient
    (the state's share plus z's, a rounded add) times e is dk, with no
    gradient through the max."""
    r = round_bf16
    p = _b3_bf16_parts(query, key, value, num_heads, key_mask, lazy=lazy)
    qh, att, vh = p["qh"], p["att"], p["vh"]
    g = split_heads(grad_out.float(), num_heads)
    d_qh = r(torch.einsum("...nhl,...hdl->...nhd", g, att))
    d_att = r(torch.einsum("...nhd,...nhl->...hdl", qh, g))
    dq = softmax_vjp(d_qh, p["eq"], p["zq"], -1).reshape(query.shape)
    if lazy:
        ek, z = p["ek"], p["zk"].squeeze(-3)[..., None]  # (..., h, d, 1)
        d_state = r(d_att / z)
        inv_z2 = r(1.0 / r(z * z))
        dz = -bf16_sum(r(r(d_att * inv_z2) * p["state"]), -1).squeeze(-1)  # (..., h, d)
        dv = r(torch.einsum("...hdl,...nhd->...nhl", d_state, ek))
        de = r(r(torch.einsum("...hdl,...nhl->...nhd", d_state, vh)) + dz[..., None, :, :])
        dk = r(de * ek).reshape(key.shape)
    else:
        dv = r(torch.einsum("...hdl,...nhd->...nhl", d_att, p["kh"]))
        d_kh = r(torch.einsum("...hdl,...nhl->...nhd", d_att, vh))
        dk = softmax_vjp(d_kh, p["ek"], p["zk"], -3).reshape(key.shape)
    dv = dv.reshape(value.shape)
    if key_mask is not None:
        dv = dv * round_bf16(key_mask.float())[..., None]
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def efficient_attention_backward(saved, grad_out, num_heads: int, needs=(True,) * 3,
                                 lazy: bool = False):
    """B3's backward (``_fused_bwd``): ``saved`` is (query, key, value,
    key_mask); returns the gradients of the first three (None where
    ``needs`` is False). Like JAX's, it differentiates the plain core, not
    the kernel's roundings: in float32 by autograd, and for B3-bf16 in
    bfloat16 op by op (:func:`efficient_attention_bf16_backward`); ``lazy``
    the lazy core's."""
    *operands, mask = saved
    if operands[0].dtype == torch.bfloat16:
        grads = efficient_attention_bf16_backward(*operands, mask, grad_out, num_heads,
                                                  **lazy_kw(lazy))
        return tuple(g if n else None for g, n in zip(grads, needs))

    def plain(q, k, v):
        return efficient_attention(q.float(), k.float(), v.float(), num_heads, mask,
                                   lazy=lazy).to(q.dtype)

    return recompute_grads(plain, operands, needs, grad_out)


def b3_bf16_form(Tq: int, Tk: int) -> str:
    """The form of B3-bf16 that runs at Tq queries over Tk keys: the whole
    form up to :data:`BF16_MAX_T` rows of each, else the streaming form."""
    return "whole" if max(Tq, Tk) <= BF16_MAX_T else "stream"


def _launch_efficient(query, key, value, mask, form=None, lazy: bool = False):
    (Tq, D), Tk = query.shape[-2:], key.shape[-2]
    N = query.numel() // (Tq * D)
    out = torch.empty_like(query)
    entry = None  # the float32 core divides the state after the contraction either way
    if query.dtype == torch.bfloat16:
        form = form or b3_bf16_form(Tq, Tk)
        if form not in B3_FORMS or (form == "whole" and max(Tq, Tk) > BF16_MAX_T):
            raise ValueError(f"B3-bf16 has no form {form!r} at Tq={Tq}, Tk={Tk}")
        entry = ("efficient_attention_bf16" + ("_stream" if form == "stream" else "")
                 + ("_lazy" if lazy else ""))
    _build.launch("efficient_attention", (query, key, value, mask, out), (N, Tq, Tk, D),
                  torch.cuda.current_stream(query.device).cuda_stream, entry=entry)
    return out


def _count_efficient(dt: torch.dtype, lazy: bool) -> None:
    if dt != torch.bfloat16:
        fused_efficient_attention.launches += 1
    elif lazy:
        fused_efficient_attention.launches_bf16_lazy += 1
    else:
        fused_efficient_attention.launches_bf16 += 1


def efficient_attention_bf16_form(query, key, value, num_heads: int, key_mask, form: str,
                                  lazy: bool = False):
    """One launch of B3-bf16's ``form`` ("whole" or "stream"; ``lazy`` its
    lazy form) on CUDA bfloat16 operands, without autograd, counted as
    :func:`fused_efficient_attention` counts it: the two forms side by side
    where both run."""
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    check_cuda_width(D, num_heads)
    check_cuda_operand("query", query, dtype=torch.bfloat16)
    for name, t in (("key", key), ("value", value)):
        check_cuda_operand(name, t, (*lead, Tk, D), dtype=torch.bfloat16)
    mask = key_mask.to(torch.float32).expand(*lead, Tk).contiguous()
    out = _launch_efficient(query, key, value, mask, form, lazy)
    _count_efficient(torch.bfloat16, lazy)
    return out


class EfficientAttention(torch.autograd.Function):
    """B3 under autograd: the forward launches the kernel and saves its
    inputs, the backward is :func:`efficient_attention_backward`."""

    @staticmethod
    def forward(ctx, query, key, value, mask, num_heads, lazy=False):
        ctx.save_for_backward(query, key, value, mask)
        ctx.num_heads, ctx.lazy = num_heads, lazy
        return _launch_efficient(query, key, value, mask, **lazy_kw(lazy))

    @staticmethod
    def backward(ctx, grad_out):
        grads = efficient_attention_backward(ctx.saved_tensors, grad_out, ctx.num_heads,
                                             ctx.needs_input_grad[:3], **lazy_kw(ctx.lazy))
        return (*grads, None, None, None)


def fused_efficient_attention(query, key, value, num_heads: int, key_mask=None,
                              lazy: bool = False):
    """Efficient attention through kernel B3.

    query (..., Tq, D); key/value (..., Tk, D); key_mask broadcastable to
    (..., Tk), 0/1. Returns (..., Tq, D). CPU tensors take the plain
    :func:`fused_efficient_attention_plain`; CUDA tensors launch the
    kernel, under autograd through :class:`EfficientAttention`: the float32
    form, or for bfloat16 q, k and v the bfloat16 form (``launches_bf16``;
    :func:`b3_bf16_form` picks whole or streaming, at any Tq and Tk). Other
    dtypes, and q, k, v of mixed dtypes, raise. ``lazy`` (JAX's
    ``LAZY_KNORM``, passed down by the model) is the lazy core: the float32
    kernel as it is (it divides the state after the contraction), held
    against the lazy twin, and B3-bf16's lazy forms (``launches_bf16_lazy``).
    """
    dt, dts = query.dtype, (query.dtype, key.dtype, value.dtype)
    if torch.bfloat16 in dts and dts != (dt,) * 3:
        raise ValueError(f"the bfloat16 form of B3 takes q, k and v all bfloat16, got {dts}")
    if query.device.type == "cpu":
        return fused_efficient_attention_plain(query, key, value, num_heads, key_mask,
                                               lazy=lazy)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the efficient-attention kernel takes float32 or bfloat16, got {dt}")
    lead, (Tq, D), Tk = query.shape[:-2], query.shape[-2:], key.shape[-2]
    check_cuda_width(D, num_heads)
    check_cuda_operand("query", query, dtype=dt)
    for name, t in (("key", key), ("value", value)):
        check_cuda_operand(name, t, (*lead, Tk, D), dtype=dt)
    if key_mask is None:
        mask = torch.ones((*lead, Tk), device=query.device, dtype=torch.float32)
    else:
        mask = key_mask.to(torch.float32).expand(*lead, Tk).contiguous()
    check_cuda_operand("key_mask", mask)
    out = EfficientAttention.apply(query, key, value, mask, num_heads, lazy)
    _count_efficient(dt, lazy)
    return out


counted(fused_efficient_attention, "launches", "launches_bf16", "launches_bf16_lazy")
