"""Attention blocks of the interaction denoiser (counterpart of
``hig_tpu/models/attention.py``).

Two families, each with the residual and the AdaLN ``StylizationBlock``
gate applied inside each block. Every leading axis before (T, D) is batch,
so the (B, actors, T, D) layout flows through, and so does a
``--single_transformer`` model's merged (B, 2T, D) timeline.

* Efficient (linear) attention, the default: softmax(Q over features) ·
  [softmax(K over time)ᵀ V]. The self-attention and interaction blocks
  always go through a kernel wrapper: B1 (``ops/fused_block.py``, the whole
  block) when ``fused`` and the module is in eval mode, else B2
  (``ops/pallas_attention.py``, projections + attention core) between a
  plain LayerNorm and the plain gate. B1 has no backward, so a module in
  train mode takes B2, as the JAX blocks take their unfused route when not
  ``deterministic`` (a bfloat16 model B3-bf16: the route rule below).
* Causal efficient attention (``causal``, counterpart of JAX's
  ``causal_efficient_attention``): position i's time softmax over the keys
  j ≤ i, by cumulative sums (:func:`causal_efficient_attention`). As in
  JAX, whose blocks test ``not self.causal`` before the fused kernel and
  before ``use_pallas``, a causal block always takes the einsum route
  below (``merged_qkv``, the actor flip, the causal core) in either dtype
  and either mode: it launches no kernel. The core keeps the running
  (T, H, 64, 64) state; under autograd it saves its inputs only and
  recomputes itself in the backward (:class:`CausalCore`), the same
  arithmetic in the same order.
* Quadratic (softmax) attention, the ``--no_eff`` model. The self-attention
  and interaction blocks always go through B4 (``ops/flash_attention.py``).
  The reference's quirks are kept: padded keys get a −1e6 bias (the JAX
  package's einsum interaction path uses −1e5; both give exactly zero
  weight in float32), and the interaction block normalizes x with ``norm``
  and the partner with its own ``text_norm``.

Tensor parallelism (``tp``, set by ``parallel.mesh.place_tp``; JAX's
Megatron rule). A rank holds the columns of its H/S heads of
query/key/value (and its slice of their biases), the columns of linear1
and the rows of linear2; every norm, the ``StylizationBlock`` gates and
the embeddings stay whole. The self-attention and interaction blocks take
B2 on the rank's own heads with (D/S, D) weights (its rectangular form),
or the einsum route on them, then all-gather y on the feature axis before
the replicated gate. B1 is not launched under TP: it fuses the gate's
replicated Wo after the core, which needs every head. The text
cross-attention keeps its rank's heads (their KᵀV state too) and gathers
y the same way; the quadratic blocks hand B4 the rank's heads. The FFN
runs linear1 column-parallel, GELU on the rank's columns, linear2
row-parallel, an all-reduce of the partial sums and then linear2's bias
once. The collectives are autograd functions: the backward sums the
ranks' partial gradients where a replicated activation entered the
column-parallel products.

Sequence parallelism (``sp``, set by ``parallel.mesh.place_sequence``;
JAX's ``sequence_sharding``): x is a rank's slice of the time axis. The
efficient self-attention and interaction blocks take the einsum route with
:func:`sequence_parallel_attention`, whose time max, exp-sum and KᵀV moment
are this slice's partial reductions, all-reduced over the ranks; every
other op acts per token. Forward only, plain PyTorch, as JAX's SP denoiser.

On CPU tensors each kernel wrapper runs its plain version. The text
cross-attention and the FFN are plain PyTorch on every device, as JAX
computes them outside any Pallas kernel. :func:`_attend` routes bare
efficient attention through B3 (``fused_efficient_attention``), as the JAX
``_attend`` does under ``use_pallas``; no block calls it.

In bfloat16 (``dtype``) every block computes in the dtype and rounds where
the flax block rounds (``embeddings.py``); the self-attention and
interaction blocks hand bfloat16 tensors to B1, B2 or B3, the quadratic ones
to B4, which take their bfloat16 forms. ``fast_ln`` and ``rms`` reach the
efficient blocks' norms, the FFN's gate and every efficient block's
``StylizationBlock``; the text cross-attention's ``text_norm`` stays a
float32-statistics LayerNorm, and the quadratic blocks take neither.

The route rule of a bfloat16 model. Training and labeling keep float32
master weights (parameters, Adam's moments and the EMA stay float32, as
JAX's mixed precision keeps them); serving and evaluation cast them once
(``weights.cast_floating``). Each route is held against the JAX route that
computes the same function:

- train mode (the train step and the validation pass): JAX's loss with
  ``use_pallas=False``, the only bfloat16 route whose VJP JAX can take (its
  ``use_pallas`` VJP recomputes B2 in float32 and fails on the bfloat16
  cotangent). The efficient self-attention and interaction blocks take its
  einsum route: ``merged_qkv`` (the product, then the bias add, each
  rounded), k, v and the key mask flipped on the actor axis for the
  interaction block, the core through B3-bf16 (``fused_efficient_attention``,
  whose twin is JAX's ``efficient_attention`` in bfloat16 and whose
  backward is XLA's VJP of it), then the gate. The quadratic blocks take
  B4-bf16 (JAX ``no_eff=True, use_pallas=True``; its backward likewise);
- eval mode with ``fused`` (labeling's default, LayerNorm models): JAX's
  ``fused_blocks=True`` scorer. B1-bf16 on the block's weights cast to
  bfloat16 per call, as ``_fused_block_apply`` casts them; the rest of the
  model keeps its float32 parameters (the norms apply float32 scales);
- eval mode, unfused (``--blocks projected`` and every ``rms_norm`` model):
  JAX's ``use_pallas=True`` scorer, whose Pallas kernel takes the bfloat16
  activations with the raw float32 weights: B2-bf16a, forward only;
- serving and evaluation, weights cast: B1-bf16 or B2-bf16, and B4-bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from hig_tpu_torch.models.embeddings import (
    StylizationBlock,
    column_dense,
    constant,
    gelu,
    linear,
    make_norm,
    reduced,
    row_dense,
    softmax,
)
from hig_tpu_torch.ops.flash_attention import (
    causal_bias,
    flash_attention,
    quadratic_attention,
)
from hig_tpu_torch.ops.fused_block import BlockWeights, fused_attention_block
from hig_tpu_torch.ops.pallas_attention import (
    MASK_BIAS,
    efficient_attention,
    fused_efficient_attention,
    fused_projected_attention,
    merged_qkv,
    needs_grad,
    recompute_grads,
    split_heads,
)

__all__ = [
    "EfficientCrossAttention",
    "EfficientInteractionAttention",
    "EfficientSelfAttention",
    "FFN",
    "QuadraticCrossAttention",
    "QuadraticInteractionAttention",
    "QuadraticSelfAttention",
    "causal_bias",
    "causal_efficient_attention",
    "efficient_attention",
    "merged_qkv",
    "quadratic_attention",
]


def _attend(query, key, value, num_heads: int, key_mask=None):
    """Bare efficient attention through kernel B3."""
    return fused_efficient_attention(query, key, value, num_heads, key_mask)


XLA_SCAN_BLOCK = 16  # the block of XLA:CPU's rewrite of a long cumulative sum


def _sequential_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    parts = [x.select(dim, 0)]
    for j in range(1, x.shape[dim]):
        parts.append(parts[-1] + x.select(dim, j))
    return torch.stack(parts, dim)


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum`` of a bfloat16 ``x`` over ``dim`` in XLA:CPU's order,
    each add rounded to bfloat16. JAX lowers the sum to a ``reduce_window``,
    which XLA rewrites past XLA_SCAN_BLOCK terms: the axis zero-padded to
    blocks of 16, a running sum within each block, the running sum of the
    block totals (the same rewrite again past 16 blocks) shifted by one
    block, and each block's prefix added once."""
    dim %= x.dim()
    n = x.shape[dim]
    if n <= XLA_SCAN_BLOCK:
        return _sequential_cumsum(x, dim)
    nb = -(-n // XLA_SCAN_BLOCK)
    if nb * XLA_SCAN_BLOCK > n:
        pad = list(x.shape)
        pad[dim] = nb * XLA_SCAN_BLOCK - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    inner = _sequential_cumsum(x.reshape(*x.shape[:dim], nb, XLA_SCAN_BLOCK,
                                         *x.shape[dim + 1:]), dim + 1)
    running = xla_cumsum(inner.select(dim + 1, XLA_SCAN_BLOCK - 1), dim)
    before = torch.cat([torch.zeros_like(running.narrow(dim, 0, 1)),
                        running.narrow(dim, 0, nb - 1)], dim)
    return (inner + before.unsqueeze(dim + 1)).reshape(x.shape).narrow(dim, 0, n)


def sequence_parallel_attention(query, key, value, num_heads: int, key_mask, group):
    """Efficient attention over a time axis split across ``group`` (a
    ``parallel.distributed.Group``): query, key, value (..., T/S, D) and
    key_mask (..., T/S) are this rank's rows. softmax_time(k)ᵀv =
    Σ exp(k − max)ᵀ v / Σ exp(k − max), the max, the sum and the moment each
    a partial reduction over the rank's rows and an all-reduce."""
    from hig_tpu_torch.parallel import distributed as dist

    D = query.shape[-1]
    m = key_mask[..., None]
    k = split_heads(key + (1.0 - m) * MASK_BIAS, num_heads)
    v = split_heads(value * m, num_heads)
    kmax = dist.all_reduce(k.amax(dim=-3, keepdim=True), group, "max")
    e = torch.exp(k - kmax)
    z = dist.all_reduce(e.sum(dim=-3), group)  # (..., h, d)
    state = dist.all_reduce(torch.einsum("...nhd,...nhl->...hdl", e, v), group)
    y = torch.einsum("...nhd,...hdl->...nhl", split_heads(query, num_heads).softmax(dim=-1),
                     state / z[..., None])
    return y.reshape(*y.shape[:-2], D)


def _causal_core(query, key, value, num_heads: int, key_mask=None):
    D, dt = query.shape[-1], query.dtype
    q = split_heads(query, num_heads)
    if key_mask is not None:
        m = key_mask[..., None].to(dt)
        key = key + (1.0 - m) * constant(MASK_BIAS, dt, key.device)
        value = value * m
    k = split_heads(key, num_heads)
    v = split_heads(value, num_heads)
    q = softmax(q, -1)
    k = torch.exp(k - k.amax(dim=-3, keepdim=True).detach())
    cumsum = xla_cumsum if reduced(dt) else torch.cumsum
    S = cumsum(k[..., :, None] * v[..., None, :], -4)  # (..., n, h, d, l)
    z = cumsum(k, -3)
    A = S / torch.maximum(z[..., None], constant(1e-30, dt, z.device))
    y = torch.einsum("...nhd,...nhdl->...nhl", q, A)
    return y.reshape(*y.shape[:-2], D)


class CausalCore(torch.autograd.Function):
    """The causal core under autograd: the forward saves its inputs only,
    and the backward recomputes the core and differentiates it, so the
    running (..., T, H, 64, 64) state lives one block at a time."""

    @staticmethod
    def forward(ctx, query, key, value, key_mask, num_heads):
        ctx.save_for_backward(query, key, value, key_mask)
        ctx.num_heads = num_heads
        return _causal_core(query, key, value, num_heads, key_mask)

    @staticmethod
    def backward(ctx, grad_out):
        *operands, mask = ctx.saved_tensors

        def plain(q, k, v):
            return _causal_core(q, k, v, ctx.num_heads, mask)

        return (*recompute_grads(plain, operands, ctx.needs_input_grad[:3], grad_out),
                None, None)


def causal_efficient_attention(query, key, value, num_heads: int, key_mask=None):
    """Causal linear attention (JAX ``causal_efficient_attention``): query
    (..., T, D), key/value (..., T, D), key_mask (..., T) 0/1.
    y_i = softmax_feat(q_i) · Σ_{j≤i} exp(k_j) ⊗ v_j / Σ_{j≤i} exp(k_j),
    with exp(k − max over time) (no gradient through the max), a −1e6 bias
    on masked keys and masked values zeroed, the running state
    S = cumsum(k ⊗ v) and z = cumsum(k), and S / max(z, 1e-30). Plain
    PyTorch in the input dtype; bfloat16 rounds after every op as XLA does,
    its cumulative sums in XLA:CPU's order (:func:`xla_cumsum`)."""
    if needs_grad(query, key, value):
        return CausalCore.apply(query, key, value, key_mask, num_heads)
    return _causal_core(query, key, value, num_heads, key_mask)


class _KernelBlock(nn.Module):
    """Parameters shared by the self-attention and interaction blocks:
    norm, query/key/value and the ``proj_out`` gate (flax names)."""

    interaction = False
    tp = None  # a parallel.mesh.TensorParallel (module doc)
    sp = None  # a parallel.distributed.Group: sequence parallelism (module doc)

    def __init__(self, latent_dim: int, num_heads: int, emb_dim: int,
                 fused: bool = False, dtype: torch.dtype = torch.float32,
                 fast_ln: bool = False, rms: bool = False, causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        self.causal = causal
        self.norm = make_norm(latent_dim, dtype, fast_ln, rms)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim, dtype, fast_ln, rms)

    def block_weights(self, dtype: torch.dtype | None = None) -> BlockWeights:
        """The block's parameters, cast to ``dtype`` when given (a cast of
        float32 master weights is a new tensor on each call)."""
        w = BlockWeights(
            self.norm.weight, self.norm.bias,
            self.query.weight, self.query.bias,
            self.key.weight, self.key.bias,
            self.value.weight, self.value.bias,
            self.proj_out.norm.weight, self.proj_out.norm.bias,
            self.proj_out.out.weight, self.proj_out.out.bias,
        )
        return w if dtype is None else BlockWeights(*(t.to(dtype) for t in w))

    def forward(self, x, emb, src_mask, adaln=None):
        """x (B, 2, T, D), emb (B, 2, E) and src_mask (B, 1|2, T); or, on a
        ``--single_transformer`` model's merged timeline (self-attention
        only), x (B, 2T, D), emb (B, E) and src_mask (B, 2T). emb is None
        when ``adaln`` = (scale, shift), each (B, 2, 1, D) or (B, 1, D), is
        given. The route follows the module doc's rule; under ``tp`` the
        block runs the rank's heads (B2's rectangular form, never B1)."""
        scale, shift = adaln if adaln is not None else self.proj_out.scale_shift(emb)
        mask = src_mask.expand(x.shape[:-1])
        tp = self.tp
        if self.fused and not self.training and not self.causal and tp is None \
                and self.sp is None:
            return fused_attention_block(x, mask, scale, shift, self.block_weights(x.dtype),
                                         self.num_heads, self.interaction)
        xn = self.norm(x)
        heads, biases = self.num_heads, (self.query.bias, self.key.bias, self.value.bias)
        if tp is not None:
            xn, heads, biases = tp.enter(xn), tp.heads(heads), tuple(map(tp.cols, biases))
        weights = (self.query.weight, biases[0], self.key.weight, biases[1],
                   self.value.weight, biases[2])
        if self.causal or self.sp is not None or (self.training and reduced(xn.dtype)):
            y = self._einsum_route(xn, mask, weights, heads)
        else:
            kv_src, kv_mask = xn, mask
            if self.interaction:
                # the shared LayerNorm normalizes both actors; k/v and the
                # key mask are the other actor's
                kv_src, kv_mask = xn.flip(-3), mask.flip(-2)
            y = fused_projected_attention(xn, kv_src, *weights, heads, key_mask=kv_mask)
        if tp is not None:
            y = tp.gather(y)
        return x + self.proj_out.from_scale_shift(y, scale, shift)

    def _einsum_route(self, xn, mask, weights, heads: int):
        """JAX's einsum route (``use_pallas=False``, or any causal block): one
        merged q|k|v product of ``weights`` (wq, bq, wk, bk, wv, bv), k, v
        and the key mask flipped on the actor axis for the interaction
        block, then the causal core or, in bfloat16 training, the core
        through B3-bf16 (contiguous copies, as the kernel reads (..., T, D)
        rows at stride D)."""
        q, k, v = merged_qkv(xn, *weights)
        if self.interaction:
            k, v, mask = k.flip(-3), v.flip(-3), mask.flip(-2)
        if self.sp is not None:
            return sequence_parallel_attention(q, k, v, heads, mask, self.sp)
        if self.causal:
            return causal_efficient_attention(q, k, v, heads, key_mask=mask)
        return fused_efficient_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         heads, key_mask=mask)


class EfficientSelfAttention(_KernelBlock):
    """Per-actor temporal self-attention."""


class EfficientInteractionAttention(_KernelBlock):
    """Cross-actor attention: each actor queries the other actor's timeline
    with one shared weight set and one shared LayerNorm (no text_norm)."""

    interaction = True


class EfficientCrossAttention(nn.Module):
    """Text cross-attention. The text tokens are constant across a sampling
    call, so :meth:`kv` computes the per-layer KᵀV state once and
    :meth:`from_kv` is the per-step body. Under ``tp`` the state and y are
    the rank's heads'."""

    tp = None  # a parallel.mesh.TensorParallel (module doc)

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 emb_dim: int, dtype: torch.dtype = torch.float32, fast_ln: bool = False,
                 rms: bool = False):
        super().__init__()
        self.latent_dim = latent_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm = make_norm(latent_dim, dtype, fast_ln, rms)
        self.text_norm = make_norm(text_latent_dim, dtype)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(text_latent_dim, latent_dim)
        self.value = nn.Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim, dtype, fast_ln, rms)

    def _heads(self) -> int:
        return self.num_heads if self.tp is None else self.tp.heads(self.num_heads)

    def _enter(self, x):
        return x if self.tp is None else self.tp.enter(x)

    def kv(self, xf: torch.Tensor) -> torch.Tensor:
        """(..., L, Dt) → (..., H, dh, dh) (H/S heads under ``tp``)."""
        xfn = self._enter(self.text_norm(xf))
        k = softmax(split_heads(column_dense(self.key, xfn, self.dtype, self.tp),
                                self._heads()), -3)
        v = split_heads(column_dense(self.value, xfn, self.dtype, self.tp), self._heads())
        return torch.einsum("...nhd,...nhl->...hdl", k, v)

    def from_kv(self, x, kv, emb, adaln=None):
        xn = self._enter(self.norm(x))
        q = softmax(split_heads(column_dense(self.query, xn, self.dtype, self.tp),
                                self._heads()), -1)
        y = torch.einsum("...nhd,...hdl->...nhl", q, kv)
        y = y.reshape(*y.shape[:-2], -1)
        if self.tp is not None:
            y = self.tp.gather(y)
        if adaln is not None:
            return x + self.proj_out.from_scale_shift(y, *adaln)
        return x + self.proj_out(y, emb)

    def forward(self, x, xf, emb, adaln=None):
        return self.from_kv(x, self.kv(xf), emb, adaln)


class QuadraticSelfAttention(nn.Module):
    """Per-actor temporal softmax attention (``--no_eff``).

    The reference adds the raw 0/1 mask to the logits, which masks nothing;
    like the JAX package, padded keys get the −1e6 bias instead.
    """

    tp = None  # a parallel.mesh.TensorParallel (module doc)

    def __init__(self, latent_dim: int, num_heads: int, emb_dim: int,
                 causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.norm = make_norm(latent_dim, dtype)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim, dtype)

    def forward(self, x, emb, src_mask, adaln=None):
        """x (B, 2, T, D); src_mask (B, 1|2, T); ``adaln`` as in the
        efficient blocks."""
        scale, shift = adaln if adaln is not None else self.proj_out.scale_shift(emb)
        xn, heads, tp = self.norm(x), self.num_heads, self.tp
        biases = (self.query.bias, self.key.bias, self.value.bias)
        if tp is not None:
            xn, heads, biases = tp.enter(xn), tp.heads(heads), tuple(map(tp.cols, biases))
        # one (D, 3D) product; B4 reads q, k and v from it in place
        q, k, v = merged_qkv(xn, self.query.weight, biases[0], self.key.weight, biases[1],
                             self.value.weight, biases[2])
        y = flash_attention(q, k, v, heads, key_mask=src_mask.expand(x.shape[:-1]),
                            causal=self.causal)
        if tp is not None:
            y = tp.gather(y)
        return x + self.proj_out.from_scale_shift(y, scale, shift)


class QuadraticCrossAttention(nn.Module):
    """Text softmax cross-attention, unmasked. The text K/V are constant
    across a sampling call: :meth:`kv` projects them once and :meth:`from_kv`
    is the per-step body."""

    tp = None  # a parallel.mesh.TensorParallel (module doc)

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 emb_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm = make_norm(latent_dim, dtype)
        self.text_norm = make_norm(text_latent_dim, dtype)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(text_latent_dim, latent_dim)
        self.value = nn.Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim, dtype)

    def kv(self, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., L, Dt) → (k, v), each (..., L, D) (the rank's D/S columns
        under ``tp``)."""
        xfn = self.text_norm(xf)
        xfn = xfn if self.tp is None else self.tp.enter(xfn)
        return (column_dense(self.key, xfn, self.dtype, self.tp),
                column_dense(self.value, xfn, self.dtype, self.tp))

    def from_kv(self, x, kv, emb, adaln=None):
        k, v = kv
        xn, heads = self.norm(x), self.num_heads
        if self.tp is not None:
            xn, heads = self.tp.enter(xn), self.tp.heads(heads)
        y = quadratic_attention(column_dense(self.query, xn, self.dtype, self.tp), k, v, heads)
        if self.tp is not None:
            y = self.tp.gather(y)
        if adaln is not None:
            return x + self.proj_out.from_scale_shift(y, *adaln)
        return x + self.proj_out(y, emb)

    def forward(self, x, xf, emb, adaln=None):
        return self.from_kv(x, self.kv(xf), emb, adaln)


class QuadraticInteractionAttention(nn.Module):
    """Cross-actor softmax attention: each actor queries the other actor's
    timeline. Unlike the efficient block, x is normalized with ``norm`` and
    the partner with its own ``text_norm``, and the key mask is the
    partner's."""

    tp = None  # a parallel.mesh.TensorParallel (module doc)

    def __init__(self, latent_dim: int, num_heads: int, emb_dim: int,
                 causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.dtype = dtype
        self.norm = make_norm(latent_dim, dtype)
        self.text_norm = make_norm(latent_dim, dtype)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim, dtype)

    def forward(self, x, emb, src_mask, adaln=None):
        """x (B, 2, T, D); src_mask (B, 1|2, T), each actor's own mask."""
        scale, shift = adaln if adaln is not None else self.proj_out.scale_shift(emb)
        xn, xt, heads, tp = self.norm(x), self.text_norm(x), self.num_heads, self.tp
        bk, bv = self.key.bias, self.value.bias
        if tp is not None:
            xn, xt, heads = tp.enter(xn), tp.enter(xt), tp.heads(heads)
            bk, bv = tp.cols(bk), tp.cols(bv)
        q = column_dense(self.query, xn, self.dtype, tp)
        # LayerNorm and the projections act per token, so k and v are
        # projected from the unflipped x in one (D, 2D) product and B4 reads
        # the partner's rows (partner=True) instead of a flipped copy.
        w = torch.cat([self.key.weight, self.value.weight])
        k, v = linear(xt, w, torch.cat([bk, bv])).chunk(2, dim=-1)
        y = flash_attention(q, k, v, heads, key_mask=src_mask.expand(x.shape[:-1]),
                            causal=self.causal, partner=True)
        if tp is not None:
            y = tp.gather(y)
        return x + self.proj_out.from_scale_shift(y, scale, shift)


class FFN(nn.Module):
    """Exact-GELU MLP + stylization gate; under ``tp`` linear1 column- and
    linear2 row-parallel (module doc)."""

    tp = None  # a parallel.mesh.TensorParallel

    def __init__(self, latent_dim: int, ffn_dim: int, emb_dim: int,
                 dtype: torch.dtype = torch.float32, fast_ln: bool = False, rms: bool = False):
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim, dtype, fast_ln, rms)

    def forward(self, x, emb, adaln=None):
        xin = x if self.tp is None else self.tp.enter(x)
        h = row_dense(self.linear2, gelu(column_dense(self.linear1, xin, self.dtype, self.tp)),
                      self.dtype, self.tp)
        if adaln is not None:
            return x + self.proj_out.from_scale_shift(h, *adaln)
        return x + self.proj_out(h, emb)
