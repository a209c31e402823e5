"""Conditioning blocks shared by the denoiser (counterpart of
``hig_tpu/models/embeddings.py``): the cos-first sinusoidal timestep
embedding, its SiLU MLP, the AdaLN ``StylizationBlock`` gate and the length
mask. LayerNorms use flax's eps of 1e-6, not torch's 1e-5.

Compute dtype. Every module takes the model's compute dtype (float32 or
bfloat16), as the flax modules take ``dtype``. In float32 the modules run
torch's own layers, unchanged. In bfloat16 they round where flax and
``jax.nn`` round, one op at a time, as XLA computes them:

- :func:`dense` is flax's ``Dense``: input, weight and bias cast to the
  dtype, the product rounded to it (float32 accumulation), then the bias
  added in the dtype, a second rounding (``F.linear`` with a bias may round
  once);
- :func:`silu`, :func:`softmax` and :func:`gelu` follow the op chains of
  ``jax.nn.silu`` (x · 1/(1 + exp(−x))), ``jax.nn.softmax`` (exp(x − max),
  a float32 sum rounded to the dtype, a division) and exact
  ``jax.nn.gelu`` (0.5x · erfc(−x · bf16(√½))), each op rounded;
- :class:`Norm` is flax's ``LayerNorm`` / ``RMSNorm``
  (``flax/linen/normalization.py``, ``_compute_stats`` and ``_normalize``):
  by default the statistics are float32, with flax's fast variance
  max(0, E[x²] − E[x]²), and (x − mean)·(rsqrt(var + eps)·scale) + bias is
  taken in float32 and cast to the dtype; under ``fast_ln`` x², the means,
  the variance and rsqrt(var + eps) are each rounded to the dtype, and the
  float32 scale and bias are applied before the cast. RMSNorm has no mean
  and no bias.

A Python constant in a JAX expression is cast to the dtype before the op
(a weak type), where torch keeps it in float32 inside the op: constants
that bfloat16 does not hold exactly (CLIP's 1.702, the norms' eps) are made
bfloat16 tensors first.

Gradients in bfloat16. Torch's autograd rounds a bfloat16 op chain's
backward at its own points. Where the port needs XLA's (the bfloat16
backwards of the attention kernels), :func:`softmax_vjp` writes out XLA's
VJP of the softmax op chain, with
:func:`~hig_tpu_torch.ops.bf16_sum.bf16_sum`, a sum of bfloat16 values
rounded after every add in the order XLA's CPU backend takes it (a kernel on
the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hig_tpu_torch.ops.bf16_sum import bf16_sum

LN_EPS = 1e-6


def constant(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` as a 0-d ``dtype`` tensor (rounded to the dtype first, as
    JAX's weak type is), made on ``device`` by a fill: a CUDA graph
    captures that, where ``torch.tensor(value, device=...)`` is a copy from
    the host, which a capture refuses."""
    return torch.full((), value, dtype=dtype, device=device)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class Norm(nn.Module):
    """flax's ``LayerNorm`` (or, with ``rms``, ``RMSNorm``) in ``dtype``;
    see the module doc. ``weight`` is flax's ``scale``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, fast_ln: bool = False,
                 rms: bool = False):
        super().__init__()
        self.dtype, self.fast_ln, self.rms = dtype, fast_ln, rms
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if rms else nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fast_ln:
            xs = x.to(self.dtype)

            def mean(t):  # jnp.mean: a float32 sum, rounded to the dtype
                return t.float().mean(-1, keepdim=True).to(self.dtype)

            var = mean(xs * xs)
            mu = torch.zeros_like(var)
            if not self.rms:
                mu = mean(xs)
                var = torch.clamp(var - mu * mu, min=0.0)
            # torch's bfloat16 rsqrt is an approximation: round the float32 one
            eps = constant(LN_EPS, self.dtype, x.device)  # JAX's weak type
            mul = torch.rsqrt((var + eps).float()).to(self.dtype)
        else:
            xs = x.float()
            var = (xs * xs).mean(-1, keepdim=True)
            mu = torch.zeros_like(var)
            if not self.rms:
                mu = xs.mean(-1, keepdim=True)
                var = torch.clamp(var - mu * mu, min=0.0)
            mul = torch.rsqrt(var + LN_EPS)
        y = (x - mu).float() * (mul.float() * self.weight.float())
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)


def make_norm(dim: int, dtype: torch.dtype = torch.float32, fast_ln: bool = False,
              rms: bool = False) -> nn.Module:
    """The norm of ``make_layer_norm``: torch's LayerNorm for a float32
    LayerNorm, else :class:`Norm` (``fast_ln`` only matters below float32)."""
    if dtype == torch.float32 and not rms:
        return layer_norm(dim)
    return Norm(dim, dtype, fast_ln and dtype != torch.float32, rms)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in the compute dtype; the float32 path casts nothing (it also
    carries the float64 reference models of the gradient checks)."""
    return t if dtype == torch.float32 else t.to(dtype)


def reduced(dtype: torch.dtype) -> bool:
    """bfloat16: the op chains round one op at a time, as XLA does."""
    return dtype == torch.bfloat16


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x·wᵀ + b in x's dtype (torch Linear layout); below float32 flax's
    Dense: the product rounded to the dtype, then the bias added in it."""
    if not reduced(x.dtype):
        return F.linear(x, w, b)
    return F.linear(x, w.to(x.dtype)) + b.to(x.dtype)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype = torch.float32):
    """flax ``Dense(dtype=dtype)`` with ``layer``'s parameters."""
    if dtype == torch.float32:
        return layer(x)
    return linear(x.to(dtype), layer.weight, layer.bias)


def column_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp=None):
    """:func:`dense` of a column-parallel layer: under ``tp`` (a
    ``parallel.mesh.TensorParallel``) the layer holds this rank's rows of
    the weight, and its whole bias, of which the rank adds its slice."""
    if tp is None:
        return dense(layer, x, dtype)
    return linear(x.to(dtype), layer.weight, tp.cols(layer.bias))


def row_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp=None):
    """:func:`dense` of a row-parallel layer: under ``tp`` the layer holds
    this rank's columns of the weight; the ranks' partial products are
    summed (an all-reduce), then the whole bias is added once."""
    if tp is None:
        return dense(layer, x, dtype)
    x = x.to(dtype)
    h = tp.reduce(F.linear(x, layer.weight.to(dtype)))
    return h + layer.bias.to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    if not reduced(x.dtype):
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    if not reduced(x.dtype):
        return x.softmax(dim=dim)
    return _ReducedSoftmax.apply(x, dim)


class _ReducedSoftmax(torch.autograd.Function):
    """``jax.nn.softmax``'s op chain in a reduced dtype: e = exp(x − max),
    y = e / (a float32 sum of e, rounded); its backward is XLA's VJP of that
    chain (:func:`softmax_vjp`), with no gradient through the max."""

    @staticmethod
    def forward(ctx, x, dim):
        e = torch.exp(x - x.amax(dim, keepdim=True))
        z = e.float().sum(dim, keepdim=True).to(x.dtype)
        ctx.save_for_backward(e, z)
        ctx.dim = dim
        return e / z

    @staticmethod
    def backward(ctx, dy):
        e, z = ctx.saved_tensors
        return softmax_vjp(dy.float(), e.float(), z.float(), ctx.dim).to(dy.dtype), None


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, as float32."""
    return t.to(torch.bfloat16).float()


def softmax_vjp(dy: torch.Tensor, e: torch.Tensor, z: torch.Tensor, dim: int) -> torch.Tensor:
    """The gradient of :func:`softmax` (y = e / z over ``dim``, e = exp(x −
    max) with no gradient through the max, z = Σ e) in bfloat16, as XLA
    differentiates that op chain: dx = (dy / z − Σ (dy · z⁻²) · e) · e,
    with z⁻² = 1 / (z · z), every op rounded and the sum
    :func:`~hig_tpu_torch.ops.bf16_sum.bf16_sum`.
    All arguments float32 holding bfloat16 values (``z`` kept over ``dim``);
    returns the same."""
    r = round_bf16
    inv_z2 = r(1.0 / r(z * z))
    s = bf16_sum(r(r(dy * inv_z2) * e), dim)
    return r(r(r(dy / z) - s) * e)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU."""
    if not reduced(x.dtype):
        return F.gelu(x)
    sqrt_half = constant(math.sqrt(0.5), x.dtype, x.device)
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, cos first: (...,) → (..., dim) float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


class TimeEmbedMLP(nn.Module):
    """latent_dim sinusoid → Linear → SiLU → Linear (time_embed_dim); the
    sinusoid is float32 until the first Linear."""

    def __init__(self, latent_dim: int, time_embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_dim, self.dtype = latent_dim, dtype
        self.fc1 = nn.Linear(latent_dim, time_embed_dim)
        self.fc2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        h = timestep_embedding(timesteps, self.latent_dim)
        if self.dtype == torch.float32:
            h = h.to(self.fc1.weight.dtype)
        return dense(self.fc2, silu(dense(self.fc1, h, self.dtype)), self.dtype)


class StylizationBlock(nn.Module):
    """AdaLN gate: h ← out(SiLU(norm(h)·(1+scale)+shift)).

    :meth:`scale_shift` depends only on the conditioning, so a sampler with
    a known timestep grid evaluates it for every step up front and each step
    calls :meth:`from_scale_shift`.
    """

    def __init__(self, latent_dim: int, emb_dim: int, dtype: torch.dtype = torch.float32,
                 fast_ln: bool = False, rms: bool = False):
        super().__init__()
        self.dtype = dtype
        self.emb = nn.Linear(emb_dim, 2 * latent_dim)
        self.norm = make_norm(latent_dim, dtype, fast_ln, rms)
        self.out = nn.Linear(latent_dim, latent_dim)

    def scale_shift(self, emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """emb (..., E) → (scale, shift), each (..., 1, latent_dim)."""
        emb_out = dense(self.emb, silu(emb), self.dtype)[..., None, :]
        scale, shift = emb_out.chunk(2, dim=-1)
        return scale, shift

    def from_scale_shift(self, h, scale, shift):
        return dense(self.out, silu(self.norm(h) * (1 + scale) + shift), self.dtype)

    def forward(self, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return self.from_scale_shift(h, *self.scale_shift(emb))


def length_mask(lengths: torch.Tensor, T: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) valid lengths → (B, T) 0/1 mask."""
    return (torch.arange(T, device=lengths.device) < lengths[..., None]).to(dtype)
