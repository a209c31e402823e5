"""Efficient (linear) attention blocks of the interaction denoiser
(counterpart of ``hig_tpu/models/attention.py``).

softmax(Q over features) · [softmax(K over time)ᵀ V], with the residual and
the AdaLN ``StylizationBlock`` gate applied inside each block. Every leading
axis before (T, D) is batch, so the (B, actors, T, D) layout flows through.

The self-attention and interaction blocks always go through a kernel
wrapper: B1 (``ops/fused_block.py``, the whole block) when ``fused``, else
B2 (``ops/pallas_attention.py``, projections + attention core) between a
plain LayerNorm and the plain gate. On CPU tensors each wrapper runs its
plain version. The text cross-attention and the FFN are plain PyTorch on
every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hig_tpu_torch.models.embeddings import StylizationBlock, layer_norm
from hig_tpu_torch.ops.fused_block import BlockWeights, fused_attention_block
from hig_tpu_torch.ops.pallas_attention import (
    split_heads,
    efficient_attention,
    fused_projected_attention,
    merged_qkv,
)

__all__ = [
    "EfficientCrossAttention",
    "EfficientInteractionAttention",
    "EfficientSelfAttention",
    "FFN",
    "efficient_attention",
    "merged_qkv",
]


class _KernelBlock(nn.Module):
    """Parameters shared by the self-attention and interaction blocks:
    norm, query/key/value and the ``proj_out`` gate (flax names)."""

    interaction = False

    def __init__(self, latent_dim: int, num_heads: int, emb_dim: int,
                 fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        self.norm = layer_norm(latent_dim)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim)

    def block_weights(self) -> BlockWeights:
        return BlockWeights(
            self.norm.weight, self.norm.bias,
            self.query.weight, self.query.bias,
            self.key.weight, self.key.bias,
            self.value.weight, self.value.bias,
            self.proj_out.norm.weight, self.proj_out.norm.bias,
            self.proj_out.out.weight, self.proj_out.out.bias,
        )

    def forward(self, x, emb, src_mask, adaln=None):
        """x (B, 2, T, D); emb (B, 2, E) or None when ``adaln`` = (scale,
        shift), each (B, 2, 1, D), is given; src_mask (B, 1|2, T)."""
        scale, shift = adaln if adaln is not None else self.proj_out.scale_shift(emb)
        mask = src_mask.expand(x.shape[:-1])
        if self.fused:
            return fused_attention_block(x, mask, scale, shift, self.block_weights(),
                                         self.num_heads, self.interaction)
        xn = self.norm(x)
        kv_src, kv_mask = xn, mask
        if self.interaction:
            # the shared LayerNorm normalizes both actors; k/v and the key
            # mask are the other actor's
            kv_src, kv_mask = xn.flip(-3), mask.flip(-2)
        y = fused_projected_attention(
            xn, kv_src, self.query.weight, self.query.bias, self.key.weight,
            self.key.bias, self.value.weight, self.value.bias, self.num_heads,
            key_mask=kv_mask,
        )
        return x + self.proj_out.from_scale_shift(y, scale, shift)


class EfficientSelfAttention(_KernelBlock):
    """Per-actor temporal self-attention."""


class EfficientInteractionAttention(_KernelBlock):
    """Cross-actor attention: each actor queries the other actor's timeline
    with one shared weight set and one shared LayerNorm (no text_norm)."""

    interaction = True


class EfficientCrossAttention(nn.Module):
    """Text cross-attention. The text tokens are constant across a sampling
    call, so :meth:`kv` computes the per-layer KᵀV state once and
    :meth:`from_kv` is the per-step body."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 emb_dim: int):
        super().__init__()
        self.latent_dim = latent_dim
        self.num_heads = num_heads
        self.norm = layer_norm(latent_dim)
        self.text_norm = layer_norm(text_latent_dim)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(text_latent_dim, latent_dim)
        self.value = nn.Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim)

    def kv(self, xf: torch.Tensor) -> torch.Tensor:
        """(..., L, Dt) → (..., H, dh, dh)."""
        xfn = self.text_norm(xf)
        k = split_heads(self.key(xfn), self.num_heads).softmax(dim=-3)
        v = split_heads(self.value(xfn), self.num_heads)
        return torch.einsum("...nhd,...nhl->...hdl", k, v)

    def from_kv(self, x, kv, emb, adaln=None):
        q = split_heads(self.query(self.norm(x)), self.num_heads).softmax(dim=-1)
        y = torch.einsum("...nhd,...hdl->...nhl", q, kv)
        y = y.reshape(*y.shape[:-2], self.latent_dim)
        if adaln is not None:
            return x + self.proj_out.from_scale_shift(y, *adaln)
        return x + self.proj_out(y, emb)

    def forward(self, x, xf, emb, adaln=None):
        return self.from_kv(x, self.kv(xf), emb, adaln)


class FFN(nn.Module):
    """Exact-GELU MLP + stylization gate."""

    def __init__(self, latent_dim: int, ffn_dim: int, emb_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, emb_dim)

    def forward(self, x, emb, adaln=None):
        h = self.linear2(F.gelu(self.linear1(x)))
        if adaln is not None:
            return x + self.proj_out.from_scale_shift(h, *adaln)
        return x + self.proj_out(h, emb)
