"""Text conditioning stack: frozen CLIP text tower + learnable suffix
(counterpart of ``hig_tpu/models/text_encoder.py``).

  tokens → CLIP ViT-B/32 text transformer (pre-LN, QuickGELU, causal)
         → text_pre_proj (when the widths differ)
         → post-LN encoder layers (exact GELU, no mask)   → text_ln = xf_out
         → pooled at the EOT position (argmax token id) → text_proj = xf_proj

or, for a caption-id model, a learned caption table (:class:`ClassConditioner`).
This runs once per sampling call, outside the step loop, as plain PyTorch.
In bfloat16 (``dtype``) the tower and the suffix round where the flax
modules round (``embeddings.py``'s helpers); their LayerNorms keep float32
statistics, and ``fast_ln`` does not reach them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from hig_tpu_torch.models.embeddings import (
    cast,
    column_dense,
    constant,
    dense,
    gelu,
    make_norm,
    reduced,
    row_dense,
    softmax,
)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    """OpenAI CLIP ViT-B/32 text-tower hyperparameters."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    if not reduced(x.dtype):
        return x * torch.sigmoid(1.702 * x)
    # JAX casts the constant to the dtype first; jax.nn.sigmoid's op chain
    c = constant(1.702, x.dtype, x.device)
    return x * (1 / (1 + torch.exp(-(c * x))))


def _attention(x, in_proj: nn.Linear, out_proj: nn.Linear, heads: int, causal: bool,
               key_mask: torch.Tensor | None = None, dtype: torch.dtype = torch.float32):
    """Softmax self-attention in ``dtype``; ``key_mask`` (N, L), 1 = attend,
    0 = pad, gives padded keys a bias of −inf."""
    N, L, D = x.shape
    qkv = dense(in_proj, x, dtype)
    q, k, v = qkv.reshape(N, L, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    if dtype == torch.float32:
        logits = q @ k.transpose(-1, -2) / math.sqrt(D // heads)
    else:  # the scale is 1 / sqrt(head dim), each op in the dtype, as in JAX
        scale = 1.0 / torch.sqrt(constant(D // heads, dtype, x.device))
        logits = (q @ k.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask.bool()[:, None, None, :], float("-inf"))
    y = softmax(logits, -1) @ v  # (N, H, L, hd)
    return dense(out_proj, y.transpose(1, 2).reshape(N, L, D), dtype)


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal: bool = True):
        return _attention(x, self.in_proj, self.out_proj, self.heads, causal, dtype=self.dtype)


class ClipResidualBlock(nn.Module):
    """Pre-LN residual attention block with QuickGELU MLP."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = make_norm(width, dtype)
        self.attn = ClipAttention(width, heads, dtype)
        self.ln_2 = make_norm(width, dtype)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = quick_gelu(dense(self.mlp_fc, self.ln_2(x), self.dtype))
        return x + dense(self.mlp_proj, h, self.dtype)


class ClipTextTower(nn.Module):
    """Token ids (N, 77) → final-LN token features (N, 77, width)."""

    def __init__(self, config: ClipTextConfig = ClipTextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Parameter(0.02 * torch.randn(config.vocab_size, config.width))
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(config.context_length, config.width)
        )
        self.blocks = nn.ModuleList(
            ClipResidualBlock(config.width, config.heads, dtype) for _ in range(config.layers)
        )
        self.ln_final = make_norm(config.width, dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = (cast(self.token_embedding[tokens.long()], self.dtype)
             + cast(self.positional_embedding, self.dtype))
        for block in self.blocks:
            x = block(x)
        return self.ln_final(x)


class PostLNEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer (norm_first=False, gelu) equivalent,
    with flax's LayerNorm eps. The text suffix calls it unmasked; the
    evaluator models pass ``key_mask`` (N, L), 1 = attend, 0 = pad."""

    tp = None  # a parallel.mesh.TensorParallel: linear1 column-, linear2 row-parallel

    def __init__(self, d_model: int, heads: int, ff_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.norm1 = make_norm(d_model, dtype)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm2 = make_norm(d_model, dtype)

    def forward(self, x, key_mask=None):
        x = self.norm1(x + _attention(x, self.in_proj, self.out_proj, self.heads, False,
                                      key_mask, self.dtype))
        xin = x if self.tp is None else self.tp.enter(x)
        h = row_dense(self.linear2, gelu(column_dense(self.linear1, xin, self.dtype, self.tp)),
                      self.dtype, self.tp)
        return self.norm2(x + h)


class TextEncoder(nn.Module):
    """tokens → (xf_proj (N, time_embed_dim), xf_out (N, 77, text_latent_dim))."""

    def __init__(self, clip_config: ClipTextConfig = ClipTextConfig(),
                 text_latent_dim: int = 256, text_ff_size: int = 2048,
                 text_num_heads: int = 4, num_text_layers: int = 4,
                 time_embed_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.clip = ClipTextTower(clip_config, dtype)
        self.text_pre_proj = (
            nn.Linear(clip_config.width, text_latent_dim)
            if text_latent_dim != clip_config.width else None
        )
        self.text_blocks = nn.ModuleList(
            PostLNEncoderLayer(text_latent_dim, text_num_heads, text_ff_size, dtype)
            for _ in range(num_text_layers)
        )
        self.text_ln = make_norm(text_latent_dim, dtype)
        self.text_proj = nn.Linear(text_latent_dim, time_embed_dim)

    def tower(self, tokens: torch.Tensor) -> torch.Tensor:
        """Frozen CLIP features (N, 77, width). No gradient flows into the
        tower, as the JAX tower's ``stop_gradient`` has it, so the tower does
        not train, even under ``--no_clip``."""
        with torch.no_grad():
            return self.clip(tokens)

    def from_tower(self, tower_out: torch.Tensor, tokens: torch.Tensor):
        """Learnable suffix: tower features + tokens → (xf_proj, xf_out)."""
        x = tower_out
        if self.text_pre_proj is not None:
            x = dense(self.text_pre_proj, tower_out, self.dtype)
        for block in self.text_blocks:
            x = block(x)
        xf_out = self.text_ln(x)
        eot = tokens.argmax(dim=-1)
        pooled = xf_out[torch.arange(xf_out.shape[0], device=xf_out.device), eot]
        return dense(self.text_proj, pooled, self.dtype), xf_out

    def forward(self, tokens: torch.Tensor):
        return self.from_tower(self.tower(tokens), tokens)


class ClassConditioner(nn.Module):
    """Caption-id conditioning (``cap_id``, the reference's PIT
    configuration): a learned (num_captions, text_latent_dim) caption table;
    xf_out is the table row as a one-token sequence, xf_proj its
    ``text_proj``."""

    def __init__(self, num_captions: int = 43, text_latent_dim: int = 256,
                 time_embed_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cap_embedding = nn.Parameter(torch.randn(num_captions, text_latent_dim))
        self.text_proj = nn.Linear(text_latent_dim, time_embed_dim)

    def forward(self, cap_ids: torch.Tensor):
        """(N,) caption ids → (xf_proj (N, time_embed_dim), xf_out (N, 1, Dt))."""
        emb = cast(self.cap_embedding[cap_ids.long()], self.dtype)
        return dense(self.text_proj, emb, self.dtype), emb[:, None, :]
