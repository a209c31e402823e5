"""Text conditioning stack + interaction denoiser under one parameter tree
(counterpart of ``hig_tpu/models/interaction_model.py:25-189,261-291``).

The port serves and trains the caption-token conditioning path in float32,
with the efficient (linear) denoiser or, with ``efficient=False``, the
quadratic (``--no_eff``) one, optionally ``causal``. Training feeds the
learnable text suffix precomputed features of the frozen CLIP tower
(:meth:`InteractionModel.clip_tower`, :meth:`~InteractionModel.encode_text_from_tower`).
Caption-id conditioning, classifier-free guidance, dropout, bf16 compute,
``fast_ln``, RMSNorm, causal efficient attention and the single-transformer
variant are not ported yet: :class:`ModelConfig` refuses the ones it has
fields for.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hig_tpu_torch.models.denoiser import InteractionDenoiser, check_block_options
from hig_tpu_torch.models.text_encoder import ClipTextConfig, TextEncoder


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyper-parameters of the interaction model; defaults are the flagship
    (the JAX ``InteractionModel`` defaults and ``bench.py``'s model)."""

    input_feats: int = 263
    num_frames: int = 196
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 8
    text_latent_dim: int = 256
    text_ff_size: int = 2048
    text_num_heads: int = 4
    num_text_layers: int = 4
    clip: ClipTextConfig = ClipTextConfig()
    fused_blocks: bool = False
    efficient: bool = True
    causal: bool = False
    # not ported yet: must stay at these values
    compute_dtype: str = "float32"
    fast_ln: bool = False
    rms_norm: bool = False
    dropout: float = 0.0

    def __post_init__(self):
        if isinstance(self.clip, dict):
            object.__setattr__(self, "clip", ClipTextConfig(**self.clip))
        if self.compute_dtype != "float32" or self.fast_ln or self.rms_norm:
            raise ValueError(
                "hig_tpu_torch serves float32 LayerNorm models only: bf16 "
                "compute, fast_ln and RMSNorm are not ported yet"
            )
        if self.dropout > 0.0:
            raise ValueError(f"dropout > 0 is not ported yet (got {self.dropout}); "
                             "the JAX default, 0.0, is")
        check_block_options(self.efficient, self.causal, self.fused_blocks)

    @property
    def time_embed_dim(self) -> int:
        return 4 * self.latent_dim


class InteractionModel(nn.Module):
    """Two-actor denoiser + its text conditioning stack."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.text = TextEncoder(
            clip_config=cfg.clip,
            text_latent_dim=cfg.text_latent_dim,
            text_ff_size=cfg.text_ff_size,
            text_num_heads=cfg.text_num_heads,
            num_text_layers=cfg.num_text_layers,
            time_embed_dim=cfg.time_embed_dim,
        )
        self.denoiser = InteractionDenoiser(
            input_feats=cfg.input_feats,
            num_frames=cfg.num_frames,
            latent_dim=cfg.latent_dim,
            ff_size=cfg.ff_size,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
            text_latent_dim=cfg.text_latent_dim,
            fused_blocks=cfg.fused_blocks,
            efficient=cfg.efficient,
            causal=cfg.causal,
        )

    def encode_text(self, tokens: torch.Tensor):
        """(B, 2, 77) tokens → ((B, 2, E), (B, 2, L, Dt))."""
        B, A = tokens.shape[:2]
        xf_proj, xf_out = self.text(tokens.reshape(B * A, -1).long())
        return xf_proj.reshape(B, A, -1), xf_out.reshape(B, A, *xf_out.shape[1:])

    def clip_tower(self, tokens: torch.Tensor) -> torch.Tensor:
        """(N, 77) tokens → CLIP tower features (N, 77, width); with a
        frozen tower they are computed once and gathered per batch."""
        return self.text.tower(tokens.long())

    def encode_text_from_tower(self, tower_out: torch.Tensor, tokens: torch.Tensor):
        """(B, 2, 77, W) tower features + (B, 2, 77) tokens → ((B, 2, E),
        (B, 2, L, Dt)): the learnable suffix alone."""
        B, A = tokens.shape[:2]
        xf_proj, xf_out = self.text.from_tower(tower_out.reshape(B * A, *tower_out.shape[2:]),
                                               tokens.reshape(B * A, -1).long())
        return xf_proj.reshape(B, A, -1), xf_out.reshape(B, A, *xf_out.shape[1:])

    def clip_parameters(self) -> set[str]:
        """Names of the CLIP tower's parameters (the frozen partition)."""
        return {f"text.clip.{name}" for name, _ in self.text.clip.named_parameters()}

    def freeze_clip(self) -> None:
        """Mark the CLIP tower frozen: its parameters take no gradient."""
        self.text.clip.requires_grad_(False)

    def text_kv(self, xf_out: torch.Tensor) -> tuple:
        return self.denoiser.text_kv(xf_out)

    def denoise(self, x, timesteps, lengths, xf_proj, xf_out=None, text_kv=None,
                adaln=None):
        return self.denoiser(x, timesteps, lengths, xf_proj, xf_out,
                             text_kv=text_kv, adaln=adaln)

    def forward(self, x, timesteps, lengths, tokens):
        xf_proj, xf_out = self.encode_text(tokens)
        return self.denoise(x, timesteps, lengths, xf_proj, xf_out)
