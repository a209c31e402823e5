"""The evaluator models: the 26-way interaction classifier and the
mutual-consistency model (counterpart of ``hig_tpu/models/eval_models.py``).

Both take the (B, 2, T, D) actor-explicit layout (foot contacts dropped, so
D = 259) and run post-LN encoder layers over the two actors' concatenated
2T tokens with a key mask of each actor's valid frames; no Pallas kernel
runs in them in JAX, and they are plain PyTorch here on every device.

* :class:`MotionEncoder`: the zero-initialised (in JAX) ``out2`` / ``out1``
  project the init token / the frames, a masked mean pool gives the 512-d
  embedding of FID, Diversity and MultiModality, and ``fin_proj`` the class
  logits.
* :class:`MotionConsistencyEvalModel`: a learned CLS token in front of the
  2T tokens; ``cls_output`` of its final state gives the genuine (0) /
  mismatched (1) pair logits.

LayerNorms use flax's eps of 1e-6 and the FFNs exact GELU.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hig_tpu_torch.models.embeddings import length_mask
from hig_tpu_torch.models.text_encoder import PostLNEncoderLayer

KINDS = ("classifier", "consistency")


@dataclasses.dataclass(frozen=True)
class EvalModelConfig:
    """Hyper-parameters of an evaluator model (the JAX defaults). ``kind``
    "classifier" is the :class:`MotionEncoder` (26 classes), "consistency"
    the :class:`MotionConsistencyEvalModel` (2 classes)."""

    kind: str = "classifier"
    input_feats: int = 259
    num_frames: int = 196
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 8
    class_num: int = 26

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")


class PairEmbedding(nn.Module):
    """The init token through a 4-channel head, the frames through a
    D-channel head plus the positional table."""

    def __init__(self, input_feats: int, latent_dim: int, num_frames: int):
        super().__init__()
        self.sequence_embedding = nn.Parameter(torch.randn(num_frames, latent_dim))
        self.joint_embed1 = nn.Linear(input_feats, latent_dim)
        self.joint_embed2 = nn.Linear(4, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[2]
        move = self.joint_embed1(x[:, :, 1:]) + self.sequence_embedding[: T - 1]
        init = self.joint_embed2(x[:, :, 0, :4])
        return torch.cat([init[:, :, None, :], move], dim=2)


def _encoder_layers(cfg: EvalModelConfig) -> nn.ModuleList:
    return nn.ModuleList(PostLNEncoderLayer(cfg.latent_dim, cfg.num_heads, cfg.ff_size)
                         for _ in range(cfg.num_layers))


class MotionEncoder(nn.Module):
    """(B, 2, T, D) motions, (B,) lengths → (logits (B, class_num), pooled
    embedding (B, latent_dim))."""

    def __init__(self, cfg: EvalModelConfig = EvalModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.embed = PairEmbedding(cfg.input_feats, cfg.latent_dim, cfg.num_frames)
        self.blocks = _encoder_layers(cfg)
        self.out1 = nn.Linear(cfg.latent_dim, cfg.latent_dim)
        self.out2 = nn.Linear(cfg.latent_dim, cfg.latent_dim)
        self.fin_proj = nn.Linear(cfg.latent_dim, cfg.class_num)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B, A, T, _ = x.shape
        D = self.cfg.latent_dim
        tokens = self.embed(x).reshape(B, A * T, D)
        mask = length_mask(lengths, T, x.dtype)
        mask2 = torch.cat([mask, mask], dim=-1)  # (B, 2T)
        for block in self.blocks:
            tokens = block(tokens, key_mask=mask2)
        h = tokens.reshape(B, A, T, D)
        proj = torch.cat([self.out2(h[:, :, :1]), self.out1(h[:, :, 1:])], dim=2)
        w = mask2[..., None]
        pooled = (proj.reshape(B, A * T, D) * w).sum(dim=1) / w.sum(dim=1)
        return self.fin_proj(pooled), pooled


class MotionConsistencyEvalModel(nn.Module):
    """(B, 2, T, D) motions, (B,) lengths → (B, class_num) logits; class 0
    is a genuine pair."""

    def __init__(self, cfg: EvalModelConfig = EvalModelConfig(kind="consistency",
                                                              class_num=2)):
        super().__init__()
        self.cfg = cfg
        self.embed = PairEmbedding(cfg.input_feats, cfg.latent_dim, cfg.num_frames)
        self.cls_input = nn.Parameter(torch.randn(1, 1, cfg.latent_dim))
        self.blocks = _encoder_layers(cfg)
        self.cls_output = nn.Linear(cfg.latent_dim, cfg.class_num)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        B, A, T, _ = x.shape
        D = self.cfg.latent_dim
        tokens = torch.cat([self.cls_input.expand(B, 1, D),
                            self.embed(x).reshape(B, A * T, D)], dim=1)
        mask = length_mask(lengths, T, x.dtype)
        key_mask = torch.cat([torch.ones_like(mask[:, :1]), mask, mask], dim=-1)
        for block in self.blocks:
            tokens = block(tokens, key_mask=key_mask)
        return self.cls_output(tokens[:, 0])


def eval_model(cfg: EvalModelConfig) -> nn.Module:
    """The evaluator model of ``cfg.kind``."""
    return MotionEncoder(cfg) if cfg.kind == "classifier" else MotionConsistencyEvalModel(cfg)
