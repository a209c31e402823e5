"""Text conditioning stack + interaction denoiser under one parameter tree
(counterpart of ``hig_tpu/models/interaction_model.py``), and the
single-person model (:class:`SingleMotionModel`, the text stack and
``MotionDenoiser``: the paper's baseline and ``--pretrained`` donor).

The port trains, labels, serves and evaluates in float32 or bfloat16
(``compute_dtype``, with flax's ``fast_ln`` LayerNorm statistics or
``rms_norm`` blocks), with the efficient (linear) denoiser or, with
``efficient=False``, the quadratic (``--no_eff``) one, optionally
``causal``. Text conditioning comes in the JAX package's flavors: caption
tokens through the frozen CLIP tower and the learnable suffix, precomputed
tower features through the suffix alone (training's fast path,
:meth:`InteractionModel.clip_tower`,
:meth:`~InteractionModel.encode_text_from_tower`), or caption ids through a
learned table (``cap_id``, the PIT stage's model). With ``cond_drop_prob``
> 0 the model owns the learned null conditioning of classifier-free
guidance (:meth:`InteractionModel.null_conditioning`). ``dropout`` is
accepted and applies no dropout, as every JAX path computes (the field's
comment). The paper's ablations are ``interaction=False``
(``--no_cross_attn``) and ``single_transformer`` (both actors on one
timeline). A ``causal`` efficient model runs the causal core in plain
PyTorch, as JAX runs it outside its kernels. A bfloat16 model is
built with float32 parameters, which training and labeling keep (mixed
precision: each module casts per op); ``weights.cast_floating`` casts them
once for sampling, as the JAX sampler does (``make_sampler`` calls it).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hig_tpu_torch.models.denoiser import (
    InteractionDenoiser,
    MotionDenoiser,
    check_block_options,
)
from hig_tpu_torch.models.embeddings import cast
from hig_tpu_torch.models.text_encoder import ClassConditioner, ClipTextConfig, TextEncoder

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    cap_id: bool = False
    num_captions: int = 43
    # > 0: the model owns the learned null conditioning of classifier-free
    # guidance, and the supervised loss drops captions with this probability
    cond_drop_prob: float = 0.0
    # "float32" or "bfloat16"; fast_ln keeps the efficient blocks' norm
    # statistics in the compute dtype; rms_norm swaps their LayerNorms for
    # RMSNorms (efficient, unfused blocks only)
    compute_dtype: str = "float32"
    fast_ln: bool = False
    rms_norm: bool = False
    # accepted and not applied: JAX runs every path with deterministic=True
    # (hig_tpu/train/trainer.py:224,231,236,240,511,518,
    # hig_tpu/train/labeling.py:53), where nn.Dropout is the identity
    # (hig_tpu/models/attention.py:572): any dropout computes what 0 does
    dropout: float = 0.0
    # the paper's ablations: no interaction block (--no_cross_attn), and both
    # actors on one 2T-token timeline (--single_transformer)
    interaction: bool = True
    single_transformer: bool = False

    def __post_init__(self):
        if isinstance(self.clip, dict):
            object.__setattr__(self, "clip", ClipTextConfig(**self.clip))
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                             f"got {self.compute_dtype!r}")
        check_block_options(self.efficient, self.causal, self.fused_blocks, self.rms_norm,
                            self.single_transformer)

    @property
    def time_embed_dim(self) -> int:
        return 4 * self.latent_dim

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return COMPUTE_DTYPES[self.compute_dtype]


class InteractionModel(nn.Module):
    """Two-actor denoiser + its text conditioning stack."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        if cfg.cap_id:
            self.text = ClassConditioner(cfg.num_captions, cfg.text_latent_dim,
                                         cfg.time_embed_dim, cfg.dtype)
        else:
            self.text = TextEncoder(
                clip_config=cfg.clip,
                text_latent_dim=cfg.text_latent_dim,
                text_ff_size=cfg.text_ff_size,
                text_num_heads=cfg.text_num_heads,
                num_text_layers=cfg.num_text_layers,
                time_embed_dim=cfg.time_embed_dim,
                dtype=cfg.dtype,
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
            dtype=cfg.dtype,
            fast_ln=cfg.fast_ln,
            rms_norm=cfg.rms_norm,
            interaction=cfg.interaction,
            single_transformer=cfg.single_transformer,
        )
        if cfg.cond_drop_prob > 0.0:
            self.null_xf_proj = nn.Parameter(torch.zeros(cfg.time_embed_dim))
            self.null_xf_token = nn.Parameter(torch.zeros(cfg.text_latent_dim))

    def encode_text(self, cond: torch.Tensor):
        """(B, 2, 77) tokens or, for a ``cap_id`` model, (B, 2) caption ids
        → ((B, 2, E), (B, 2, L, Dt)); L is 77, or 1 for caption ids."""
        B, A = cond.shape[:2]
        xf_proj, xf_out = self.text(cond.reshape(B * A, *cond.shape[2:]).long())
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
        """Names of the CLIP tower's parameters (the frozen partition; empty
        for a ``cap_id`` model, which has no tower)."""
        if self.cfg.cap_id:
            return set()
        return {f"text.clip.{name}" for name, _ in self.text.clip.named_parameters()}

    def freeze_clip(self) -> None:
        """Mark the CLIP tower frozen: its parameters take no gradient."""
        if not self.cfg.cap_id:
            self.text.clip.requires_grad_(False)

    def null_conditioning(self, B: int, L: int = 1):
        """The learned unconditional ("null caption") state of classifier-free
        guidance: ((B, 2, E), (B, 2, L, Dt)), the two null parameters
        broadcast. Softmax attention over L identical text tokens is the one
        token's, so L is free. Exists only when ``cond_drop_prob`` > 0."""
        if self.cfg.cond_drop_prob <= 0.0:
            raise ValueError("the model has no null conditioning (cond_drop_prob is 0)")
        dt = self.cfg.dtype
        return (cast(self.null_xf_proj, dt).expand(B, 2, -1),
                cast(self.null_xf_token, dt).expand(B, 2, L, -1))

    def text_kv(self, xf_out: torch.Tensor) -> tuple:
        return self.denoiser.text_kv(xf_out)

    def denoise(self, x, timesteps, lengths, xf_proj, xf_out=None, text_kv=None,
                adaln=None):
        return self.denoiser(x, timesteps, lengths, xf_proj, xf_out,
                             text_kv=text_kv, adaln=adaln)

    def forward(self, x, timesteps, lengths, tokens):
        xf_proj, xf_out = self.encode_text(tokens)
        return self.denoise(x, timesteps, lengths, xf_proj, xf_out)


# The pair model's options that the single-person model has no use for
# (JAX's SingleMotionModel takes none of them), at the values it runs.
_PAIR_ONLY = {"fused_blocks": False, "causal": False, "cap_id": False, "cond_drop_prob": 0.0,
              "fast_ln": False, "rms_norm": False, "interaction": True,
              "single_transformer": False}


@dataclasses.dataclass(frozen=True)
class SingleModelConfig(ModelConfig):
    """Hyper-parameters of :class:`SingleMotionModel`: the widths, the CLIP
    tower, ``efficient``, ``compute_dtype`` and ``dropout`` of
    :class:`ModelConfig`; the pair model's other options must stay at their
    defaults."""

    def __post_init__(self):
        super().__post_init__()
        bad = sorted(k for k, v in _PAIR_ONLY.items() if getattr(self, k) != v)
        if bad:
            raise ValueError(f"the single-person model has no {bad}")


class SingleMotionModel(nn.Module):
    """The single-person model (counterpart of
    ``hig_tpu/models/interaction_model.py:192-259``): the CLIP tower and
    text suffix, and :class:`~hig_tpu_torch.models.denoiser.MotionDenoiser`
    on (B, T, input_feats) conditioned on one caption's (B, 77) tokens."""

    def __init__(self, cfg: SingleModelConfig = SingleModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.text = TextEncoder(
            clip_config=cfg.clip,
            text_latent_dim=cfg.text_latent_dim,
            text_ff_size=cfg.text_ff_size,
            text_num_heads=cfg.text_num_heads,
            num_text_layers=cfg.num_text_layers,
            time_embed_dim=cfg.time_embed_dim,
            dtype=cfg.dtype,
        )
        self.denoiser = MotionDenoiser(
            input_feats=cfg.input_feats,
            num_frames=cfg.num_frames,
            latent_dim=cfg.latent_dim,
            ff_size=cfg.ff_size,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
            text_latent_dim=cfg.text_latent_dim,
            efficient=cfg.efficient,
            dtype=cfg.dtype,
        )

    def encode_text(self, tokens: torch.Tensor):
        """(B, 77) tokens → ((B, E), (B, 77, Dt))."""
        return self.text(tokens.long())

    def clip_parameters(self) -> set[str]:
        """Names of the CLIP tower's parameters (the frozen partition)."""
        return {f"text.clip.{name}" for name, _ in self.text.clip.named_parameters()}

    def freeze_clip(self) -> None:
        self.text.clip.requires_grad_(False)

    def text_kv(self, xf_out: torch.Tensor) -> tuple:
        return self.denoiser.text_kv(xf_out)

    def denoise(self, x, timesteps, lengths, xf_proj, xf_out=None, text_kv=None):
        return self.denoiser(x, timesteps, lengths, xf_proj, xf_out, text_kv=text_kv)

    def forward(self, x, timesteps, lengths, tokens):
        xf_proj, xf_out = self.encode_text(tokens)
        return self.denoise(x, timesteps, lengths, xf_proj, xf_out)
