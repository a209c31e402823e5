"""The two-actor interaction denoiser and the single-person one
(counterpart of ``hig_tpu/models/denoiser.py``).

Actors are an explicit axis, ``x: (B, 2, T, D)``. Each layer runs
self-attention, text cross-attention, cross-actor interaction attention and
an FFN, each gated by its own AdaLN ``StylizationBlock``. The paper's
ablations: ``interaction=False`` (``--no_cross_attn``) leaves the
interaction block out, and ``single_transformer`` puts both actors on one
2T-token timeline through layers of self-attention, text cross-attention
and FFN (:class:`SinglePersonDenoiserLayer`), conditioned on the mean of
the two actors' embeddings and attending to both captions' tokens.
:class:`MotionDenoiser` is the single-person model on ``(B, T, D)``. The attention
blocks are the efficient (linear) family, or with ``efficient=False`` the
quadratic (softmax) family of the reference's ``--no_eff`` mode; either
may be ``causal``. ``dtype`` is the compute dtype (float32 or bfloat16);
``fast_ln`` and ``rms_norm`` pick the efficient blocks' norms
(``embeddings.make_norm``). The motion input stays float32 until the first
Linear, and the output ε is in the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from hig_tpu_torch.models.attention import (
    FFN,
    EfficientCrossAttention,
    EfficientInteractionAttention,
    EfficientSelfAttention,
    QuadraticCrossAttention,
    QuadraticInteractionAttention,
    QuadraticSelfAttention,
)
from hig_tpu_torch.models.embeddings import TimeEmbedMLP, cast, dense, length_mask, reduced

BLOCKS = (("sa", "sa_block"), ("ca", "ca_block"), ("int", "int_ca_block"), ("ffn", "ffn"))


RMS_NORM_ROUTES = ("--rms_norm requires the efficient attention path and is "
                   "incompatible with --fused_blocks")


CAUSAL_SINGLE = ("--causal cannot be combined with --single_transformer: the merged 2T "
                 "timeline has no consistent temporal order. Use --causal with the "
                 "interaction stack instead.")


def check_block_options(efficient: bool, causal: bool, fused_blocks: bool,
                        rms_norm: bool = False, single_transformer: bool = False) -> None:
    """Refuse the combinations the port has no blocks for. RMSNorm and the
    causal merged timeline take JAX's refusals, in JAX's order: the
    quadratic blocks keep the reference's LayerNorms and the fused-block
    kernel computes LayerNorm inside (refused under ``single_transformer``
    too, whose layers never fuse), and a causal mask over the merged
    timeline's token index is no temporal order."""
    if rms_norm and (not efficient or fused_blocks):
        raise ValueError(RMS_NORM_ROUTES)
    if causal and single_transformer:
        raise ValueError(CAUSAL_SINGLE)
    if fused_blocks and not efficient:
        raise ValueError("fused_blocks fuses efficient-attention blocks; it cannot be "
                         "combined with efficient=False")


def actor_mean(emb: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean over the actor axis ``dim``; a bfloat16 one summed in
    float32 and rounded once, as ``jnp.mean`` takes it."""
    if not reduced(emb.dtype):
        return emb.mean(dim=dim)
    return emb.float().mean(dim=dim).to(emb.dtype)


class InteractionDenoiserLayer(nn.Module):
    """self-attn → text cross-attn → cross-actor interaction → FFN; without
    ``interaction`` the interaction block is not built."""

    def __init__(self, latent_dim: int, text_latent_dim: int, ff_size: int,
                 num_heads: int, emb_dim: int, fused_blocks: bool = False,
                 efficient: bool = True, causal: bool = False,
                 dtype: torch.dtype = torch.float32, fast_ln: bool = False,
                 rms_norm: bool = False, interaction: bool = True):
        super().__init__()
        check_block_options(efficient, causal, fused_blocks, rms_norm)
        self.interaction = interaction
        if efficient:
            norm = dict(dtype=dtype, fast_ln=fast_ln, rms=rms_norm)
            self.sa_block = EfficientSelfAttention(latent_dim, num_heads, emb_dim, fused_blocks,
                                                   causal=causal, **norm)
            self.ca_block = EfficientCrossAttention(latent_dim, text_latent_dim, num_heads,
                                                    emb_dim, **norm)
            if interaction:
                self.int_ca_block = EfficientInteractionAttention(
                    latent_dim, num_heads, emb_dim, fused_blocks, causal=causal, **norm
                )
        else:
            # the quadratic blocks keep float32-statistics LayerNorms
            self.sa_block = QuadraticSelfAttention(latent_dim, num_heads, emb_dim, causal, dtype)
            self.ca_block = QuadraticCrossAttention(latent_dim, text_latent_dim, num_heads,
                                                    emb_dim, dtype)
            if interaction:
                self.int_ca_block = QuadraticInteractionAttention(latent_dim, num_heads,
                                                                  emb_dim, causal, dtype)
        self.ffn = FFN(latent_dim, ff_size, emb_dim, dtype, fast_ln and efficient, rms_norm)

    def text_kv(self, xf_out):
        """The text cross-attention state: a KᵀV tensor (efficient) or a
        (k, v) pair (quadratic)."""
        return self.ca_block.kv(xf_out)

    def forward(self, x, xf_out, emb, src_mask, text_kv=None, adaln=None):
        a = adaln or {}
        x = self.sa_block(x, emb, src_mask, adaln=a.get("sa"))
        if text_kv is None:
            x = self.ca_block(x, xf_out, emb, adaln=a.get("ca"))
        else:
            x = self.ca_block.from_kv(x, text_kv, emb, adaln=a.get("ca"))
        if self.interaction:
            x = self.int_ca_block(x, emb, src_mask, adaln=a.get("int"))
        return self.ffn(x, emb, adaln=a.get("ffn"))


class SinglePersonDenoiserLayer(InteractionDenoiserLayer):
    """self-attn → text cross-attn → FFN: the layer of the merged timeline
    and of :class:`MotionDenoiser`. JAX builds it without ``fused``
    (``hig_tpu/models/denoiser.py:324-377``), so its self-attention takes B2
    (or B4), never B1."""

    def __init__(self, latent_dim: int, text_latent_dim: int, ff_size: int,
                 num_heads: int, emb_dim: int, efficient: bool = True, causal: bool = False,
                 dtype: torch.dtype = torch.float32, fast_ln: bool = False,
                 rms_norm: bool = False):
        super().__init__(latent_dim, text_latent_dim, ff_size, num_heads, emb_dim, False,
                         efficient, causal, dtype, fast_ln, rms_norm, interaction=False)


class InteractionDenoiser(nn.Module):
    """Two-actor text-conditioned ε-predictor.

    x (B, 2, T, input_feats) with token 0 the init-pose token (channels 0:4);
    timesteps (B,); lengths (B,) valid tokens including the init token;
    xf_proj (B, 2, 4·latent_dim); xf_out (B, 2, L, text_latent_dim).
    Separate output heads for the init token (``out2``) and the frames
    (``out``). ``interaction`` and ``single_transformer`` are the
    ablations of the module doc; under ``single_transformer`` the layers
    never fuse, whatever ``fused_blocks`` says, as in JAX. With
    ``pipeline`` set (a ``parallel.pipeline.Pipeline``, ``--pp_micro``) the
    layer stack runs under the GPipe schedule over the model axis's ranks.
    With ``sequence`` set (a ``parallel.distributed.Group``, by
    ``parallel.mesh.place_sequence``) x is this rank's contiguous slice of
    the time axis and so is the output: sequence parallelism.
    """

    pipeline = None
    sequence = None

    def __init__(self, input_feats: int = 263, num_frames: int = 196,
                 latent_dim: int = 512, ff_size: int = 1024, num_layers: int = 8,
                 num_heads: int = 8, text_latent_dim: int = 256,
                 fused_blocks: bool = False, efficient: bool = True, causal: bool = False,
                 dtype: torch.dtype = torch.float32, fast_ln: bool = False,
                 rms_norm: bool = False, interaction: bool = True,
                 single_transformer: bool = False):
        super().__init__()
        check_block_options(efficient, causal, fused_blocks, rms_norm, single_transformer)
        self.single_transformer = single_transformer
        self.latent_dim = latent_dim
        self.dtype = dtype
        self.time_embed_dim = 4 * latent_dim
        self.sequence_embedding = nn.Parameter(torch.randn(num_frames, latent_dim))
        self.joint_embed = nn.Linear(input_feats, latent_dim)
        self.joint_embed2 = nn.Linear(4, latent_dim)
        self.time_embed = TimeEmbedMLP(latent_dim, self.time_embed_dim, dtype)
        if single_transformer:
            self.layers = nn.ModuleList(
                SinglePersonDenoiserLayer(latent_dim, text_latent_dim, ff_size, num_heads,
                                          self.time_embed_dim, efficient, causal, dtype,
                                          fast_ln, rms_norm)
                for _ in range(num_layers)
            )
        else:
            self.layers = nn.ModuleList(
                InteractionDenoiserLayer(latent_dim, text_latent_dim, ff_size, num_heads,
                                         self.time_embed_dim, fused_blocks, efficient, causal,
                                         dtype, fast_ln, rms_norm, interaction)
                for _ in range(num_layers)
            )
        self.out = nn.Linear(latent_dim, input_feats)
        self.out2 = nn.Linear(latent_dim, input_feats)

    def text_kv(self, xf_out) -> tuple:
        """Per-layer text cross-attention state, computed once per call
        (under ``single_transformer`` over both captions' tokens)."""
        if self.single_transformer:
            xf_out = merge_text(xf_out)
        return tuple(layer.text_kv(xf_out) for layer in self.layers)

    def embed_inputs(self, x, lengths, offset: int = 0):
        """(B, 2, T, D_in) → (hidden (B, 2, T, D), src_mask (B, 1, T)).
        ``offset``: the global index of x's first token (a sequence-parallel
        rank's slice of the time axis); token 0 is the init token."""
        T, dt = x.shape[2], self.dtype
        first = 1 if offset == 0 else 0  # whether x holds the init token
        seq = cast(self.sequence_embedding[offset + first - 1: offset + T - 1], dt)
        h = dense(self.joint_embed, x[:, :, first:], dt) + seq
        if first:
            init = dense(self.joint_embed2, x[:, :, 0, :4], dt)
            h = torch.cat([init[:, :, None, :], h], dim=2)
        mask_dtype = x.dtype if dt == torch.float32 else dt
        mask = (torch.arange(offset, offset + T, device=lengths.device)
                < lengths[..., None]).to(mask_dtype) if offset else \
            length_mask(lengths, T, mask_dtype)
        return h, mask[:, None, :]

    def conditioning(self, timesteps, xf_proj):
        """(B,) timesteps + (B, 2, E) pooled text → per-block emb (B, 2, E)."""
        return self.time_embed(timesteps)[:, None, :] + xf_proj

    def project_out(self, h, offset: int = 0):
        """The output heads: ``out2`` for the init token (when h, starting at
        global token ``offset``, holds it), ``out`` for the frames."""
        if offset:
            return dense(self.out, h, self.dtype)
        return torch.cat([dense(self.out2, h[:, :, :1], self.dtype),
                          dense(self.out, h[:, :, 1:], self.dtype)], dim=2)

    def forward(self, x, timesteps, lengths, xf_proj, xf_out=None, text_kv=None,
                adaln=None):
        """``adaln``: per-layer dicts of precomputed (scale, shift) pairs
        (``adaln_scale_shift_grid``); emb is then not computed."""
        if x.shape[1] != 2:
            raise ValueError(f"actor axis must be 2, got {tuple(x.shape)}")
        offset = 0 if self.sequence is None else self.sequence.index() * x.shape[2]
        h, src_mask = self.embed_inputs(x, lengths, offset)
        emb = self.conditioning(timesteps, xf_proj) if adaln is None else None
        B, A, T = h.shape[:3]
        if self.single_transformer:
            # one 2T-token timeline, conditioned on the actors' mean
            h = h.reshape(B, A * T, -1)
            emb = None if emb is None else actor_mean(emb, 1)
            src_mask = src_mask.expand(B, A, T).reshape(B, A * T)
            xf_out = None if xf_out is None else merge_text(xf_out)
        if self.pipeline is not None:
            if text_kv is not None or adaln is not None or self.single_transformer:
                raise ValueError("the pipelined layer stack takes the text features and "
                                 "the conditioning (the efficient interaction stack, as "
                                 "JAX's pipeline_denoise), not hoisted state")
            h = self.pipeline(self.layers, h, xf_out, emb, src_mask)
            return self.project_out(h.reshape(B, A, T, -1))
        for i, layer in enumerate(self.layers):
            h = layer(h, xf_out, emb, src_mask,
                      text_kv=None if text_kv is None else text_kv[i],
                      adaln=None if adaln is None else adaln[i])
        return self.project_out(h.reshape(B, A, T, -1), offset)


def merge_text(xf_out: torch.Tensor) -> torch.Tensor:
    """(B, 2, L, Dt) → (B, 2L, Dt): both captions in one token sequence."""
    return xf_out.reshape(xf_out.shape[0], -1, *xf_out.shape[3:])


class MotionDenoiser(nn.Module):
    """The single-person MotionDiffuse denoiser (counterpart of
    ``hig_tpu/models/denoiser.py:379-449``): x (B, T, input_feats) with no
    init token, timesteps (B,), lengths (B,), xf_proj (B, 4·latent_dim),
    xf_out (B, L, text_latent_dim); one output head."""

    def __init__(self, input_feats: int = 263, num_frames: int = 196,
                 latent_dim: int = 512, ff_size: int = 1024, num_layers: int = 8,
                 num_heads: int = 8, text_latent_dim: int = 256, efficient: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.time_embed_dim = 4 * latent_dim
        self.sequence_embedding = nn.Parameter(torch.randn(num_frames, latent_dim))
        self.joint_embed = nn.Linear(input_feats, latent_dim)
        self.time_embed = TimeEmbedMLP(latent_dim, self.time_embed_dim, dtype)
        self.layers = nn.ModuleList(
            SinglePersonDenoiserLayer(latent_dim, text_latent_dim, ff_size, num_heads,
                                      self.time_embed_dim, efficient, dtype=dtype)
            for _ in range(num_layers)
        )
        self.out = nn.Linear(latent_dim, input_feats)

    def text_kv(self, xf_out) -> tuple:
        return tuple(layer.text_kv(xf_out) for layer in self.layers)

    def forward(self, x, timesteps, lengths, xf_proj, xf_out=None, text_kv=None):
        T, dt = x.shape[1], self.dtype
        h = dense(self.joint_embed, x, dt) + cast(self.sequence_embedding[:T], dt)
        emb = self.time_embed(timesteps) + xf_proj
        mask = length_mask(lengths, T, x.dtype if dt == torch.float32 else dt)
        for i, layer in enumerate(self.layers):
            h = layer(h, xf_out, emb, mask, text_kv=None if text_kv is None else text_kv[i])
        return dense(self.out, h, dt)
