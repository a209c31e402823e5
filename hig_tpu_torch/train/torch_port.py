"""Reference PyTorch checkpoint → the port's parameters (``--pretrained``;
the port's own copy of ``hig_tpu/train/torch_port.py``).

Converts state dicts saved by the reference implementation — the
MotionInteractionTransformer / MotionTransformer ``encoder`` entry of
``latest.tar`` (mul_ddpm_trainer.py:269-280), the evaluator models'
``best_eval_model.pth`` and the embedded OpenAI CLIP text tower — into the
JAX package's flax parameter trees, as the JAX converter does: torch Linear
weights are (out, in) and flax kernels (in, out), LayerNorm weight → scale.
The reference's partial-loading filters (``--only_language`` /
``--only_motion``, interaction_transformer.py:511-531) pick the subtree.
:func:`load_into` then carries a converted subtree into a port model
through the bridge of ``hig_tpu_torch/weights.py`` (flax layout → torch
layout), leaving every parameter outside it at its value.

The converters take a plain {name: np.ndarray} mapping
(:func:`load_torch_state_dict`). :func:`reference_state_dict` makes a
seeded stand-in of the reference's checkpoint with its key names, for runs
and tests without the asset.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from hig_tpu_torch.weights import torch_state_from_flax


def _lin(sd, name):
    out = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _stylization(sd, prefix):
    """StylizationBlock: emb_layers=Seq(SiLU, Linear); out_layers=Seq(SiLU,
    Dropout, Linear). (ref: interaction_transformer.py:71-84)"""
    return {
        "emb": _lin(sd, f"{prefix}.emb_layers.1"),
        "norm": _ln(sd, f"{prefix}.norm"),
        "out": _lin(sd, f"{prefix}.out_layers.2"),
    }


def _attention_block(sd, prefix, with_text_norm=False):
    out = {
        "norm": _ln(sd, f"{prefix}.norm"),
        "query": _lin(sd, f"{prefix}.query"),
        "key": _lin(sd, f"{prefix}.key"),
        "value": _lin(sd, f"{prefix}.value"),
        "proj_out": _stylization(sd, f"{prefix}.proj_out"),
    }
    if with_text_norm:
        out["text_norm"] = _ln(sd, f"{prefix}.text_norm")
    return out


def _ffn(sd, prefix):
    return {
        "linear1": _lin(sd, f"{prefix}.linear1"),
        "linear2": _lin(sd, f"{prefix}.linear2"),
        "proj_out": _stylization(sd, f"{prefix}.proj_out"),
    }


def _torch_encoder_layer(sd, prefix):
    """nn.TransformerEncoderLayer → PostLNEncoderLayer params."""
    return {
        "in_proj": {
            "kernel": np.ascontiguousarray(sd[f"{prefix}.self_attn.in_proj_weight"].T),
            "bias": sd[f"{prefix}.self_attn.in_proj_bias"],
        },
        "out_proj": _lin(sd, f"{prefix}.self_attn.out_proj"),
        "linear1": _lin(sd, f"{prefix}.linear1"),
        "linear2": _lin(sd, f"{prefix}.linear2"),
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
    }


def convert_clip_text_tower(sd, prefix: str = "clip", layers: int = 12) -> dict:
    """OpenAI CLIP text-tower state_dict slice → ClipTextTower params."""
    out = {
        "token_embedding": sd[f"{prefix}.token_embedding.weight"],
        "positional_embedding": sd[f"{prefix}.positional_embedding"],
        "ln_final": _ln(sd, f"{prefix}.ln_final"),
    }
    for i in range(layers):
        rb = f"{prefix}.transformer.resblocks.{i}"
        out[f"block_{i}"] = {
            "ln_1": _ln(sd, f"{rb}.ln_1"),
            "ln_2": _ln(sd, f"{rb}.ln_2"),
            "attn": {
                "in_proj": {
                    "kernel": np.ascontiguousarray(sd[f"{rb}.attn.in_proj_weight"].T),
                    "bias": sd[f"{rb}.attn.in_proj_bias"],
                },
                "out_proj": _lin(sd, f"{rb}.attn.out_proj"),
            },
            "mlp_fc": _lin(sd, f"{rb}.mlp.c_fc"),
            "mlp_proj": _lin(sd, f"{rb}.mlp.c_proj"),
        }
    return out


def convert_text_encoder(sd, num_text_layers: int = 4, clip_layers: int = 12,
                         has_pre_proj: bool = True) -> dict:
    """Text stack of MotionInteractionTransformer → TextEncoder params."""
    out = {"clip": convert_clip_text_tower(sd, "clip", clip_layers)}
    if has_pre_proj:
        out["text_pre_proj"] = _lin(sd, "text_pre_proj")
    for i in range(num_text_layers):
        out[f"text_blocks_{i}"] = _torch_encoder_layer(sd, f"textTransEncoder.layers.{i}")
    out["text_ln"] = _ln(sd, "text_ln")
    out["text_proj"] = _lin(sd, "text_proj.0")
    return out


def convert_interaction_denoiser(sd, num_layers: int = 8, interaction: bool = True) -> dict:
    """Motion path of MotionInteractionTransformer → InteractionDenoiser."""
    out = {
        "sequence_embedding": sd["sequence_embedding"],
        "joint_embed": _lin(sd, "joint_embed"),
        "joint_embed2": _lin(sd, "joint_embed2"),
        "time_embed": {
            "fc1": _lin(sd, "time_embed.0"),
            "fc2": _lin(sd, "time_embed.2"),
        },
        "out": _lin(sd, "out"),
        "out2": _lin(sd, "out2"),
    }
    for i in range(num_layers):
        blk = f"temporal_decoder_blocks.{i}"
        layer = {
            "sa_block": _attention_block(sd, f"{blk}.sa_block"),
            "ca_block": _attention_block(sd, f"{blk}.ca_block", with_text_norm=True),
            "ffn": _ffn(sd, f"{blk}.ffn"),
        }
        if interaction and f"{blk}.int_ca_block.norm.weight" in sd:
            has_tn = f"{blk}.int_ca_block.text_norm.weight" in sd
            layer["int_ca_block"] = _attention_block(
                sd, f"{blk}.int_ca_block", with_text_norm=has_tn
            )
        out[f"layer_{i}"] = layer
    return out


def convert_interaction_model(
    sd, num_layers: int = 8, num_text_layers: int = 4, clip_layers: int = 12,
    interaction: bool = True, cap_id: bool = False,
    only_language: bool = False, only_motion: bool = False,
) -> dict:
    """Full reference checkpoint → InteractionModel variables['params'].

    only_language / only_motion mirror load_my_state_dict's filters — the
    caller merges the returned subtree into an initialized tree.
    """
    params: dict = {}
    if not only_motion:
        if cap_id:
            params["text"] = {
                "cap_embedding": sd["cap_embedding"],
                "text_proj": _lin(sd, "text_proj.0"),
            }
        else:
            params["text"] = convert_text_encoder(
                sd, num_text_layers, clip_layers,
                has_pre_proj="text_pre_proj.weight" in sd,
            )
    if not only_language:
        params["denoiser"] = convert_interaction_denoiser(sd, num_layers, interaction)
    return params


def convert_single_person_denoiser(sd, num_layers: int = 8) -> dict:
    """MotionTransformer (transformer.py:288-426) → MotionDenoiser params."""
    out = {
        "sequence_embedding": sd["sequence_embedding"],
        "joint_embed": _lin(sd, "joint_embed"),
        "time_embed": {
            "fc1": _lin(sd, "time_embed.0"),
            "fc2": _lin(sd, "time_embed.2"),
        },
        "out": _lin(sd, "out"),
    }
    for i in range(num_layers):
        blk = f"temporal_decoder_blocks.{i}"
        out[f"layer_{i}"] = {
            "sa_block": _attention_block(sd, f"{blk}.sa_block"),
            "ca_block": _attention_block(sd, f"{blk}.ca_block", with_text_norm=True),
            "ffn": _ffn(sd, f"{blk}.ffn"),
        }
    return out


def convert_motion_encoder(sd, num_layers: int = 8) -> dict:
    """MotionEncoder / MotionConsistencyEvalModel state_dict → our params."""
    out = {
        "embed": {
            "sequence_embedding": sd["sequence_embedding"],
            "joint_embed1": _lin(sd, "joint_embed1"),
            "joint_embed2": _lin(sd, "joint_embed2"),
        }
    }
    for i in range(num_layers):
        out[f"block_{i}"] = _torch_encoder_layer(sd, f"motionTransEncoder.layers.{i}")
    if "fin_proj.0.weight" in sd:
        out["out1"] = _lin(sd, "out1")
        out["out2"] = _lin(sd, "out2")
        out["fin_proj"] = _lin(sd, "fin_proj.0")
    if "cls_input" in sd:
        out["cls_input"] = sd["cls_input"].reshape(1, 1, -1)
        out["cls_output"] = _lin(sd, "cls_output.0")
    return out


def load_torch_state_dict(path: str) -> dict:
    """torch.load a .tar/.pth (its ``encoder`` entry when it has one) and
    return {name: np.ndarray}."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("encoder", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().numpy() for k, v in sd.items()}


def merge_params(initialized: dict, converted: dict) -> dict:
    """Recursively overwrite initialized params with converted ones,
    asserting shape agreement (load_my_state_dict semantics)."""
    out = dict(initialized)
    for k, v in converted.items():
        if isinstance(v, dict):
            base = out.get(k, {})
            assert isinstance(base, dict), f"tree mismatch at {k}"
            out[k] = merge_params(base, v)
        else:
            if k in out:
                assert np.shape(out[k]) == np.shape(v), (
                    f"shape mismatch at {k}: {np.shape(out[k])} vs {np.shape(v)}"
                )
            out[k] = np.asarray(v)
    return out


def load_into(model: nn.Module, converted: dict, local=None) -> list[str]:
    """Copy a converted flax subtree (:func:`convert_interaction_model`'s)
    into ``model``'s parameters in place, through the bridge; returns the
    parameter names it set. ``local(name, whole)`` cuts each whole tensor to
    what a rank's model holds (``TrainLayout.model_local``: a TP shard). A
    leaf that lands on no parameter, or on one of another shape, raises
    before anything is copied."""
    state = torch_state_from_flax(converted)
    if local is not None:
        state = {k: local(k, v) for k, v in state.items()}
    own = dict(model.named_parameters())
    unused = sorted(set(state) - set(own))
    if unused:
        raise ValueError(f"converted leaves without a parameter in the model: {unused}")
    bad = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in state.items()
           if v.shape != own[k].shape]
    if bad:
        raise ValueError(f"shape mismatch (name, checkpoint, model): {bad}")
    with torch.no_grad():
        for k, v in state.items():
            own[k].copy_(v)
    return sorted(state)


def reference_state_dict(cfg, seed: int = 0) -> dict:
    """A seeded state dict with the reference's key names (the
    MotionInteractionTransformer ``encoder`` entry of its latest.tar) at the
    widths of ``cfg``, a ``ModelConfig`` of the efficient model: CLIP at
    ``cfg.clip``'s widths, or the caption embedding of a ``cap_id`` model;
    Linear weights (out, in)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def arr(*shape, scale=0.05):
        return (scale * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)

    def lin(name, i, o):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = arr(o, i, scale=i ** -0.5), arr(o)

    def ln(name, d):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1 + arr(d), arr(d)

    def encoder_layer(prefix, d, ff, attn="self_attn", names=("linear1", "linear2")):
        sd[f"{prefix}.{attn}.in_proj_weight"] = arr(3 * d, d, scale=d ** -0.5)
        sd[f"{prefix}.{attn}.in_proj_bias"] = arr(3 * d)
        lin(f"{prefix}.{attn}.out_proj", d, d)
        lin(f"{prefix}.{names[0]}", d, ff)
        lin(f"{prefix}.{names[1]}", ff, d)

    clip, D, Dt, E = cfg.clip, cfg.latent_dim, cfg.text_latent_dim, cfg.time_embed_dim
    if cfg.cap_id:
        sd["cap_embedding"] = arr(cfg.num_captions, Dt, scale=1.0)
    else:
        W = clip.width
        sd["clip.token_embedding.weight"] = arr(clip.vocab_size, W, scale=0.02)
        sd["clip.positional_embedding"] = arr(clip.context_length, W, scale=0.01)
        ln("clip.ln_final", W)
        for i in range(clip.layers):
            rb = f"clip.transformer.resblocks.{i}"
            encoder_layer(rb, W, 4 * W, attn="attn", names=("mlp.c_fc", "mlp.c_proj"))
            ln(f"{rb}.ln_1", W)
            ln(f"{rb}.ln_2", W)
        lin("text_pre_proj", W, Dt)
        for i in range(cfg.num_text_layers):
            t = f"textTransEncoder.layers.{i}"
            encoder_layer(t, Dt, cfg.text_ff_size)
            ln(f"{t}.norm1", Dt)
            ln(f"{t}.norm2", Dt)
        ln("text_ln", Dt)
    lin("text_proj.0", Dt, E)
    sd["sequence_embedding"] = arr(cfg.num_frames, D, scale=1.0)
    lin("joint_embed", cfg.input_feats, D)
    lin("joint_embed2", 4, D)
    lin("time_embed.0", D, E)
    lin("time_embed.2", E, E)
    lin("out", D, cfg.input_feats)
    lin("out2", D, cfg.input_feats)

    def block(prefix, kv, text_norm=False):
        ln(f"{prefix}.norm", D)
        if text_norm:
            ln(f"{prefix}.text_norm", kv)
        lin(f"{prefix}.query", D, D)
        lin(f"{prefix}.key", kv, D)
        lin(f"{prefix}.value", kv, D)
        lin(f"{prefix}.proj_out.emb_layers.1", E, 2 * D)
        ln(f"{prefix}.proj_out.norm", D)
        lin(f"{prefix}.proj_out.out_layers.2", D, D)

    for i in range(cfg.num_layers):
        blk = f"temporal_decoder_blocks.{i}"
        block(f"{blk}.sa_block", D)
        block(f"{blk}.ca_block", Dt, text_norm=True)
        if cfg.interaction:
            block(f"{blk}.int_ca_block", D)
        lin(f"{blk}.ffn.linear1", D, cfg.ff_size)
        lin(f"{blk}.ffn.linear2", cfg.ff_size, D)
        lin(f"{blk}.ffn.proj_out.emb_layers.1", E, 2 * D)
        ln(f"{blk}.ffn.proj_out.norm", D)
        lin(f"{blk}.ffn.proj_out.out_layers.2", D, D)
    return sd


def save_reference_checkpoint(sd: dict, path: str) -> None:
    """``sd`` as the reference saves it: {"encoder": state dict} in a torch
    file (its latest.tar), which :func:`load_torch_state_dict` reads."""
    torch.save({"encoder": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
