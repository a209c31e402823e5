"""Weights carried across from the JAX package's parameter trees.

A JAX ``InteractionModel`` tree is nested dicts of arrays under
``params/{text,denoiser}`` (``text`` is the CLIP tower and suffix, or the
caption table of a ``cap_id`` model), plus ``params/null_xf_proj`` and
``params/null_xf_token`` when ``cond_drop_prob`` > 0. :func:`load_flax_tree` maps it onto the port's
modules: flax Dense ``kernel`` (in, out) becomes Linear ``weight``
(out, in), LayerNorm ``scale`` becomes ``weight``, and the flax names
``layer_{i}``, ``text_blocks_{i}`` and ``clip/block_{i}`` become the
``ModuleList`` entries ``layers.{i}``, ``text_blocks.{i}`` and
``clip.blocks.{i}``. A leaf left over or a parameter left unset is an
error. An ``rms_norm`` model's RMSNorm leaves carry a ``scale`` and no
``bias`` (the efficient blocks' ``norm`` and every ``proj_out/norm``; the
text cross-attention's ``text_norm`` stays a LayerNorm). A
``--no_cross_attn`` model's layers have no ``int_ca_block``, and a
``--single_transformer`` model's layers hold ``sa_block``, ``ca_block`` and
``ffn`` only. The single-person ``SingleMotionModel`` tree
(:class:`~hig_tpu_torch.models.interaction_model.SingleModelConfig`) is the
CLIP tower and suffix under ``text`` and a ``denoiser`` of those layers
without ``joint_embed2`` and ``out2``.

:func:`cast_floating` is the JAX sampler's ``cast_floating``
(``hig_tpu/train/trainer.py:409-416``): it casts every floating parameter
of a model once, in place, for a bfloat16 model's sampling.

The evaluator models' trees (``embed``, ``block_{i}`` → ``blocks.{i}``,
``out1``/``out2``/``fin_proj`` or ``cls_input``/``cls_output``) map the same
way.

The legacy evaluator zoo's trees (``models/legacy_evaluators.py``) map with
:func:`load_legacy_tree`: a flax ``GRUCell`` (``ir``, ``iz``, ``in``,
``hr``, ``hz``, ``hn``) becomes one cell in torch's gate layout, a ``Conv``
kernel (k, in, out) a ``Conv1d`` weight (out, in, k), a ``ConvTranspose``
kernel (k, in, out), which flax applies unflipped, a ``ConvTranspose1d``
weight (in, out, k) flipped along k, a ``Sequential``'s ``layers_{i}`` entry
``{i}``, ``grus_{i}`` ``grus.{i}``, and a model's top-level ``Dense_{i}``
and ``LayerNorm_{i}`` (its output head, which flax names in the model's
scope) ``head.*``. :func:`smpl_model_from` and :func:`gmm_prior_from` take
the JAX ``SMPLModel`` and ``GMMPrior`` (or any object or dict with their
fields) as numpy.

:func:`random_flax_tree` builds that same tree from a seed with every leaf
nonzero. (The JAX init zeroes ``out``, ``out2``, ``ffn/linear2`` and every
``proj_out/out``, so a freshly initialized model predicts ε ≡ 0 and any
comparison against it passes vacuously.)
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from hig_tpu_torch.models.eval_models import EvalModelConfig
from hig_tpu_torch.models.interaction_model import ModelConfig, SingleModelConfig

_LIST_NAMES = (
    (re.compile(r"layer_(\d+)"), "layers.{}"),
    (re.compile(r"text_blocks_(\d+)"), "text_blocks.{}"),
    (re.compile(r"block_(\d+)"), "blocks.{}"),
)


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    """Nested dict → {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} or {(a, b, c): leaf} → nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/") if isinstance(key, str) else key
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _torch_key(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        for pattern, fmt in _LIST_NAMES:
            m = pattern.fullmatch(p)
            if m:
                p = fmt.format(m.group(1))
                break
        parts.append(p)
    leaf = path[-1]
    parts.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(parts)


def torch_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A flax param tree (with or without the outer ``params``) → a torch
    state dict of float32 CPU tensors."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = {}
    for path, leaf in flatten(tree).items():
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        state[_torch_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def flax_leaves(cfg: ModelConfig) -> dict[str, tuple[tuple, tuple]]:
    """Each parameter name of ``cfg``'s port model → (flax path under
    ``params``, flax shape) of the JAX leaf it carries: the name map of
    :func:`load_flax_tree`, by which a sharding rule keyed on JAX's names
    and shapes reaches the port's parameters."""
    return {_torch_key(path): (path, shape)
            for path, shape in flatten(flax_param_shapes(cfg)["params"]).items()}


def load_flax_tree(model: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX parameter tree into ``model``; every leaf must land on one
    parameter of matching shape and every parameter must be set."""
    state = torch_state_from_flax(tree)
    expected = model.state_dict()
    unused = sorted(set(state) - set(expected))
    unset = sorted(set(expected) - set(state))
    if unused or unset:
        raise ValueError(f"flax tree does not match the model: unused leaves {unused}, "
                         f"unset parameters {unset}")
    bad = [(k, tuple(state[k].shape), tuple(v.shape)) for k, v in expected.items()
           if state[k].shape != v.shape]
    if bad:
        raise ValueError(f"shape mismatch (name, tree, model): {bad}")
    model.load_state_dict(state, strict=True)
    return model


def load_npz(path: str) -> dict:
    """A flattened flax tree saved with ``np.savez`` under "a/b/c" keys."""
    with np.load(path) as f:
        return unflatten({k: f[k] for k in f.files})


def _dense(d_in: int, d_out: int) -> dict:
    return {"kernel": (d_in, d_out), "bias": (d_out,)}


def _ln(d: int, rms: bool = False) -> dict:
    return {"scale": (d,)} if rms else {"scale": (d,), "bias": (d,)}


def _post_ln_layer(d: int, ff: int) -> dict:
    return {"in_proj": _dense(d, 3 * d), "out_proj": _dense(d, d), "norm1": _ln(d),
            "linear1": _dense(d, ff), "linear2": _dense(ff, d), "norm2": _ln(d)}


def _eval_model_shapes(cfg: EvalModelConfig) -> dict:
    """The JAX ``MotionEncoder`` / ``MotionConsistencyEvalModel`` tree."""
    D = cfg.latent_dim
    params = {"embed": {"sequence_embedding": (cfg.num_frames, D),
                        "joint_embed1": _dense(cfg.input_feats, D),
                        "joint_embed2": _dense(4, D)}}
    for i in range(cfg.num_layers):
        params[f"block_{i}"] = _post_ln_layer(D, cfg.ff_size)
    if cfg.kind == "classifier":
        params.update(out1=_dense(D, D), out2=_dense(D, D), fin_proj=_dense(D, cfg.class_num))
    else:
        params.update(cls_input=(1, 1, D), cls_output=_dense(D, cfg.class_num))
    return {"params": params}


def flax_param_shapes(cfg: ModelConfig | EvalModelConfig) -> dict:
    """The JAX parameter tree of ``cfg`` as shapes: the ``InteractionModel``
    of a :class:`ModelConfig`, the ``SingleMotionModel`` of a
    :class:`SingleModelConfig`, or the evaluator model of an
    :class:`EvalModelConfig`."""
    if isinstance(cfg, EvalModelConfig):
        return _eval_model_shapes(cfg)
    single = isinstance(cfg, SingleModelConfig)
    D, Dt, E = cfg.latent_dim, cfg.text_latent_dim, cfg.time_embed_dim
    if cfg.cap_id:
        text = {"cap_embedding": (cfg.num_captions, Dt), "text_proj": _dense(Dt, E)}
    else:
        text = _clip_text_shapes(cfg)

    rms = cfg.rms_norm  # the efficient blocks' norms (the quadratic ones refuse it)

    def styl():
        return {"emb": _dense(E, 2 * D), "norm": _ln(D, rms), "out": _dense(D, D)}

    def attn(d_kv):
        return {"norm": _ln(D, rms), "query": _dense(D, D), "key": _dense(d_kv, D),
                "value": _dense(d_kv, D), "proj_out": styl()}

    den = {
        "sequence_embedding": (cfg.num_frames, D),
        "joint_embed": _dense(cfg.input_feats, D),
        "time_embed": {"fc1": _dense(D, E), "fc2": _dense(E, E)},
        "out": _dense(D, cfg.input_feats),
    }
    if not single:
        den.update(joint_embed2=_dense(4, D), out2=_dense(D, cfg.input_feats))
    interaction = cfg.interaction and not (cfg.single_transformer or single)
    for i in range(cfg.num_layers):
        layer = {
            "sa_block": attn(D),
            "ca_block": {**attn(Dt), "text_norm": _ln(Dt)},
            "ffn": {"linear1": _dense(D, cfg.ff_size), "linear2": _dense(cfg.ff_size, D),
                    "proj_out": styl()},
        }
        if interaction:
            # the quadratic interaction block normalizes the partner with
            # its own text_norm; the efficient one shares ``norm``
            layer["int_ca_block"] = attn(D) if cfg.efficient else {**attn(D),
                                                                   "text_norm": _ln(D)}
        den[f"layer_{i}"] = layer
    params = {"text": text, "denoiser": den}
    if cfg.cond_drop_prob > 0.0:
        params.update(null_xf_proj=(E,), null_xf_token=(Dt,))
    return {"params": params}


def _clip_text_shapes(cfg: ModelConfig) -> dict:
    """The ``text`` subtree of a caption-token model: CLIP tower + suffix."""
    W, Dt, E = cfg.clip.width, cfg.text_latent_dim, cfg.time_embed_dim
    clip = {
        "token_embedding": (cfg.clip.vocab_size, W),
        "positional_embedding": (cfg.clip.context_length, W),
        "ln_final": _ln(W),
    }
    for i in range(cfg.clip.layers):
        clip[f"block_{i}"] = {
            "ln_1": _ln(W),
            "attn": {"in_proj": _dense(W, 3 * W), "out_proj": _dense(W, W)},
            "ln_2": _ln(W),
            "mlp_fc": _dense(W, 4 * W),
            "mlp_proj": _dense(4 * W, W),
        }
    text = {"clip": clip, "text_ln": _ln(Dt), "text_proj": _dense(Dt, E)}
    if Dt != W:
        text["text_pre_proj"] = _dense(W, Dt)
    for i in range(cfg.num_text_layers):
        text[f"text_blocks_{i}"] = _post_ln_layer(Dt, cfg.text_ff_size)
    return text


def random_flax_tree(cfg: ModelConfig | EvalModelConfig, seed: int) -> dict:
    """Seeded random JAX-layout parameter tree with every leaf nonzero:
    kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1²), LayerNorm scales
    ~ 1 + N(0, 0.1²), embeddings at the JAX init's scales, and the null
    conditioning (zeros in the JAX init) ~ N(0, 1); the evaluators'
    ``out1`` / ``out2`` (zeros in the JAX init) are kernels like any
    other."""
    rng = np.random.default_rng(seed)
    embed_std = {"token_embedding": 0.02, "positional_embedding": 0.01,
                 "sequence_embedding": 1.0, "cap_embedding": 1.0,
                 "null_xf_proj": 1.0, "null_xf_token": 1.0, "cls_input": 1.0}
    flat = {}
    for path, shape in sorted(flatten(flax_param_shapes(cfg)).items()):
        z = rng.standard_normal(shape, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            z *= np.float32(1.0 / np.sqrt(shape[0]))
        elif leaf == "scale":
            z = np.float32(1.0) + np.float32(0.1) * z
        elif leaf == "bias":
            z *= np.float32(0.1)
        else:
            z *= np.float32(embed_std[leaf])
        flat[path] = z
    return unflatten(flat)


def cast_floating(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer of ``model`` to ``dtype``,
    in place (``nn.Module.to`` leaves integer tensors alone). For bfloat16
    it also turns off cuBLAS's reduced-precision bfloat16 reductions (a
    process-wide setting), so that the model's bfloat16 products outside
    the kernels reduce in float32, as XLA's do."""
    if dtype == torch.bfloat16:
        reduce_bf16_in_float32()
    return model.to(dtype)


def reduce_bf16_in_float32() -> None:
    """Turn off cuBLAS's reduced-precision bfloat16 reductions (a
    process-wide setting): a bfloat16 product outside the kernels then sums
    in float32 and rounds once, as XLA's does."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


_GRU_GATES = ("r", "z", "n")


def _legacy_module_key(path: tuple) -> str:
    parts = []
    for i, p in enumerate(path):
        if p.startswith("GRUCell_"):
            parts.append("cell")
        elif re.fullmatch(r"layers_\d+", p):
            parts.append(p.split("_")[1])
        elif re.fullmatch(r"grus_\d+", p):
            parts += ["grus", p.split("_")[1]]
        elif i == 0 and re.fullmatch(r"(Dense|LayerNorm)_\d+", p):
            parts += ["head", p]
        else:
            parts.append(p)
    return ".".join(parts)


def legacy_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A legacy evaluator's flax tree → a torch state dict (module doc)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = {k: np.asarray(v, np.float32) for k, v in flatten(tree).items()}
    state: dict[str, np.ndarray] = {}
    cells = sorted({k[:-2] for k in flat if len(k) >= 2 and k[-2] in ("ir", "hn")})
    for cell in cells:
        key = _legacy_module_key(cell)
        hidden = flat[cell + ("hn", "bias")].shape[0]
        state[f"{key}.weight_ih"] = np.concatenate(
            [flat[cell + (f"i{g}", "kernel")].T for g in _GRU_GATES])
        state[f"{key}.bias_ih"] = np.concatenate([flat[cell + (f"i{g}", "bias")]
                                                  for g in _GRU_GATES])
        state[f"{key}.weight_hh"] = np.concatenate(
            [flat[cell + (f"h{g}", "kernel")].T for g in _GRU_GATES])
        state[f"{key}.bias_hh"] = np.concatenate(
            [np.zeros(2 * hidden, np.float32), flat[cell + ("hn", "bias")]])
    for path, arr in flat.items():
        if len(path) >= 2 and path[:-2] in cells:
            continue
        module, leaf = path[:-1], path[-1]
        if leaf == "kernel":
            if module[-1].startswith("ConvTranspose_"):
                arr = arr[::-1].transpose(1, 2, 0)
            elif module[-1].startswith("Conv_"):
                arr = arr.transpose(2, 1, 0)
            else:
                arr = arr.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        prefix = _legacy_module_key(module)
        state[f"{prefix}.{leaf}" if prefix else leaf] = arr
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()}


def load_legacy_tree(model: nn.Module, tree: dict) -> nn.Module:
    """Load a legacy evaluator's flax tree into ``model``, every leaf onto
    one parameter of its shape and every parameter set."""
    state = legacy_state_from_flax(tree)
    expected = model.state_dict()
    unused, unset = sorted(set(state) - set(expected)), sorted(set(expected) - set(state))
    bad = [(k, tuple(state[k].shape), tuple(v.shape)) for k, v in expected.items()
           if k in state and state[k].shape != v.shape]
    if unused or unset or bad:
        raise ValueError(f"flax tree does not match the model: unused leaves {unused}, "
                         f"unset parameters {unset}, shape mismatches {bad}")
    model.load_state_dict(state, strict=True)
    return model


def _fields(src, names) -> dict:
    return {n: src[n] if isinstance(src, dict) else getattr(src, n) for n in names}


def smpl_model_from(src):
    """An ``smpl.lbs.SMPLModel`` from the JAX ``SMPLModel`` (or a dict) of
    the same fields."""
    from hig_tpu_torch.smpl.lbs import FIELDS, SMPLModel

    arrays = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in _fields(src, FIELDS).items()}
    extra = _fields(src, ("parents", "faces")) if not isinstance(src, dict) else \
        {k: src.get(k) for k in ("parents", "faces")}
    faces = None if extra["faces"] is None else torch.from_numpy(np.array(extra["faces"],
                                                                           np.int32))
    parents = tuple(extra["parents"]) if extra["parents"] is not None else None
    return SMPLModel(**arrays, faces=faces, **({"parents": parents} if parents else {}))


def gmm_prior_from(src):
    """An ``smpl.prior.GMMPrior`` from the JAX ``GMMPrior`` (or a dict)."""
    from hig_tpu_torch.smpl.prior import GMMPrior

    return GMMPrior(**{k: torch.from_numpy(np.array(v, np.float32)) for k, v in
                       _fields(src, ("means", "precisions", "nll_weights")).items()})
