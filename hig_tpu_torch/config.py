"""Training configuration (own copy of the ``ExperimentConfig`` fields of
``hig_tpu/config.py`` that the trainer and ``python -m hig_tpu_torch.train``
read, with the same names and defaults).

Every option of a JAX run is carried, the multi-device ones too: the
(data, model) grid of ranks (``mesh``: ``--mesh_data``, ``--mesh_model``,
``--mesh_dcn_data``), ``distributed`` (several processes, ``HIG_*``), and the
layouts of the model axis, FSDP (``fsdp``), tensor parallelism (``tp``) and
the GPipe schedule (``pp_micro``), refused together where JAX's trainer
refuses them, with its messages (:func:`check_parallel_options`). The paper's ablations train,
label, serve and evaluate: ``no_cross_attn`` (no interaction block),
``single_transformer`` (both actors on one 2T-token timeline) and
``causal`` (either attention family), as does the single-person model of
``python -m hig_tpu_torch.train_single`` on the ``t2m`` and ``kit``
datasets (:func:`single_model_config`). ``dropout`` is accepted and
applies no dropout, as in JAX (:class:`ExperimentConfig`).
``compute_dtype: bfloat16``, ``fast_ln`` and ``rms_norm`` train, label,
serve and evaluate (the route rule of ``models/attention.py``).
``pretrained`` with ``only_language`` / ``only_motion`` warm-starts from a
reference checkpoint (``train/torch_port.py``); ``use_native_loader`` takes
the native batch loader, the only reader of ``window_size`` (the Python
loader always windows ``WINDOW_FRAMES`` = 90 frames, as JAX's does).
Caption dropout (``cond_drop_prob``) belongs to the supervised stage and is
refused without ``label_path``, as the JAX loss refuses it.

:func:`load_opt_txt` also reads a JAX run's ``opt.txt``. Its keys without
a field here pick a JAX route or layout whose numbers the port computes
the same way (``use_pallas``, ``fused_blocks``, ``sampler_unroll``,
``is_train``, ``label_model``, ``save_label_dir``, ``multi``) or are the
reference's own extras: they are skipped, as the JAX loader skips unknown
keys. Its ``mesh_data``, ``mesh_model`` and ``mesh_dcn_data`` fill ``mesh``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from os.path import join as pjoin
from typing import Optional

from hig_tpu_torch.models.interaction_model import (
    COMPUTE_DTYPES,
    ModelConfig,
    SingleModelConfig,
)
from hig_tpu_torch.models.text_encoder import ClipTextConfig

CFG_UNDER_PIT = (
    "--cond_drop_prob requires the supervised (label_path) stage: under the PIT "
    "min-assignment loss a dropped sample's two caption assignments become identical, "
    "degenerating the role signal. Train CFG on the final text-conditioned model."
)
SAMPLERS = ("ddpm", "ddim", "dpm")

# JAX's refusals of the model-axis layouts (hig_tpu/train/trainer.py:648-662)
FSDP_WITH_TP = "fsdp and tp both shard the mesh's model axis — enable one"
PP_WITH_FSDP_TP = ("pp_micro stages the layer stack over the mesh's model "
                   "axis — mutually exclusive with fsdp/tp")
PP_NEEDS_EFFICIENT = ("pp_micro requires the efficient interaction stack "
                      "(no --single_transformer / --no_eff)")


@dataclasses.dataclass
class MeshConfig:
    """The (data, model) grid of ranks (``parallel/mesh.py``): ``data`` of -1
    takes every rank the model axis leaves; ``dcn_data`` granules (hosts)
    lay the data axis out host-major."""

    data: int = -1
    model: int = 1
    dcn_data: int = 1


def check_parallel_options(cfg) -> None:
    """JAX's refusals, in JAX's order and words: FSDP with TP, the pipeline
    with either, and the pipeline without the efficient interaction
    stack."""
    if cfg.fsdp and cfg.tp:
        raise ValueError(FSDP_WITH_TP)
    if cfg.pp_micro > 0:
        if cfg.fsdp or cfg.tp:
            raise ValueError(PP_WITH_FSDP_TP)
        if cfg.single_transformer or cfg.no_eff:
            raise ValueError(PP_NEEDS_EFFICIENT)


@dataclasses.dataclass
class ExperimentConfig:
    # identification / paths
    name: str = "test"
    dataset_name: str = "ntu_mul"
    checkpoints_dir: str = "./checkpoints"
    data_root: Optional[str] = None

    # task flags
    cap_id: bool = False
    cap_same: bool = False
    # --pretrained: start from a reference checkpoint; only_language /
    # only_motion load its text stack / its motion denoiser alone
    pretrained: bool = False
    only_language: bool = False
    only_motion: bool = False
    label_path: Optional[str] = None

    # model
    num_layers: int = 8
    latent_dim: int = 512
    ff_size: int = 1024
    num_heads: int = 8
    num_text_layers: int = 4
    text_latent_dim: int = 256
    text_ff_size: int = 2048
    text_num_heads: int = 4
    diffusion_steps: int = 1000
    no_clip: bool = False
    no_eff: bool = False
    no_cross_attn: bool = False
    # accepted and not applied: every JAX path runs deterministically (each
    # apply passes deterministic=True, hig_tpu/train/trainer.py:224,231,236,
    # 240,511,518 and hig_tpu/train/labeling.py:53), where nn.Dropout is the
    # identity (hig_tpu/models/attention.py:572), so a run at any dropout
    # computes what dropout 0 computes
    dropout: float = 0.0
    causal: bool = False
    single_transformer: bool = False

    # optimization
    num_epochs: int = 50
    limit_data_num: int = -1
    lr: float = 2e-4
    batch_size: int = 32
    times: int = 1
    feat_bias: float = 5.0
    grad_clip: float = 0.5
    is_continue: bool = False
    log_every: int = 50
    save_every_e: int = 5
    eval_every_e: int = 5
    save_latest: int = 500
    seed: int = 0
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_decay_steps: int = 0
    ema_decay: float = 0.0
    grad_accum: int = 1
    loss_aware_sampler: bool = False

    # classifier-free guidance: caption dropout in training, the guidance
    # weight w of sampling
    cond_drop_prob: float = 0.0
    guidance_scale: float = 1.0

    # sampling and evaluation: "ddpm" (ancestral), "ddim" or "dpm"
    # (DPM-Solver++(2M)); ddim_steps is the step count of both the ddim and
    # the dpm grids
    which_epoch: str = "latest"
    split_file: str = "test_sub.txt"
    result_path: str = "./result"
    sampler: str = "ddpm"
    ddim_steps: int = 50

    # "float32" | "bfloat16"; fast_ln keeps the efficient blocks' LayerNorm
    # statistics in the compute dtype; rms_norm swaps their LayerNorms for
    # RMSNorms. Trained, labeled, served and evaluated.
    compute_dtype: str = "float32"
    fast_ln: bool = False
    rms_norm: bool = False

    # the native C++ batch loader, and its training window (frames): the
    # Python loader always windows 90 frames, as JAX's does
    use_native_loader: bool = False
    window_size: int = 90

    # the rank grid; distributed: several processes (HIG_* or
    # torch.distributed's coordinator), initialized at the CLI's entry
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    distributed: bool = False
    # the model axis's layout: FSDP shards, tensor-parallel blocks, or the
    # GPipe schedule over pp_micro microbatches (parallel/)
    fsdp: bool = False
    tp: bool = False
    pp_micro: int = 0

    # a torch.profiler trace of steps [5, 10) and a step-latency summary
    profile: bool = False

    # dataset-derived (filled by add_dataset_paths)
    joints_num: int = 22
    dim_pose: int = 263
    max_motion_length: int = 196

    def __post_init__(self):
        if isinstance(self.mesh, dict):
            self.mesh = MeshConfig(**self.mesh)
        check_parallel_options(self)
        if self.cond_drop_prob > 0.0 and self.label_path is None:
            raise ValueError(CFG_UNDER_PIT)
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                             f"got {self.compute_dtype!r}")
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {self.sampler!r}")
        if self.grad_accum < 1 or self.batch_size % self.grad_accum:
            raise ValueError(f"batch_size {self.batch_size} not divisible into "
                             f"{self.grad_accum} grad-accumulation microbatches")

    @property
    def save_root(self) -> str:
        return pjoin(self.checkpoints_dir, self.dataset_name, self.name)

    @property
    def model_dir(self) -> str:
        return pjoin(self.save_root, "model")

    @property
    def meta_dir(self) -> str:
        return pjoin(self.save_root, "meta")

    @property
    def motion_dir(self) -> str:
        return pjoin(self.data_root, "new_joint_vecs")

    @property
    def text_dir(self) -> str:
        return pjoin(self.data_root, "texts")


_DATASET_PRESETS = {
    # the single-person datasets of python -m hig_tpu_torch.train_single
    "t2m": dict(data_root="./data/HumanML3D", joints_num=22, dim_pose=263,
                max_motion_length=196),
    "kit": dict(data_root="./data/KIT-ML", joints_num=21, dim_pose=251,
                max_motion_length=196),
    "ntu_mul": dict(data_root="./data/NTURGBD_multi", joints_num=22, dim_pose=263,
                    max_motion_length=196),
    "synthetic_mul": dict(data_root="./data/synthetic_mul", joints_num=22, dim_pose=263,
                          max_motion_length=196),
}


def add_dataset_paths(cfg: ExperimentConfig) -> ExperimentConfig:
    """Fill the per-dataset constants; an explicit ``data_root`` stays. The
    two-person datasets (``ntu_mul``, ``synthetic_mul``) train the
    interaction model, the single-person ones (``t2m``, ``kit``) the model
    of ``train_single``."""
    preset = _DATASET_PRESETS.get(cfg.dataset_name)
    if preset is None:
        raise KeyError(f"dataset not recognized by the port: {cfg.dataset_name} "
                       f"(one of {sorted(_DATASET_PRESETS)})")
    for k, v in preset.items():
        if k == "data_root" and cfg.data_root:
            continue
        setattr(cfg, k, v)
    return cfg


def model_config(cfg: ExperimentConfig, clip: ClipTextConfig | None = None) -> ModelConfig:
    """The model the run trains; ``clip`` defaults to the ViT-B/32 tower."""
    return ModelConfig(
        input_feats=cfg.dim_pose, num_frames=cfg.max_motion_length,
        latent_dim=cfg.latent_dim, ff_size=cfg.ff_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, text_latent_dim=cfg.text_latent_dim,
        text_ff_size=cfg.text_ff_size, text_num_heads=cfg.text_num_heads,
        num_text_layers=cfg.num_text_layers, clip=clip or ClipTextConfig(),
        efficient=not cfg.no_eff, causal=cfg.causal, dropout=cfg.dropout,
        cap_id=cfg.cap_id, cond_drop_prob=cfg.cond_drop_prob,
        compute_dtype=cfg.compute_dtype, fast_ln=cfg.fast_ln, rms_norm=cfg.rms_norm,
        interaction=not cfg.no_cross_attn, single_transformer=cfg.single_transformer,
    )


def single_model_config(cfg: ExperimentConfig,
                        clip: ClipTextConfig | None = None) -> SingleModelConfig:
    """The single-person model of ``train_single``: the fields that
    ``tools/train_single.py`` hands ``SingleMotionModel`` (the widths,
    ``no_eff`` and the compute dtype); the pair model's options are not
    read, as there."""
    return SingleModelConfig(
        input_feats=cfg.dim_pose, num_frames=cfg.max_motion_length,
        latent_dim=cfg.latent_dim, ff_size=cfg.ff_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, text_latent_dim=cfg.text_latent_dim,
        text_ff_size=cfg.text_ff_size, text_num_heads=cfg.text_num_heads,
        num_text_layers=cfg.num_text_layers, clip=clip or ClipTextConfig(),
        efficient=not cfg.no_eff, dropout=cfg.dropout, compute_dtype=cfg.compute_dtype,
    )


_HEADER = "------------ Options -------------"
_FOOTER = "-------------- End ----------------"


def _flatten(cfg: ExperimentConfig) -> dict:
    d = dataclasses.asdict(cfg)
    mesh = d.pop("mesh")
    d.update(mesh_data=mesh["data"], mesh_model=mesh["model"], mesh_dcn_data=mesh["dcn_data"])
    return d


def save_opt_txt(cfg: ExperimentConfig, path: str) -> None:
    """The reference's ``key: value`` opt.txt (the mesh as JAX writes it,
    ``mesh_data``, ``mesh_model``, ``mesh_dcn_data``)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(_HEADER + "\n")
        for k, v in sorted(_flatten(cfg).items()):
            f.write(f"{k}: {v}\n")
        f.write(_FOOTER + "\n")


def load_opt_txt(path: str, **overrides) -> ExperimentConfig:
    """The configuration a run's ``opt.txt`` (the port's :func:`save_opt_txt`
    or the JAX package's) holds, with ``overrides``; keys without a field
    here (the JAX route keys and the reference's extras) are skipped."""
    fields = {f.name: f.type for f in dataclasses.fields(ExperimentConfig)}
    kwargs, mesh = {}, {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line in (_HEADER, _FOOTER):
                continue
            key, _, value = line.partition(": ")
            if key in ("mesh_data", "mesh_model", "mesh_dcn_data"):
                mesh[key[len("mesh_"):]] = int(value)
                continue
            ftype = fields.get(key)
            if ftype is None or key == "mesh":
                continue
            if value == "None":
                kwargs[key] = None
            elif ftype in ("bool", bool):
                kwargs[key] = value == "True"
            elif ftype in ("int", int):
                kwargs[key] = int(float(value))
            elif ftype in ("float", float):
                kwargs[key] = float(value)
            else:
                kwargs[key] = value
    kwargs["mesh"] = MeshConfig(**mesh)
    kwargs.update(overrides)
    return add_dataset_paths(ExperimentConfig(**kwargs))


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Every field as a --flag (bools as --flag/--no-flag pairs), the mesh
    as JAX's --mesh_data, --mesh_model and --mesh_dcn_data."""
    for f in dataclasses.fields(ExperimentConfig):
        if f.name == "mesh":
            parser.add_argument("--mesh_data", type=int, default=-1)
            parser.add_argument("--mesh_model", type=int, default=1)
            parser.add_argument("--mesh_dcn_data", type=int, default=1)
        elif f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif f.type in ("int", int):
            parser.add_argument(f"--{f.name}", type=int, default=f.default)
        elif f.type in ("float", float):
            parser.add_argument(f"--{f.name}", type=float, default=f.default)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=f.default)


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    kwargs = {f.name: getattr(args, f.name) for f in dataclasses.fields(ExperimentConfig)
              if f.name != "mesh"}
    kwargs["mesh"] = MeshConfig(args.mesh_data, args.mesh_model, args.mesh_dcn_data)
    return add_dataset_paths(ExperimentConfig(**kwargs))
