"""Sample a two-person motion from captions and draw it (counterpart of
``tools/visualization.py``).

Pair mode: the run of ``--opt_path`` (its checkpoint ``model/<which_epoch>.pt``
and its feature statistics ``meta/``) through ``serve``'s ``build_model``,
``load_stats`` and ``conditioning_for`` and the sampler users get
(``make_sampler``: on the card one CUDA graph per shape; an efficient
model's blocks through the fused-block kernel, as ``serve --blocks fused``,
but an rms_norm model's through the projected-attention kernel). The
captions are ``--class_id``'s canonical pair, or ``--caption1`` and
``--caption2`` (default: class 2's); a caption-id (``--cap_id``) run takes
their ids in the NTU caption table. The sample is de-normalized, its init
row rolled last and decoded by ``recover_from_ric2`` (``serve.decode``)
into world-frame joints (2, T, 22, 3), written to
``<result_path>/sample_c<class_id or x>_s<seed>.npy``.

``--single``: the single-person run of ``--opt_path``
(``python -m hig_tpu_torch.train_single``) through ``make_single_sampler``
on ``--caption1`` (default "a person walks forward"); the frame rows are
de-normalized by the single-person statistics (the first dim_pose entries
of D + 3, the init row's 3 left out) and decoded by ``recover_from_ric``
into ``single_s<seed>.npy`` (T, J, 3).

``--gif`` (the default) also draws the motion (``viz/plot.py``), which
needs matplotlib; without it the call raises before sampling, naming
``--no-gif``. Runs on the card unless ``--device cpu``.

    python -m hig_tpu_torch.visualize --opt_path checkpoints/ntu_mul/x/opt.txt \\
        --class_id 3 --motion_length 90 --no-gif
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import SAMPLERS, load_opt_txt, model_config, single_model_config
from hig_tpu_torch.data.vocab import CLASSID2CAPS
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.interaction_model import SingleMotionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.serve import build_model, conditioning_for, decode, load_stats
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train.trainer import eval_params, make_sampler, make_single_sampler
from hig_tpu_torch.utils.kinematics import T2M_KINEMATIC_CHAIN
from hig_tpu_torch.utils.motion_codec import recover_from_ric

SINGLE_CAPTION = "a person walks forward"


def require_matplotlib() -> None:
    """Raise, naming ``--no-gif``, where matplotlib cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"--gif needs matplotlib ({e}); pass --no-gif to write the "
                           "joints alone") from e


def run_config(args):
    """The run's ExperimentConfig with the sampler options' overrides."""
    cfg = load_opt_txt(args.opt_path)
    overrides = {k: v for k, v in (("sampler", args.sampler), ("ddim_steps", args.ddim_steps),
                                   ("guidance_scale", args.guidance_scale)) if v is not None}
    return dataclasses.replace(cfg, **overrides)


def sample_pair(args, device, clip: ClipTextConfig | None = None) -> dict:
    """Pair mode; returns the joints (2, T, 22, 3), the captions and the
    sampling call's wall seconds."""
    cfg = run_config(args)
    if args.class_id is not None:
        caption1, caption2 = CLASSID2CAPS[args.class_id]
    else:
        caption1 = args.caption1 or CLASSID2CAPS[2][0]
        caption2 = args.caption2 or CLASSID2CAPS[2][1]
    mcfg = model_config(cfg, clip)
    mcfg = dataclasses.replace(mcfg, fused_blocks=mcfg.efficient and not mcfg.rms_norm)
    model = build_model(mcfg, device, pjoin(cfg.model_dir, f"{args.which_epoch}.pt"))
    mean, std = load_stats(cfg.meta_dir, mcfg.input_feats)
    T = args.motion_length + 1  # + init token
    sample = make_sampler(model, g.make_schedule(g.linear_betas(cfg.diffusion_steps)), T=T,
                          dim_pose=mcfg.input_feats, sampler=cfg.sampler,
                          ddim_steps=cfg.ddim_steps, guidance_scale=cfg.guidance_scale)
    cond = conditioning_for([{"caption1": caption1, "caption2": caption2}], cfg.cap_id)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out = sample(torch.from_numpy(cond), torch.tensor([T]), generator=generator)
    _, joints = decode(out, mean, std)
    joints = joints[0].cpu().numpy()
    return {"joints": joints, "captions": (caption1, caption2),
            "seconds": time.perf_counter() - t0, "sample": sample}


def sample_single(args, device, clip: ClipTextConfig | None = None) -> dict:
    """``--single``; returns the joints (T, J, 3), the caption and the
    sampling call's wall seconds."""
    cfg = run_config(args)
    caption = args.caption1 or SINGLE_CAPTION
    mcfg = single_model_config(cfg, clip)
    model = SingleMotionModel(mcfg)
    model.load_state_dict(eval_params(ckpt.load(pjoin(cfg.model_dir, f"{args.which_epoch}.pt"))))
    model.to(device).eval()
    # the frame rows' statistics: the first dim_pose of dim_pose + 3 (the
    # init row's 3 last)
    mean, std = (np.load(pjoin(cfg.meta_dir, f"{k}.npy"))[: cfg.dim_pose] for k in ("mean", "std"))
    T = args.motion_length + 1  # + the trailing init row
    sample = make_single_sampler(model, g.make_schedule(g.linear_betas(cfg.diffusion_steps)),
                                 T=T, dim_pose=cfg.dim_pose, sampler=cfg.sampler,
                                 ddim_steps=cfg.ddim_steps)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out = sample(torch.from_numpy(tokenize([caption]).astype(np.int64)), torch.tensor([T]),
                 generator=generator)[0]
    frames = out[:-1] * torch.as_tensor(std, device=device) + torch.as_tensor(mean, device=device)
    joints = recover_from_ric(frames, cfg.joints_num).cpu().numpy()
    return {"joints": joints, "captions": (caption,), "seconds": time.perf_counter() - t0,
            "sample": sample}


def main(argv=None, clip_config: ClipTextConfig | None = None) -> dict:
    """Parse ``argv``, sample, write the joints (and the GIF) and return
    what :func:`sample_pair` or :func:`sample_single` returned, with the
    joints' path. ``clip_config`` (no flag) shrinks the CLIP tower for
    tests, as ``train``'s; the CLI's tower is ViT-B/32."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--opt_path", type=str, required=True)
    parser.add_argument("--which_epoch", type=str, default="latest")
    parser.add_argument("--caption1", type=str, default=None)
    parser.add_argument("--caption2", type=str, default=None)
    parser.add_argument("--class_id", type=int, default=None,
                        help="use the canonical captions of this NTU class")
    parser.add_argument("--motion_length", type=int, default=60)
    parser.add_argument("--result_path", type=str, default="./result")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gif", action="store_true", default=True)
    parser.add_argument("--no-gif", dest="gif", action="store_false")
    parser.add_argument("--single", action="store_true", help="a single-person run")
    parser.add_argument("--sampler", choices=SAMPLERS, default=None,
                        help="default: the run's")
    parser.add_argument("--guidance_scale", type=float, default=None,
                        help="classifier-free guidance weight (a --cond_drop_prob run)")
    parser.add_argument("--ddim_steps", type=int, default=None,
                        help="default: the run's")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.gif:
        require_matplotlib()
    device = resolve_device(args.device)
    try:
        made = (sample_single if args.single else sample_pair)(args, device, clip_config)
    except ValueError as e:
        parser.error(str(e))
    os.makedirs(args.result_path, exist_ok=True)
    tag = "x" if args.class_id is None else args.class_id
    stem = pjoin(args.result_path, f"single_s{args.seed}" if args.single
                 else f"sample_c{tag}_s{args.seed}")
    np.save(stem + ".npy", made["joints"])
    made["path"] = stem + ".npy"
    print(f"captions: {made['captions']}\nwrote {stem}.npy {made['joints'].shape} "
          f"(sampling {made['seconds']:.2f}s on {device})")
    if args.gif:
        from hig_tpu_torch.viz import plot

        if args.single:
            plot.plot_3d_motion(stem + ".gif", T2M_KINEMATIC_CHAIN, made["joints"],
                                title=made["captions"][0])
        else:
            plot.plot_3d_motion2(stem + ".gif", T2M_KINEMATIC_CHAIN, made["joints"][0],
                                 made["joints"][1], title=made["captions"][0])
        print(f"wrote {stem}.gif")
    return made


if __name__ == "__main__":
    main()
