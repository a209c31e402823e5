"""One-command parity rehearsal against the reference's torch checkpoint
(counterpart of ``tools/parity_smoke.py``).

Given the reference's checkpoint (latest.tar), its meta mean/std and, when
present, the CLIP BPE vocab:

  1. converts the state dict (``train/torch_port.py``) into the port's
     model and reports the conversion coverage: the leaves that came from
     the checkpoint, out of the model's (every other leaf keeps its seeded
     value);
  2. runs the model once at t = 500 on a fixed input (N(0, 1) motion from
     np seed 1234, the class's two captions) and prints the output's
     statistics, the number to diff against the same probe run inside the
     reference;
  3. samples a motion pair from those captions (seeded), decodes it to
     world joints and writes <out>/parity_sample.npy;
  4. with --reference_output (a reference-generated .npy of the same
     captions), prints the per-joint trajectory error.

    python -m hig_tpu_torch.parity_smoke --checkpoint latest.tar --mean mean.npy \\
        --std std.npy [--sampler ddim] [--reference_output ref.npy] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.data.vocab import CLASSID2CAPS
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import ClipBPETokenizer, default_tokenizer, tokenize
from hig_tpu_torch.train import torch_port
from hig_tpu_torch.train.trainer import make_sampler
from hig_tpu_torch.utils.motion_codec import recover_from_ric2
from hig_tpu_torch.weights import flatten, flax_param_shapes, load_flax_tree, random_flax_tree

PROBE_SEED, PROBE_T = 1234, 500


def probe_stats(out: np.ndarray) -> str:
    """The probe line's statistics, in ``tools/parity_smoke.py``'s format."""
    return (f"mean={out.mean():.6f} std={out.std():.6f} "
            f"absmax={np.abs(out).max():.6f}")


def load_model(checkpoint: str, cfg: ModelConfig, device, init_params: dict | None = None,
               seed: int = 0) -> tuple[InteractionModel, int, int]:
    """The model of ``cfg`` in eval mode on ``device``: the checkpoint's
    converted leaves over ``init_params`` (a flax tree; default the seeded
    random tree). Returns (model, leaves from the checkpoint, the model's
    leaves)."""
    sd = torch_port.load_torch_state_dict(checkpoint)
    print(f"loaded {len(sd)} tensors from {checkpoint}")
    converted = torch_port.convert_interaction_model(
        sd, num_layers=cfg.num_layers, num_text_layers=cfg.num_text_layers,
        clip_layers=cfg.clip.layers)
    model = InteractionModel(cfg)
    load_flax_tree(model, init_params if init_params is not None
                   else random_flax_tree(cfg, seed)["params"])
    torch_port.load_into(model, converted)
    return (model.to(device).eval(), len(flatten(converted)),
            len(flatten(flax_param_shapes(cfg))))


def probe_inputs(class_id: int, T: int, device) -> tuple:
    """The probe's (x, t, lengths, tokens): N(0, 1) motion from np seed
    PROBE_SEED and the class's two captions, at t = PROBE_T."""
    c1, c2 = CLASSID2CAPS[class_id]
    tokens = torch.from_numpy(np.stack([tokenize(c1)[0], tokenize(c2)[0]])[None]).to(device)
    xp = np.random.RandomState(PROBE_SEED).randn(1, 2, T, 263).astype(np.float32)
    return (torch.from_numpy(xp).to(device), torch.full((1,), PROBE_T, device=device),
            torch.full((1,), T, device=device), tokens)


@torch.no_grad()
def probe(model: InteractionModel, class_id: int, T: int) -> np.ndarray:
    """The model's output on the probe (:func:`probe_inputs`)."""
    device = next(model.parameters()).device
    return model(*probe_inputs(class_id, T, device)).cpu().numpy()


def parity_config(num_layers: int = 8, latent_dim: int = 512, num_text_layers: int = 4,
                  clip_config: ClipTextConfig | None = None) -> ModelConfig:
    """The model of the flags (``tools/parity_smoke.py``'s: its widths, the
    rest the flagship's)."""
    return ModelConfig(num_layers=num_layers, latent_dim=latent_dim,
                       num_text_layers=num_text_layers, clip=clip_config or ClipTextConfig())


def main(argv=None, clip_config: ClipTextConfig | None = None,
         init_params: dict | None = None) -> dict:
    """Parse ``argv`` and run the rehearsal; returns the probe output, the
    coverage, the written sample's path, the sampler's graphs and the
    model. ``clip_config`` (no flag)
    shrinks the CLIP tower for tests; ``init_params`` (no flag) is the flax
    tree the leaves the checkpoint leaves uncovered start from, instead of
    the seeded random tree."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="reference latest.tar (torch)")
    parser.add_argument("--mean", type=str, required=True, help="meta mean.npy")
    parser.add_argument("--std", type=str, required=True, help="meta std.npy")
    parser.add_argument("--num_layers", type=int, default=8)
    parser.add_argument("--num_text_layers", type=int, default=4)
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--class_id", type=int, default=2)
    parser.add_argument("--motion_length", type=int, default=60)
    parser.add_argument("--sampler", type=str, default="ddpm", choices=["ddpm", "ddim"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="./result/parity")
    parser.add_argument("--reference_output", type=str, default=None,
                        help="npy of reference-generated joints to diff against")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    bpe = isinstance(default_tokenizer(), ClipBPETokenizer)
    print("tokenizer: " + ("CLIP BPE" if bpe else "hash fallback (BPE asset absent — "
                                                   "conditioning will NOT match the reference)"))

    # 1. conversion
    cfg = parity_config(args.num_layers, args.latent_dim, args.num_text_layers, clip_config)
    model, n_conv, n_leaves = load_model(args.checkpoint, cfg, device, init_params, args.seed)
    print(f"conversion coverage: {n_conv}/{n_leaves} leaves from the checkpoint")

    # 2. fixed-probe activation statistics
    T = args.motion_length + 1
    out = probe(model, args.class_id, T)
    print(f"probe eps(t={PROBE_T}): {probe_stats(out)}")
    print("  (reference probe: feed the same N(0,1) motion [np seed 1234] and "
          "captions through MotionInteractionTransformer at t=500 and compare)")

    # 3. sample + decode
    mean, std = np.load(args.mean), np.load(args.std)
    sched = g.make_schedule(g.linear_betas(1000))
    sample_fn = make_sampler(model, sched, T=T, dim_pose=263, sampler=args.sampler)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    _, _, lengths, tokens = probe_inputs(args.class_id, T, device)
    gen = sample_fn(tokens, lengths, generator=generator)[0].cpu().numpy()
    denorm = gen.copy()
    denorm[:, 1:] = gen[:, 1:] * std[:-4] + mean[:-4]
    denorm[:, 0, :4] = gen[:, 0, :4] * std[-4:] + mean[-4:]
    rolled = torch.from_numpy(np.concatenate([denorm[:, 1:], denorm[:, :1]], axis=1))
    j1, j2 = recover_from_ric2(rolled[0], rolled[1], 22, init_last=True)
    joints = torch.stack([j1, j2]).numpy()
    os.makedirs(args.out, exist_ok=True)
    c1, c2 = CLASSID2CAPS[args.class_id]
    out_path = pjoin(args.out, "parity_sample.npy")
    np.save(out_path, joints)
    print(f"wrote {out_path} {joints.shape} "
          f"(captions: {c1!r} / {c2!r}, {args.sampler}, seed {args.seed})")

    # 4. diff against reference output
    if args.reference_output:
        ref = np.load(args.reference_output)
        Tm = min(ref.shape[1], joints.shape[1])
        d = np.linalg.norm(ref[:, :Tm] - joints[:, :Tm], axis=-1)  # (2, T, 22)
        print(f"vs {args.reference_output}: mean joint err {d.mean():.4f} m, "
              f"max {d.max():.4f} m")
        print("NOTE: DDPM draws are seed-path dependent; distributional parity "
              "(python -m hig_tpu_torch.evaluate) is the meaningful comparison — "
              "this diff is a sanity bound, not a bit-match.")
    return {"probe": out, "coverage": (n_conv, n_leaves), "sample": out_path,
            "graphs": sample_fn.graphs, "model": model}


if __name__ == "__main__":
    main()
