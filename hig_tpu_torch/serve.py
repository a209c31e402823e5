"""Batch serving: caption-pair requests → sampled motions (counterpart of
``tools/serve.py``).

Request file: one JSON object per line,
  {"caption1": "...", "caption2": "...", "length": 60, "id": "req0"}
(id and length optional; length defaults to --motion_length).

Outputs per request: <out_dir>/<id>.npz with features (2, L+1, 263) and
joints (2, L, 22, 3); plus index.json.

Weights come from --params, either a checkpoint of the port's trainer
(``<run>/model/latest.pt``; its EMA parameters when the run kept them) or a
flattened JAX parameter tree saved with np.savez under
"params/denoiser/layer_0/..." keys (its ``ema_params/`` when present), or
from --random_init SEED (seeded random weights, every leaf nonzero). A
trained run's feature statistics are in ``<run>/meta`` (--stats). The
model comes from --opt_path, a training run's opt.txt (its widths,
--cap_id, --cond_drop_prob, --no_eff, --causal, --compute_dtype, --fast_ln,
--rms_norm, --diffusion_steps, and
its --sampler and --ddim_steps as the defaults of these options; --params
and --stats then default to the run's model/<--which_epoch>.pt, by default
model/latest.pt, and meta/),
or from --model_config (a JSON object of ModelConfig fields, which may set
compute_dtype "bfloat16", fast_ln and rms_norm, and "clip" the CLIP tower's
ClipTextConfig fields), default the flagship. A
bfloat16 model samples through the kernels' bfloat16 forms. A caption-id
(--cap_id) model takes each request's captions as their ids in the NTU
caption table. --guidance_scale w ≠ 1 samples with classifier-free
guidance, for a model trained with --cond_drop_prob > 0 (default: the
run's guidance_scale with --opt_path, else 1). --blocks fused (the
default) runs the efficient self-attention and interaction blocks through
the fused-block kernel, --blocks projected through the projected-attention
kernel (the default of an rms_norm model, which has no fused block).
--no_eff serves the quadratic (softmax-attention) model instead, whose
self-attention and interaction blocks go through the flash-attention
kernel. --blocks has no effect with --no_eff and is refused there.
--causal makes either model's attention causal; a causal efficient model's
self-attention and interaction blocks take the causal core in plain
PyTorch whatever --blocks says, as JAX's blocks take their einsum route. The paper's ablations (or a run's opt.txt
with them): --no_cross_attn serves a model without the interaction block
(--blocks fused: B1 runs the self-attention blocks only), and
--single_transformer one that puts both actors on one 2T-token timeline,
whose layers never fuse: there --blocks fused runs the self-attention
through the projected-attention kernel, as JAX's layers do, and the
printout says so. --sampler picks DDPM (every timestep of the
schedule), DDIM or DPM-Solver++(2M) over --ddim_steps (default without
--opt_path: DDIM-50). --fit_smpl fits SMPL bodies to each result's joints
(``smpl/smplify.py``: 30 iterations, the camera stage 10 times as many,
from a zero pose and shape; --smpl_model SMPL_NEUTRAL.pkl or an .npz
export, --gmm gmm_08.pkl, else the synthetic model and prior) and writes
<id>_smpl.npz (pose, betas, cam_t) beside each result, under "smpl" in
index.json.

    python -m hig_tpu_torch.serve --requests reqs.jsonl --random_init 0
    python -m hig_tpu_torch.serve --requests reqs.jsonl --random_init 0 --no_eff
    python -m hig_tpu_torch.serve --requests reqs.jsonl \
        --opt_path checkpoints/ntu_mul/interaction/opt.txt --guidance_scale 2.5

Several ranks (one process each, started with the ``HIG_*`` variables as
``python -m hig_tpu_torch.train --distributed`` is; the mesh is (data,
model), data × model = the processes, the model axis --mesh_model or the
--opt_path run's): each data rank samples its contiguous slice of each
chunk (padded with its last request to a multiple of the data axis), from
x_T drawn for the whole chunk, padded alike and sliced (and DDPM's step
noise alike), so the motion is a one-rank call's; the primary gathers the slices,
decodes and writes. --tp runs the blocks tensor-parallel on the model axis
(each rank its heads; B2 on them, never B1); without it the model axis's
ranks repeat their data row's work. Over several ranks the sampler runs
eagerly (no CUDA graph).

    HIG_COORDINATOR=localhost:29500 HIG_NUM_PROCESSES=2 HIG_PROCESS_ID=<r> \
        python -m hig_tpu_torch.serve --requests reqs.jsonl --random_init 0 \
        [--tp --mesh_model 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import SAMPLERS, MeshConfig, load_opt_txt, model_config
from hig_tpu_torch.data.vocab import CAP2KEY
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.parallel.mesh import make_mesh, place_tp, shard_batch
from hig_tpu_torch.smpl.fit import joint_confidences, load_assets
from hig_tpu_torch.smpl.smplify import SMPLify3D
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train.trainer import eval_params, make_sampler
from hig_tpu_torch.utils.motion_codec import recover_from_ric2
from hig_tpu_torch.weights import load_flax_tree, load_npz, random_flax_tree

JOINTS_NUM = 22


def load_requests(path: str, motion_length: int) -> list[dict]:
    requests = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            req = json.loads(line)
            req.setdefault("id", f"req{i}")
            req.setdefault("length", motion_length)
            requests.append(req)
    return requests


def load_stats(stats_dir: str | None, dim_pose: int):
    """mean/std (dim_pose + 4,) from <stats_dir>/{mean,std}.npy, else
    identity."""
    if stats_dir is None:
        return np.zeros(dim_pose + 4, np.float32), np.ones(dim_pose + 4, np.float32)
    mean = np.load(os.path.join(stats_dir, "mean.npy")).astype(np.float32)
    std = np.load(os.path.join(stats_dir, "std.npy")).astype(np.float32)
    return mean, std


def build_model(cfg: ModelConfig, device, params: str | None = None,
                random_init: int | None = None) -> InteractionModel:
    """The model on ``device`` in eval mode, with weights from a trainer
    checkpoint (``.pt``), a JAX tree file (``.npz``) or a seed."""
    if (params is None) == (random_init is None):
        raise ValueError("give exactly one of params and random_init")
    model = InteractionModel(cfg)
    if params is not None and params.endswith(".pt"):
        model.load_state_dict(eval_params(ckpt.load(params)), strict=True)
    elif params is not None:
        tree = load_npz(params)
        if "params" not in tree:
            raise ValueError(f"{params}: expected keys under params/ (and maybe ema_params/)")
        load_flax_tree(model, eval_params(tree))
    else:
        load_flax_tree(model, random_flax_tree(cfg, random_init)["params"])
    return model.to(device).eval()


def conditioning_for(requests: list[dict], cap_id: bool = False) -> np.ndarray:
    """(B, 2, 77) caption-pair token ids or, for a caption-id model, (B, 2)
    caption ids."""
    if cap_id:
        return np.asarray([[CAP2KEY[r["caption1"]], CAP2KEY[r["caption2"]]]
                           for r in requests], np.int64)
    return np.stack([
        np.stack([tokenize(r["caption1"])[0], tokenize(r["caption2"])[0]])
        for r in requests
    ]).astype(np.int64)


def decode(out: torch.Tensor, mean: np.ndarray, std: np.ndarray):
    """Sampled (B, 2, T, F) → (de-normalized features, joints (B, 2, T-1, J, 3))."""
    mean = torch.as_tensor(mean, device=out.device)
    std = torch.as_tensor(std, device=out.device)
    frames = out[:, :, 1:] * std[:-4] + mean[:-4]
    init = out[:, :, :1, :4] * std[-4:] + mean[-4:]
    denorm = torch.cat([torch.cat([init, out[:, :, :1, 4:]], dim=-1), frames], dim=2)
    rolled = torch.cat([denorm[:, :, 1:], denorm[:, :, :1]], dim=2)
    j1, j2 = recover_from_ric2(rolled[:, 0], rolled[:, 1], JOINTS_NUM, init_last=True)
    return denorm, torch.stack([j1, j2], dim=1)


def serve_batch(sample_fn, requests: list[dict], mean, std, device, generator=None,
                cap_id: bool = False, mesh=None, shape=None, ddpm: bool = False,
                noise: np.ndarray | None = None):
    """Sample and decode one batch; returns (features, joints) on the host.
    ``noise``: the batch's x_T (else drawn from ``generator``).
    With a ``mesh`` of several data ranks (``shape``: one sample's (2, T,
    F); ``ddpm``: the sampler draws step noise) each rank samples its rows
    of the batch, padded with its last request to a multiple of the data
    axis, from the draws of a one-rank call padded alike, and the slices
    are gathered; None is returned on every rank but the primary, which
    decodes. One data rank keeps its own call: its sampler may be a CUDA
    graph, which draws x_T and the step noise from ``generator`` inside
    the graph, while a data rank's slices of the padded batch's draws are
    cut outside the sampler and handed in (``step_noise``), which only the
    eager loop takes."""
    cond = conditioning_for(requests, cap_id)
    lengths = np.asarray([r["length"] + 1 for r in requests], np.int64)
    x_t = None if noise is None else torch.from_numpy(np.asarray(noise, np.float32)).to(device)
    if mesh is None or mesh.shape["data"] == 1:
        out = sample_fn(torch.from_numpy(cond).to(device),
                        torch.from_numpy(lengths).to(device), noise=x_t, generator=generator)
    else:
        d, i, n = mesh.shape["data"], mesh.data_index, len(requests)
        pad = (-n) % d
        cond = np.concatenate([cond, cond[-1:].repeat(pad, 0)])
        lengths = np.concatenate([lengths, lengths[-1:].repeat(pad, 0)])

        def draw(z=None):  # the unpadded batch's draw (a one-rank call's), padded alike
            if z is None:
                z = torch.randn((n, *shape), generator=generator, device=device)
            return shard_batch(torch.cat([z, z[-1:].expand(pad, *shape)]), i, d)

        step_noise = (lambda _: draw()) if ddpm else None
        local = sample_fn(torch.from_numpy(shard_batch(cond, i, d)).to(device),
                          torch.from_numpy(shard_batch(lengths, i, d)).to(device),
                          noise=draw(x_t), step_noise=step_noise)
        out = dist.all_gather(local, 0, mesh.data_group)[:n]
    if not dist.is_primary():
        return None
    denorm, joints = decode(out, mean, std)
    return denorm.cpu().numpy(), joints.cpu().numpy()


def write_results(out_dir: str, requests: list[dict], features, joints, index: list):
    for i, req in enumerate(requests):
        L = req["length"]
        path = os.path.join(out_dir, f"{req['id']}.npz")
        np.savez(path, features=features[i, :, : L + 1], joints=joints[i, :, :L])
        index.append({"id": req["id"], "path": path, "length": L})


FIT_SMPL_ITERS = 30  # the body stage's L-BFGS iterations (the camera stage 10 times as many)


def fit_smpl(index: list, smpl_model: str | None, gmm: str | None, device) -> list:
    """SMPLify3D on each result's joints (2, L, 22, 3), every frame of both
    actors in one batch from a zero pose and shape; writes
    <id>_smpl.npz beside the result and adds its path to the entry under
    "smpl". Returns each fit's result."""
    model, prior = load_assets(smpl_model, gmm, device)
    fitter = SMPLify3D(model=model, prior=prior, num_iters=FIT_SMPL_ITERS)
    conf = joint_confidences(device)
    results = []
    for entry in index:
        joints = np.load(entry["path"])["joints"]
        N = joints.shape[0] * joints.shape[1]
        j3d = torch.from_numpy(np.asarray(joints.reshape(N, 22, 3), np.float32)).to(device)
        t0 = time.time()
        result = fitter(torch.zeros((N, 72), device=device), torch.zeros((N, 10), device=device),
                        j3d, conf)
        path = entry["path"].replace(".npz", "_smpl.npz")
        np.savez(path, pose=result.pose.cpu().numpy(), betas=result.betas.cpu().numpy(),
                 cam_t=result.camera_translation.cpu().numpy())
        entry["smpl"] = path
        print(f"fit SMPL to {entry['id']}: {N} frames in {time.time() - t0:.2f}s, "
              f"{result.camera_info.evaluations + result.body_info.evaluations} evaluations, "
              f"final loss {float(result.final_loss):.1f}")
        results.append(result)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--requests", required=True, help="jsonl of caption-pair requests")
    parser.add_argument("--out_dir", default="./result/serve")
    parser.add_argument("--params", default=None,
                        help="a trainer checkpoint (.pt) or an npz of a flattened JAX param tree")
    parser.add_argument("--random_init", type=int, default=None,
                        help="seed of random weights (instead of --params)")
    parser.add_argument("--opt_path", default=None,
                        help="a training run's opt.txt: the model to serve")
    parser.add_argument("--which_epoch", default="latest",
                        help="checkpoint under the --opt_path run's model/ (latest, "
                             "ckpt_e004, ...)")
    parser.add_argument("--model_config", default=None,
                        help="JSON file of ModelConfig fields (default: flagship)")
    parser.add_argument("--guidance_scale", type=float, default=None,
                        help="classifier-free guidance weight w (1: none)")
    parser.add_argument("--stats", default=None, help="directory with mean.npy and std.npy")
    parser.add_argument("--blocks", choices=("fused", "projected"), default=None,
                        help="kernel of the efficient blocks (default fused)")
    parser.add_argument("--no_eff", action="store_true",
                        help="quadratic (softmax) attention blocks")
    parser.add_argument("--causal", action="store_true", help="causal attention")
    parser.add_argument("--no_cross_attn", action="store_true",
                        help="no cross-actor interaction block")
    parser.add_argument("--single_transformer", action="store_true",
                        help="both actors on one 2T-token timeline")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--motion_length", type=int, default=60)
    parser.add_argument("--sampler", choices=SAMPLERS, default=None,
                        help="default: the run's with --opt_path, else ddim")
    parser.add_argument("--ddim_steps", type=int, default=None,
                        help="steps of the ddim and dpm grids (default: the run's with "
                             "--opt_path, else 50)")
    parser.add_argument("--diffusion_steps", type=int, default=None,
                        help="default: the run's with --opt_path, else 1000")
    parser.add_argument("--seed", type=int, default=0, help="seed of the initial noise")
    parser.add_argument("--noise", default=None,
                        help="an .npy of the requests' x_T (N, 2, T, F), T the longest "
                             "length + 1 (default: drawn from --seed)")
    parser.add_argument("--fit_smpl", action="store_true",
                        help="fit SMPL bodies to each result's joints")
    parser.add_argument("--smpl_model", default=None,
                        help="SMPL_NEUTRAL.pkl or .npz (--fit_smpl); the synthetic model "
                             "if absent")
    parser.add_argument("--gmm", default=None,
                        help="gmm_08.pkl (--fit_smpl); the synthetic prior if absent")
    parser.add_argument("--tp", action="store_true",
                        help="serve with tensor-parallel (Megatron-sharded) weights on the "
                             "mesh's model axis")
    parser.add_argument("--mesh_model", type=int, default=0,
                        help="override the mesh's model-axis size (with --tp)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.which_epoch != "latest" and (not args.opt_path or args.params
                                         or args.random_init is not None):
        parser.error("--which_epoch picks a checkpoint of the --opt_path run; --params and "
                     "--random_init give the weights themselves")
    cfg_fields, guidance, steps = {}, 1.0, 1000
    sampler, ddim_steps = "ddim", 50
    mesh_cfg = MeshConfig()
    if args.opt_path:
        if args.model_config or args.no_eff or args.causal or args.no_cross_attn \
                or args.single_transformer:
            parser.error("--opt_path gives the model; --model_config, --no_eff, --causal, "
                         "--no_cross_attn and --single_transformer are refused with it")
        run = load_opt_txt(args.opt_path)
        mesh_cfg = run.mesh
        cfg_fields = dataclasses.asdict(model_config(run))
        guidance, steps = run.guidance_scale, run.diffusion_steps
        sampler, ddim_steps = run.sampler, run.ddim_steps
        if args.params is None and args.random_init is None:
            args.params = os.path.join(run.model_dir, f"{args.which_epoch}.pt")
        args.stats = args.stats or run.meta_dir
    elif args.model_config:
        with open(args.model_config) as f:
            cfg_fields = json.load(f)
    if args.guidance_scale is not None:
        guidance = args.guidance_scale
    if args.no_eff:
        cfg_fields["efficient"] = False
    if args.causal:
        cfg_fields["causal"] = True
    if args.no_cross_attn:
        cfg_fields["interaction"] = False
    if args.single_transformer:
        cfg_fields["single_transformer"] = True
    efficient = cfg_fields.get("efficient", True)
    if not efficient and args.blocks is not None:
        parser.error("--blocks picks the kernel of the efficient blocks; the quadratic "
                     "(--no_eff) model has none to pick")
    # an RMSNorm model has no fused block (its kernel computes LayerNorm)
    default_blocks = "projected" if cfg_fields.get("rms_norm") else "fused"
    cfg_fields["fused_blocks"] = efficient and (args.blocks or default_blocks) == "fused"
    try:
        cfg = ModelConfig(**cfg_fields)
    except ValueError as e:
        parser.error(str(e))
    device = dist.initialize(device=resolve_device(args.device))
    if args.mesh_model:
        mesh_cfg = MeshConfig(data=-1, model=args.mesh_model, dcn_data=mesh_cfg.dcn_data)
    try:
        mesh = make_mesh(mesh_cfg)
    except ValueError as e:
        parser.error(str(e))
    ranks = mesh.world_group.size
    primary = dist.is_primary()
    model = build_model(cfg, device, args.params, args.random_init)
    if args.tp and mesh.shape["model"] > 1:
        try:
            place_tp(model, cfg, mesh.model_group)
        except ValueError as e:
            parser.error(str(e))
        if primary:
            print(f"--tp: the blocks run tensor-parallel over {mesh.shape['model']} ranks, "
                  f"each its {cfg.num_heads // mesh.shape['model']} heads through the "
                  "projected-attention kernel (never the fused block)")
    mean, std = load_stats(args.stats, cfg.input_feats)
    if cfg.single_transformer and cfg.fused_blocks and primary:
        print("--single_transformer: the merged timeline's layers never fuse (as in JAX); "
              "its self-attention runs the projected-attention kernel")

    requests = load_requests(args.requests, args.motion_length)
    if primary:
        print(f"{len(requests)} requests")
    T = max(r["length"] for r in requests) + 1  # + init token
    sched = g.make_schedule(g.linear_betas(args.diffusion_steps or steps))
    sampler = args.sampler or sampler
    try:
        sample_fn = make_sampler(model, sched, T=T, dim_pose=cfg.input_feats,
                                 sampler=sampler, ddim_steps=args.ddim_steps or ddim_steps,
                                 guidance_scale=guidance, graph=ranks == 1)
    except ValueError as e:
        parser.error(str(e))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    x_t = None
    if args.noise:
        x_t = np.load(args.noise)
        if x_t.shape != (len(requests), 2, T, cfg.input_feats):
            parser.error(f"--noise holds {x_t.shape}, expected "
                         f"{(len(requests), 2, T, cfg.input_feats)}")

    if primary:
        os.makedirs(args.out_dir, exist_ok=True)
    index: list = []
    t_start = time.time()
    frames_done = 0
    for lo in range(0, len(requests), args.batch_size):
        chunk = requests[lo : lo + args.batch_size]
        graphs_before = set(sample_fn.graphs)
        served = serve_batch(sample_fn, chunk, mean, std, device, generator, cfg.cap_id,
                             mesh, (2, T, cfg.input_feats), sampler == "ddpm",
                             None if x_t is None else x_t[lo:lo + len(chunk)])
        for key in set(sample_fn.graphs) - graphs_before:
            print(f"captured the sampler for {len(chunk)} requests: "
                  f"{json.dumps(sample_fn.graphs[key].summary())}")
        frames_done += sum(r["length"] * 2 for r in chunk)
        if not primary:
            continue
        write_results(args.out_dir, chunk, *served, index)
        elapsed = time.time() - t_start
        print(f"[{elapsed:.1f}s] {lo + len(chunk)}/{len(requests)} "
              f"({frames_done / elapsed:.0f} frames/s)")
    if not primary:
        return
    if args.fit_smpl:
        fit_smpl(index, args.smpl_model, args.gmm, device)
    with open(os.path.join(args.out_dir, "index.json"), "w") as f:
        json.dump(index, f)
    print(f"wrote {len(index)} results to {args.out_dir} "
          f"(model {json.dumps(dataclasses.asdict(cfg))})")


if __name__ == "__main__":
    main()
