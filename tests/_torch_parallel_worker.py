"""One rank of the port's multi-process test (tests/test_torch_parallel.py).

Run as: python _torch_parallel_worker.py <rank> <ranks> <port> <outdir>
[cuda] (the test imports its inputs and configs without running it). With
``cuda`` (tests/test_torch_cuda.py) both ranks share cuda:0 over gloo at
CARD's widths (heads of 64, the kernels' width) and run DP alone, its B2
launches counted.

Imports torch and hig_tpu_torch only. Joins a gloo group on the CPU, then
runs every layout in one launch, each over the same seeded weights and the
same global batch with its t and noise fed in: DP (2 x 1), FSDP, TP and the
GPipe schedule (1 x 2, pp_micro 2) and the hybrid DCN mesh (2 x 1,
dcn_data 2), two PIT steps each; then TP DDIM-5 calls (efficient and
``no_eff``) against the replicated model, the pipelined denoiser's output on fixed inputs, and an
FSDP checkpoint written by rank 0 and restored on both ranks, and one
denoiser call with the time axis split over the ranks. Writes
<outdir>/rank<r>.json (and rank 0 the checkpoints).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from hig_tpu_torch.config import ExperimentConfig, MeshConfig, add_dataset_paths
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.parallel import mesh as pmesh
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

# tests/test_training.py's tiny widths
TINY = dict(num_layers=2, latent_dim=32, ff_size=64, num_heads=4, num_text_layers=1,
            text_latent_dim=16, text_ff_size=32, text_num_heads=2, diffusion_steps=100,
            batch_size=8, window_size=24)
# the card's kernels take heads of 64
CARD = dict(TINY, latent_dim=128, ff_size=256, num_heads=2, text_latent_dim=64,
            text_ff_size=128)
CLIP = ClipTextConfig(width=32, heads=2, layers=1)
MODES = {"dp": dict(mesh=MeshConfig(data=2, model=1)),
         "fsdp": dict(mesh=MeshConfig(data=1, model=2), fsdp=True),
         "tp": dict(mesh=MeshConfig(data=1, model=2), tp=True),
         "pp": dict(mesh=MeshConfig(data=1, model=2), pp_micro=2),
         "hybrid_dcn": dict(mesh=MeshConfig(data=2, model=1, dcn_data=2))}
STEPS = 2


def cfg_of(outdir: str, widths: dict = TINY, **kw):
    return add_dataset_paths(ExperimentConfig(
        **widths, name="par", dataset_name="synthetic_mul", data_root=outdir,
        checkpoints_dir=outdir, cap_id=True, **kw))


def step_inputs(step: int) -> dict:
    """The global batch and its draws of PIT step ``step`` (numpy)."""
    rs = np.random.RandomState(100 + step)
    B, T, D = TINY["batch_size"], TINY["window_size"] + 1, 263
    return dict(motion=rs.randn(B, 2, T, D).astype(np.float32),
                lengths=np.array([T, T - 3, 9, T, T, 12, T - 1, T]),
                cap_ids=rs.randint(0, 43, (B, 2)),
                t=rs.randint(0, 100, (B,)), noise=rs.randn(B, 2, T, D).astype(np.float32))


def run_steps(trainer, state, inputs) -> list:
    """PIT steps on ``inputs`` (global batches and draws), this rank's rows
    on the trainer's device: [loss, grad norm] a step."""
    layout, device = trainer.layout, trainer.device
    step = tt.make_train_step(trainer.sched, pit=True, graph=False,
                              layout=layout)
    out = []
    for x in inputs:
        x = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in
             pmesh.shard_batch(x, layout.batch_index, layout.batch_count).items()}
        batch = {"motion": x["motion"], "lengths": x["lengths"].long(),
                 "cap_ids": x["cap_ids"].long()}
        metrics = step(state, batch, t=x["t"].long(), noise=x["noise"])
        out.append([float(metrics[k]) for k in tt.TRAIN_METRICS])
    return out


def run_mode(mode: str, outdir: str) -> dict:
    trainer = tt.Trainer(cfg_of(outdir, **MODES[mode]), "cpu", CLIP, graph=False)
    state = trainer.init_state()
    layout = trainer.layout
    losses = run_steps(trainer, state, [step_inputs(i) for i in range(STEPS)])
    out = {"losses": losses, "mode": layout.mode, "batch_rows": layout.batch_count}
    path = os.path.join(outdir, f"{mode}.pt")
    trainer.save(path, state, 1, STEPS)  # the one-rank format, rank 0 writes
    if mode == "fsdp":
        out["shards"] = {n: list(t.shape) for n, t in layout.shards.items()}
        before = {n: t.detach().clone() for n, t in layout.shards.items()}
        moments = [m.detach().clone() for m in state.optimizer.exp_avg]
        fresh = trainer.init_state()
        trainer.restore(path, fresh)
        out["restore_err"] = max(
            [float((trainer.layout.shards[n] - t).detach().abs().max())
             for n, t in before.items()]
            + [float((a - b).abs().max()) for a, b in zip(fresh.optimizer.exp_avg, moments)])
    if mode == "tp":
        out["tp_shapes"] = {n: list(p.shape) for n, p in state.model.named_parameters()
                            if layout.dim(n) is not None}
    if mode == "pp":
        model = trainer.init_state().model.eval()
        x, t, lengths, cond = (torch.from_numpy(a) for a in denoise_inputs())
        with torch.no_grad():
            out["pp_denoise"] = model.denoise(x, t.long(), lengths.long(),
                                              *model.encode_text(cond.long())).tolist()
    return out


def denoise_inputs():
    """x, t, lengths and caption ids of one denoiser call (numpy), on
    which the pipelined denoiser at the seeded initial weights is held
    against JAX's pipeline_denoise."""
    rs = np.random.RandomState(0)
    B, T = 8, TINY["window_size"] + 1
    return (rs.randn(B, 2, T, 263).astype(np.float32), rs.randint(0, 100, (B,)),
            np.array([T, T - 3, 9, T, T, 12, T - 1, T]), rs.randint(0, 43, (B, 2)))


def tp_sampler(outdir: str, no_eff: bool = False) -> float:
    """DDIM-5 with TP-placed blocks against the replicated model, on a
    caption-token model (its text suffix and cross-attention run
    tensor-parallel too), efficient or ``no_eff``: the largest error over
    the largest magnitude."""
    cfg = cfg_of(outdir, mesh=MeshConfig(data=1, model=2), tp=True, no_eff=no_eff)
    cfg.cap_id = False
    trainer = tt.Trainer(cfg, "cpu", CLIP, graph=False)
    model = trainer.init_state().model.eval()
    whole = InteractionModel(trainer.model_config)
    load_flax_tree(whole, random_flax_tree(trainer.model_config, cfg.seed)["params"])
    whole.eval()
    sched = g.make_schedule(g.linear_betas(100))
    T = TINY["window_size"] + 1
    tokens = torch.from_numpy(np.random.RandomState(3).randint(1, 400, (4, 2, 77)))
    tokens[..., 5] = 49407  # end of text
    lengths = torch.tensor([T, T - 4, 11, T])
    noise = torch.from_numpy(np.random.RandomState(4).randn(4, 2, T, 263).astype(np.float32))
    outs = [tt.make_sampler(m, sched, T, 263, "ddim", 5, graph=False)(tokens, lengths, noise)
            for m in (model, whole)]
    return float((outs[0] - outs[1]).abs().max() / outs[1].abs().max())


def sp_denoise(outdir: str) -> float:
    """One denoiser call with the time axis split over the 2 ranks (T = 26,
    ragged lengths) against the replicated call: the largest error over
    the largest magnitude."""
    trainer = tt.Trainer(cfg_of(outdir, mesh=MeshConfig(data=1, model=2)), "cpu", CLIP,
                         graph=False)
    model = trainer.init_state().model.eval()
    whole = trainer.init_state().model.eval()
    pmesh.place_sequence(model, trainer.mesh.model_group)
    rs = np.random.RandomState(1)
    B, T = 4, 26
    x = torch.from_numpy(rs.randn(B, 2, T, 263).astype(np.float32))
    t, lengths = torch.full((B,), 7), torch.tensor([T, T - 5, T, 9])
    cond = torch.from_numpy(rs.randint(0, 43, (B, 2)))
    with torch.no_grad():
        want = whole.denoise(x, t, lengths, *whole.encode_text(cond))
        local = model.denoise(pmesh.sequence_shard(x, trainer.mesh.model_group), t, lengths,
                              *model.encode_text(cond))
        got = dist.all_gather(local, 2, trainer.mesh.model_group)
    return float((got - want).abs().max() / want.abs().max())


def card_dp(outdir: str, device) -> dict:
    """DP over the ranks sharing cuda:0: the steps' metrics and B2 launches."""
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention

    trainer = tt.Trainer(cfg_of(outdir, CARD, mesh=MeshConfig(data=2, model=1)), device,
                         CLIP, graph=False)
    state = trainer.init_state()
    before = fused_projected_attention.launches
    losses = run_steps(trainer, state, [step_inputs(i) for i in range(STEPS)])
    return {"losses": losses, "launches": fused_projected_attention.launches - before,
            "backend": dist.backend(), "device": str(trainer.device)}


def main():
    rank, ranks, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    if sys.argv[5:6] == ["cuda"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        device = dist.initialize(f"127.0.0.1:{port}", ranks, rank, device="cuda")
        with open(os.path.join(outdir, f"card{rank}.json"), "w") as f:
            json.dump(card_dp(outdir, device), f)
        dist.shutdown()
        return
    dist.initialize(f"127.0.0.1:{port}", ranks, rank, device="cpu")
    results = {"rank": rank, "modes": {m: run_mode(m, outdir) for m in MODES},
               "tp_ddim5": tp_sampler(outdir), "tp_ddim5_no_eff": tp_sampler(outdir, True),
               "sp_denoise": sp_denoise(outdir),
               "imported": sorted(k for k in sys.modules
                                  if k.split(".")[0] in ("jax", "jaxlib", "flax", "hig_tpu"))}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.shutdown()


if __name__ == "__main__":
    main()
