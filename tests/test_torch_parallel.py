"""The port's parallelism (``hig_tpu_torch/parallel``) against hig_tpu on
the CPU, at tests/test_training.py's tiny widths.

- The rules with no processes: the port's FSDP and TP specs of every leaf
  equal JAX's ``_leaf_spec`` / ``_tp_leaf_spec`` on the same tree (through
  ``weights.flax_leaves``); ``make_mesh``'s and the config's refusals are
  JAX's, word for word; ``epoch_batches`` over 2 processes is JAX's, batch
  for batch; the backend rule picks NCCL only for a card a rank and puts a
  CUDA rank on a card, never the CPU.
- One launch of 2 gloo ranks (``_torch_parallel_worker.py``, torch and
  hig_tpu_torch only) runs DP, FSDP, TP, PP and the hybrid DCN mesh, two
  PIT steps each on the same global batch with t and noise fed in: losses
  and gradient norms bitwise equal across ranks and within rtol 1e-5 of
  the port's one-rank step, which is held against JAX's step on the
  conftest's 8-device mesh within 2e-5 (relative); the pipelined forward
  against JAX's ``pipeline_denoise`` on a 4 x 2 mesh (JAX's own 1e-5);
  TP DDIM-5 against the replicated model (efficient and ``no_eff``) within
  2e-5 of its largest magnitude, and a denoiser call with the time axis split over the ranks
  (sequence parallelism, T = 26) likewise; an FSDP checkpoint gathered to the one-rank format, equal to
  the one-rank step's parameters within rtol 1e-5, restored on both
  ranks exactly.
- ``python -m hig_tpu_torch.train --distributed --device cpu`` in two
  processes with the ``HIG_*`` variables: only rank 0 writes, and its
  checkpoint equals a one-process run's within rtol 1e-5.

Every spawn has a timeout, so a hung rank fails the test.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.config import MeshConfig as JaxMesh
from hig_tpu.config import add_dataset_paths as jax_add_paths
from hig_tpu.data import dataset as jd
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.text_encoder import ClipTextConfig as JaxClip
from hig_tpu.parallel import mesh as jmesh
from hig_tpu.parallel import pipeline as jpp
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, MeshConfig, add_dataset_paths, model_config
from hig_tpu_torch.data import dataset as td
from hig_tpu_torch.ops.pallas_attention import fused_projected_attention
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.parallel import mesh as pmesh
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import _torch_key, flatten, random_flax_tree
from tests import _torch_parallel_worker as w

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 120  # seconds a spawned rank may take
JAX_CLIP = JaxClip(width=32, heads=2, layers=1)
MODEL_KEYS = {k: v for k, v in w.TINY.items() if k not in ("batch_size", "window_size")}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_ranks(commands: list, logs: list, options: list) -> list:
    """Start one process per command (``subprocess.Popen`` options each),
    its output to its log file (a pipe left unread would stall a rank that
    a collective waits on), and wait for all, at most SPAWN_TIMEOUT
    seconds: (return code, log text) each."""
    files = [open(log, "w") for log in logs]
    procs = [subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True, **opts)
             for cmd, f, opts in zip(commands, files, options)]
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    finally:
        for p in procs:
            p.kill()
        for f in files:
            f.close()
    return [(p.returncode, open(log).read()) for p, log in zip(procs, logs)]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A synthetic dataset in the reference's layout (the port's generator,
    the JAX generator's files)."""
    from hig_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("par_data") / "data")
    generate_dataset(root, clips_per_class=2, min_frames=26, max_frames=40, seed=0,
                     device="cpu")
    return root


def jax_cfg(tmp, **kw):
    return jax_add_paths(JaxConfig(**w.TINY, name="par", dataset_name="synthetic_mul",
                                   data_root=str(tmp), checkpoints_dir=str(tmp), **kw))


# --- the rules, with no processes -----------------------------------------------


@pytest.mark.parametrize("cap_id", [True, False], ids=["cap_id", "tokens"])
def test_shard_specs_match_jax(cap_id):
    """FSDP and TP specs of every leaf, at model sizes 2 and 4, are JAX's on
    the same tree; a spec's dimension reaches the port's (transposed)
    weight through ``torch_dim``."""
    mcfg = model_config(ExperimentConfig(**MODEL_KEYS, cap_id=cap_id), w.CLIP)
    tree = jax.tree_util.tree_map(jnp.asarray, random_flax_tree(mcfg, 0)["params"])
    shapes = {name: shape for name, (_, shape) in pmesh.flax_leaves(mcfg).items()}
    for S in (2, 4):
        want = {
            "fsdp": flatten(jax.tree_util.tree_map(lambda x: jmesh._leaf_spec(x, S), tree)),
            "tp": flatten(jax.tree_util.tree_map_with_path(
                lambda p, x: jmesh._tp_leaf_spec(p, x, S), tree)),
        }
        for rule, specs in (("fsdp", pmesh.fsdp_specs(mcfg, S)), ("tp", pmesh.tp_specs(mcfg, S))):
            assert len(specs) == len(want[rule])
            got = {path: specs[_torch_key(path)] for path in want[rule]}
            assert got == {p: tuple(spec) for p, spec in want[rule].items()}, rule
        tp = pmesh.shard_dims(mcfg, S, "tp")
        assert tp["denoiser.layers.0.sa_block.query.weight"] == 0  # columns: torch rows
        assert tp["denoiser.layers.0.ffn.linear2.weight"] == 1
        assert tp["denoiser.layers.0.sa_block.query.bias"] is None
        for name, dim in pmesh.shard_dims(mcfg, S, "fsdp").items():
            if dim is not None:
                flax_dim = 1 - dim if len(shapes[name]) == 2 and name.endswith(".weight") else dim
                assert shapes[name][flax_dim] % S == 0


def test_make_mesh_errors_match_jax():
    for data, model, dcn in ((3, 2, 1), (4, 1, 3)):
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(JaxMesh(data=data, model=model, dcn_data=dcn),
                            devices=jax.devices()[:4])
        with pytest.raises(ValueError) as got:
            pmesh.make_mesh(MeshConfig(data=data, model=model, dcn_data=dcn), world=4, rank=0)
        assert str(got.value) == str(want.value)
    one = pmesh.make_mesh(MeshConfig(), world=1, rank=0)
    assert one.shape == {"data": 1, "model": 1} and one.model_group.size == 1


CONFIG_CASES = {"fsdp_tp": dict(fsdp=True, tp=True),
                "pp_fsdp": dict(pp_micro=2, fsdp=True),
                "pp_tp": dict(pp_micro=2, tp=True),
                "pp_single": dict(pp_micro=2, single_transformer=True),
                "pp_no_eff": dict(pp_micro=2, no_eff=True)}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config_refusals_match_jax(case, tmp_path):
    """The combinations JAX's trainer refuses (``test_both_flags_raise``,
    ``test_pp_excludes_fsdp_tp``) are refused by the port's config with
    JAX's message; each option alone is accepted."""
    kw = CONFIG_CASES[case]
    with pytest.raises(ValueError) as want:
        jt.Trainer(jax_cfg(tmp_path, mesh=JaxMesh(data=4, model=2), **kw), clip_config=JAX_CLIP)
    with pytest.raises(ValueError) as got:
        ExperimentConfig(**kw)
    assert str(got.value) == str(want.value)
    for key, value in kw.items():
        assert getattr(ExperimentConfig(**{key: value}), key) == value


def test_epoch_batches_two_processes_match_jax(data_root):
    """Each of 2 processes reads JAX's slice of every global batch."""
    cfg = add_dataset_paths(ExperimentConfig(dataset_name="synthetic_mul", data_root=data_root))
    jcfg = jax_add_paths(JaxConfig(dataset_name="synthetic_mul", data_root=data_root))
    mean = np.load(os.path.join(data_root, "Mean.npy"))
    std = np.load(os.path.join(data_root, "Std.npy"))
    ds = td.PairDataset(cfg, mean, std, "train_sub.txt", seed=0)
    jds = jd.PairDataset(jcfg, mean, std, "train_sub.txt", seed=0)
    for p in (0, 1):
        got = list(td.epoch_batches(ds, 8, 1, process_index=p, process_count=2))
        want = list(jd.epoch_batches(jds, 8, 1, process_index=p, process_count=2))
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            assert a["motion"].shape[0] == 4
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        next(td.epoch_batches(ds, 8, 1, process_index=0, process_count=3))


def test_backend_is_nccl_only_for_a_card_a_rank(monkeypatch):
    """NCCL only when each rank of a host has its own card; ranks sharing a
    card take gloo on that card, the CPU takes gloo; a CUDA rank is on a
    card (its own, or the shared one), never the CPU."""
    assert dist.pick_backend("cuda", 2, 2) == "nccl"
    assert dist.pick_backend("cuda", 2, 1) == "gloo"
    assert dist.pick_backend("cpu", 2, 8) == "gloo"
    assert dist.rank_device("cuda", "gloo", 1, 1) == torch.device("cuda", 0)
    assert dist.rank_device("cuda", "nccl", 1, 2) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="needs a card"):
        dist.rank_device("cuda", "gloo", 0, 0)
    seen = {}
    monkeypatch.setattr(dist.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.update(device=d))
    for cards, backend, device in ((1, "gloo", torch.device("cuda", 0)),
                                   (2, "nccl", torch.device("cuda", 1))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(dist, "_STATE", {})
        got = dist.initialize("127.0.0.1:1", 2, 1, device="cuda")
        assert (seen["backend"], seen["device"], got) == (backend, device, device)
        assert seen["world_size"] == 2 and seen["rank"] == 1


def test_local_layout_reads_torchrun_variables():
    """A rank's place on its host: torchrun's LOCAL_WORLD_SIZE and
    LOCAL_RANK where set (two hosts of two cards: global rank 3 is cuda:1
    under NCCL), else every process on one host."""
    assert dist.local_layout(4, 3, {}) == (4, 3)
    per_host, local = dist.local_layout(4, 3, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"})
    assert (per_host, local) == (2, 1)
    assert dist.pick_backend("cuda", per_host, 2) == "nccl"
    assert dist.rank_device("cuda", "nccl", local, 2) == torch.device("cuda", 1)
    assert dist.local_layout(4, 3, {"LOCAL_WORLD_SIZE": "2"}) == (2, 1)


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
                                "send", "recv", "all_gather_many", "reduce_scatter_many"])
def test_nccl_collectives_keep_tensors_on_the_device(op, monkeypatch):
    """Under NCCL every buffer a collective is handed lies on the input's
    device, and so does the result: only gloo stages through the host.
    ``meta`` tensors stand for a card's (a host buffer would show as cpu)."""
    seen = []

    def record(*args, **kwargs):
        for a in list(args) + list(kwargs.values()):
            for t in (a if isinstance(a, list) else [a]):
                if isinstance(t, torch.Tensor):
                    seen.append(t.device)

    for name in ("all_reduce", "all_gather", "reduce_scatter_tensor", "broadcast", "send",
                 "recv"):
        monkeypatch.setattr(dist.dist, name, record)
    monkeypatch.setattr(dist, "_STATE", {"backend": "nccl"})
    group = dist.Group((0, 1))
    x = torch.empty(4, 6, device="meta")
    out = {"all_reduce": lambda: dist.all_reduce(x, group),
           "all_gather": lambda: dist.all_gather(x, 1, group),
           "reduce_scatter": lambda: dist.reduce_scatter(x, 0, group),
           "broadcast": lambda: dist.broadcast(x, 1, group),
           "send": lambda: dist.send(x, 1),
           "recv": lambda: dist.recv(x, 1),
           "all_gather_many": lambda: dist.all_gather_many([x, x[0]], [0, 0], group),
           "reduce_scatter_many": lambda: dist.reduce_scatter_many([x, x[0]], [1, 0], group),
           }[op]()
    assert seen and all(d.type == "meta" for d in seen), seen
    for t in out if isinstance(out, list) else [] if out is None else [out]:
        assert t.device.type == "meta"


def test_rectangular_b2_is_the_heads_of_the_square_call():
    """B2 with (D/S, D) weights at H/S heads (a TP rank's form; on the CPU
    its plain version) is those heads' columns of the square call."""
    rs = np.random.RandomState(0)
    D, H, S = 32, 4, 2
    x = torch.from_numpy(rs.randn(2, 2, 9, D).astype(np.float32))
    ws = [torch.from_numpy(rs.randn(*((D, D) if i % 2 == 0 else (D,))).astype(np.float32))
          for i in range(6)]
    mask = torch.from_numpy((rs.rand(2, 2, 9) > 0.2).astype(np.float32))
    whole = fused_projected_attention(x, x.flip(1), *ws, H, key_mask=mask)
    for r in range(S):
        part = [t[r * D // S:(r + 1) * D // S] for t in ws]
        got = fused_projected_attention(x, x.flip(1), *part, H // S, key_mask=mask)
        torch.testing.assert_close(got, whole[..., r * D // S:(r + 1) * D // S],
                                   rtol=1e-6, atol=1e-6)


# --- two gloo ranks -------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = run_ranks([[sys.executable, w.__file__, str(r), "2", port, str(out)]
                      for r in range(2)], [out / f"log{r}.txt" for r in range(2)],
                     [{"env": env}] * 2)
    for code, log in done:
        assert code == 0, log[-3000:]
    return out, [json.load(open(out / f"rank{r}.json")) for r in range(2)]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The port's one-rank trainer, its two PIT steps on the worker's
    inputs, and its state after them."""
    out = tmp_path_factory.mktemp("one")
    torch.set_num_threads(1)
    trainer = tt.Trainer(w.cfg_of(str(out)), "cpu", w.CLIP, graph=False)
    state = trainer.init_state()
    losses = w.run_steps(trainer, state, [w.step_inputs(i) for i in range(w.STEPS)])
    return trainer, state, losses


def test_two_ranks_run_every_layout(spawned, one_rank):
    out, (r0, r1) = spawned
    _, state, want = one_rank
    assert r0["imported"] == r1["imported"] == []  # torch and hig_tpu_torch only
    for mode, case in r0["modes"].items():
        other = r1["modes"][mode]
        assert case["losses"] == other["losses"], mode  # bitwise across ranks
        np.testing.assert_allclose(case["losses"], want, rtol=1e-5, err_msg=mode)
        assert case["mode"] == {"hybrid_dcn": "dp"}.get(mode, mode)
    assert r0["modes"]["fsdp"]["batch_rows"] == 2 and r0["modes"]["tp"]["batch_rows"] == 1
    # FSDP's shards follow _leaf_spec (dimension halved), and restore exactly
    mcfg = model_config(w.cfg_of(str(out)), w.CLIP)
    dims = pmesh.shard_dims(mcfg, 2, "fsdp")
    whole = dict(state.model.named_parameters())
    for name, shape in r0["modes"]["fsdp"]["shards"].items():
        expect = list(whole[name].shape)
        expect[dims[name]] //= 2
        assert shape == expect, name
    assert r0["modes"]["fsdp"]["restore_err"] == r1["modes"]["fsdp"]["restore_err"] == 0.0
    tp_dims = pmesh.shard_dims(mcfg, 2, "tp")
    assert set(r0["modes"]["tp"]["tp_shapes"]) == {n for n, d in tp_dims.items() if d is not None}
    # every layout's checkpoint (rank 0's) is the one-rank format, at the
    # one-rank step's parameters
    for mode in r0["modes"]:
        saved = torch.load(out / f"{mode}.pt", weights_only=True)
        assert_params_close(saved["params"], state.model.state_dict(), mode)
        assert set(saved["opt_state"]["state"]) == set(range(len(state.optimizer.params)))
    for key in ("tp_ddim5", "tp_ddim5_no_eff"):  # the efficient and the quadratic blocks
        assert r0[key] <= 2e-5 and r1[key] <= 2e-5, key
    # the time axis split over the ranks (JAX's SP test's 2e-5)
    assert r0["sp_denoise"] <= 2e-5 and r1["sp_denoise"] <= 2e-5


def assert_params_close(got: dict, want: dict, what: str, steps: int = w.STEPS):
    """Parameters after ``steps`` Adam steps within rtol 1e-5, and atol
    1e-5 (lr / 20): an Adam step moves an element by about lr whatever its
    gradient's size, so where a gradient is near 0 the order of sums moves
    its update by a fraction of lr. The attention blocks' key biases have
    an exact gradient of 0, so theirs is rounding noise that Adam turns
    into steps of up to lr: those leaves within 2 · lr a step."""
    assert got.keys() == want.keys()
    for name, p in want.items():
        if name.endswith("_block.key.bias"):
            assert float((got[name] - p).abs().max()) <= 2 * 2e-4 * steps, (what, name)
            continue
        torch.testing.assert_close(got[name], p, rtol=1e-5, atol=1e-5, msg=f"{what} {name}")


def test_one_rank_step_matches_jax(one_rank, tmp_path):
    """The port's one-rank step (the reference of every layout above)
    against JAX's jitted step on the conftest's 8-device data mesh, fed
    JAX's own draws: loss and gradient norm within 2e-5 relative."""
    trainer, _, _ = one_rank
    jcfg = jax_cfg(tmp_path, cap_id=True, mesh=JaxMesh(data=8, model=1))
    jtrainer = jt.Trainer(jcfg, clip_config=JAX_CLIP)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    random_flax_tree(trainer.model_config, jcfg.seed))
    jtrainer.tx = jt.make_optimizer(jcfg, params)
    jstate = jtrainer.place_state(jt.TrainState(params=params, opt_state=jtrainer.tx.init(params),
                                                step=jnp.zeros((), jnp.int32)))
    step = jax.jit(jt.make_train_step(jtrainer.model, jtrainer.sched, jtrainer.tx, pit=True))
    B, T = w.TINY["batch_size"], w.TINY["window_size"] + 1
    inputs, want = [], []
    for i in range(w.STEPS):
        x = w.step_inputs(i)
        batch = {"motion": x["motion"], "lengths": x["lengths"].astype(np.int32),
                 "cap_ids": x["cap_ids"].astype(np.int32)}
        rng = jax.random.key(i)
        jstate, metrics = step(jstate, jmesh.shard_batch(jtrainer.mesh, batch), rng)
        want.append([float(metrics[k]) for k in tt.TRAIN_METRICS])
        t_rng, n_rng = jax.random.split(rng)
        inputs.append({**batch, "t": np.asarray(jax.random.randint(t_rng, (B,), 0, 100)),
                       "noise": np.asarray(jax.random.normal(n_rng, (B, 2, T, 263)))})
    fresh = tt.Trainer(trainer.cfg, "cpu", w.CLIP, graph=False)
    got = w.run_steps(fresh, fresh.init_state(), inputs)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_pipeline_forward_matches_jax(spawned, one_rank, tmp_path):
    """The port's pipelined denoiser (2 stages, 2 microbatches) against
    JAX's ``pipeline_denoise`` on a 4 x 2 mesh, same weights and inputs."""
    _, (r0, r1) = spawned
    trainer, _, _ = one_rank
    jcfg = jax_cfg(tmp_path, cap_id=True, mesh=JaxMesh(data=4, model=2))
    model = jt.Trainer(jcfg, clip_config=JAX_CLIP).model
    params = jax.tree_util.tree_map(jnp.asarray,
                                    random_flax_tree(trainer.model_config, jcfg.seed))
    x, t, lengths, cond = (jnp.asarray(a, jnp.float32 if a.dtype == np.float32 else jnp.int32)
                           for a in w.denoise_inputs())
    xf_proj, xf_out = model.apply(params, cond, True, method=JaxModel.encode_text)
    mesh = jmesh.make_mesh(JaxMesh(data=4, model=2))
    want = jax.jit(lambda p: jpp.pipeline_denoise(model, p, x, t, lengths, xf_proj, xf_out,
                                                  mesh, n_micro=2))(params)
    assert r0["modes"]["pp"]["pp_denoise"] == r1["modes"]["pp"]["pp_denoise"]
    np.testing.assert_allclose(np.asarray(r0["modes"]["pp"]["pp_denoise"]), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_train_cli_two_processes(data_root, tmp_path):
    """``python -m hig_tpu_torch.train --distributed --device cpu`` as two
    processes (``HIG_*``), each with its own --checkpoints_dir: rank 0
    writes opt.txt, metrics and checkpoints, rank 1 nothing, no process
    imports JAX, and rank 0's checkpoint equals a one-process run's."""
    argv = ["--dataset_name", "synthetic_mul", "--data_root", data_root, "--cap_id",
            "--batch_size", "4", "--limit_data_num", "8", "--num_epochs", "1",
            "--log_every", "1", "--device", "cpu", "--name", "cli"]
    for k, v in MODEL_KEYS.items():
        argv += [f"--{k}", str(v)]
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               HIG_COORDINATOR=f"127.0.0.1:{port}", HIG_NUM_PROCESSES="2",
               OMP_NUM_THREADS="1")
    done = run_ranks(
        [[sys.executable, "-X", "importtime", "-m", "hig_tpu_torch.train", "--distributed",
          "--checkpoints_dir", str(tmp_path / f"rank{r}"), *argv] for r in range(2)],
        [tmp_path / f"log{r}.txt" for r in range(2)],
        [{"env": {**env, "HIG_PROCESS_ID": str(r)}, "cwd": REPO} for r in range(2)])
    printed = []
    for code, log in done:
        assert code == 0, log[-3000:]
        lines = log.splitlines()
        imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                    for line in lines if line.startswith("import time:")}
        assert not imported & {"jax", "jaxlib", "flax", "hig_tpu"}
        printed.append([line for line in lines if line.startswith(("epoch", "dataset"))])
    root = tmp_path / "rank0" / "synthetic_mul" / "cli"
    assert {"opt.txt", "metrics.jsonl", "model", "meta"} <= set(os.listdir(root))
    assert not (tmp_path / "rank1").exists()
    assert any(" it 2 " in line for line in printed[0]) and printed[1] == []

    from hig_tpu_torch.train.__main__ import main

    main([*argv, "--checkpoints_dir", str(tmp_path / "one")], graph=False)
    got = torch.load(root / "model" / "latest.pt", weights_only=True)
    want = torch.load(tmp_path / "one" / "synthetic_mul" / "cli" / "model" / "latest.pt",
                      weights_only=True)
    assert got["step"] == want["step"] == 2
    assert_params_close(got["params"], want["params"], "cli")


SERVE_RUNS = {"tp": ["--tp", "--mesh_model", "2", "--ddim_steps", "5"],
              "dp": ["--sampler", "ddpm", "--diffusion_steps", "40"]}


def test_serve_two_processes(tmp_path):
    """``python -m hig_tpu_torch.serve`` as two processes (``HIG_*``): with
    ``--tp --mesh_model 2`` (DDIM-5, the blocks tensor-parallel) and as two
    data ranks (DDPM-40: x_T and every step's noise drawn for the whole
    chunk and sliced). Rank 0 alone writes, and the motion equals a
    one-process call's within 1e-5 of its largest magnitude."""
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.models.interaction_model import ModelConfig
    from hig_tpu_torch.serve import main

    mcfg = tmp_path / "model.json"
    mcfg.write_text(json.dumps({**{k: v for k, v in MODEL_KEYS.items()
                                   if k in ModelConfig.__dataclass_fields__}, "cap_id": True}))
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("".join(json.dumps({"caption1": CAPS[i], "caption2": CAPS[i + 1],
                                        "length": 20 + i}) + "\n" for i in range(5)))
    base = ["--requests", str(reqs), "--random_init", "0", "--model_config", str(mcfg),
            "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               HIG_NUM_PROCESSES="2", OMP_NUM_THREADS="1")
    for run, extra in SERVE_RUNS.items():
        port = free_port()
        done = run_ranks(
            [[sys.executable, "-m", "hig_tpu_torch.serve", *base, *extra, "--out_dir",
              str(tmp_path / f"{run}{r}")] for r in range(2)],
            [tmp_path / f"{run}_log{r}.txt" for r in range(2)],
            [{"env": {**env, "HIG_PROCESS_ID": str(r), "HIG_COORDINATOR": f"127.0.0.1:{port}"},
              "cwd": REPO} for r in range(2)])
        for code, log in done:
            assert code == 0, log[-3000:]
        assert not (tmp_path / f"{run}1").exists()
        one = [a for a in extra if a not in ("--tp", "--mesh_model", "2")]  # replicated
        main([*base, *one, "--out_dir", str(tmp_path / f"{run}_one")])
        index = json.load(open(tmp_path / f"{run}0" / "index.json"))
        assert len(index) == 5
        for entry in index:
            got = np.load(entry["path"])["features"]
            want = np.load(tmp_path / f"{run}_one" / f"{entry['id']}.npz")["features"]
            assert np.isfinite(want).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("entry", ["label", "evaluate", "distill", "train_single"])
def test_one_rank_entry_points_refuse_several_ranks(entry, monkeypatch):
    """The entry points that run on one rank raise, naming ROADMAP, when
    started as one of several processes (``HIG_NUM_PROCESSES``), instead of
    running on each rank alone."""
    import importlib

    main = importlib.import_module(f"hig_tpu_torch.{entry}").main
    argv = [] if entry == "train_single" else ["--opt_path", "missing/opt.txt"]
    monkeypatch.setenv("HIG_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="ROADMAP"):
        main([*argv, "--device", "cpu"])
