"""``python -m hig_tpu_torch.visualize`` against ``tools/visualization.py``
on the CPU, and the loss-curve PNG of a port training run.

Tiny runs trained by the port on a dataset its own generator wrote: a
caption-id PIT run through ``python -m hig_tpu_torch.train`` (whose
``result/result_loss.png`` must exist), a caption-token run through
``Trainer`` with a small CLIP tower, and a single-person run through
``python -m hig_tpu_torch.train_single``. For each mode (pair with caption
ids, pair with caption tokens, ``--single``) the port's CLI samples and
writes finite joints; then, the sampler of both tools handing them one
output of real scale (a dataset clip normalized by the run's statistics;
JAX's checkpoint restore and single-person model stubbed), JAX's
de-normalization and decode (``recover_from_ric2``, or ``recover_from_ric``
with the single-person statistics) must write joints within 1e-4 of the
port's. A ``--gif`` run writes a GIF (its pixels are
not compared); without matplotlib the CLI raises, naming ``--no-gif``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu_torch import visualize
from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths, save_opt_txt
from hig_tpu_torch.data.dataset import load_training_stats
from hig_tpu_torch.data.synthetic import generate_dataset
from hig_tpu_torch.train import trainer as tt
from tests.test_pose_pipeline import TOOLS, run_tool
from tests.test_torch_pipeline import PORT_CLIP, TINY, tiny_args
from tests.test_torch_single import write_single_data
from tests.test_torch_train import dataset_for

JOINT_TOL = 1e-4
MOTION_LENGTH = 12
SAMPLING = ["--sampler", "ddim", "--ddim_steps", "2", "--motion_length", str(MOTION_LENGTH)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """opt.txt of each tiny run by mode, the caption-id run's save root and
    the two data roots."""
    from hig_tpu_torch import train_single
    from hig_tpu_torch.train.__main__ import main as train_main

    tmp = tmp_path_factory.mktemp("visualize")
    data, ckpts = str(tmp / "data"), str(tmp / "runs")
    generate_dataset(data, clips_per_class=1, min_frames=60, max_frames=61, device="cpu")
    trainer, _ = train_main(tiny_args(data, ckpts, "cap") + ["--cap_id"])
    cfg = add_dataset_paths(ExperimentConfig(
        **TINY, dataset_name="synthetic_mul", data_root=data, checkpoints_dir=ckpts,
        batch_size=4, log_every=1, name="tokens", num_epochs=1, limit_data_num=4))
    save_opt_txt(cfg, os.path.join(cfg.save_root, "opt.txt"))
    load_training_stats(cfg)
    tokens = tt.Trainer(cfg, "cpu", PORT_CLIP)
    tokens.train(dataset_for(cfg), tokens.init_state(), log=lambda *_: None)
    single = str(tmp / "single")
    write_single_data(single, "t2m")
    train_single.main(["--device", "cpu", "--dataset_name", "t2m", "--data_root", single,
                       "--checkpoints_dir", ckpts, "--name", "single", "--batch_size", "2",
                       "--num_epochs", "1", "--log_every", "1", "--window", "16",
                       *[a for k, v in TINY.items() for a in (f"--{k}", str(v))]],
                      clip_config=PORT_CLIP)
    return {"cap_id": os.path.join(trainer.cfg.save_root, "opt.txt"),
            "tokens": os.path.join(cfg.save_root, "opt.txt"),
            "single": os.path.join(ckpts, "t2m", "single", "opt.txt"),
            "cap_id_root": trainer.cfg.save_root, "data": data, "single_data": single}


def test_train_run_draws_its_loss_curve(runs):
    png = os.path.join(runs["cap_id_root"], "result", "result_loss.png")
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def dataset_output(runs, mode: str) -> np.ndarray:
    """A sampler output of real scale: the first dataset clip's first
    MOTION_LENGTH frames and its init row, normalized by the run's
    statistics in the sampler's layout (pair: (1, 2, T, D), the init row
    first, its channels 4: zero; single: (1, T, D), the init row last)."""
    meta = os.path.join(os.path.dirname(runs[mode]), "meta")
    mean, std = (np.load(os.path.join(meta, f"{k}.npy")) for k in ("mean", "std"))
    root = runs["single_data" if mode == "single" else "data"]
    name = sorted(os.listdir(os.path.join(root, "new_joint_vecs")))[-1]
    clip = np.load(os.path.join(root, "new_joint_vecs", name))
    if mode == "single":
        D = clip.shape[-1]
        frames = (clip[:MOTION_LENGTH] - mean[:D]) / std[:D]
        return np.concatenate([frames, np.zeros((1, D))])[None].astype(np.float32)
    frames = (clip[:, :MOTION_LENGTH] - mean[:-4]) / std[:-4]
    init = np.zeros_like(clip[:, :1])
    init[..., :4] = (clip[:, -1:, :4] - mean[-4:]) / std[-4:]
    return np.concatenate([init, frames], axis=1)[None].astype(np.float32)


def jax_tool(monkeypatch, argv, out):
    """tools/visualization.py's main on ``argv``, its sampler, checkpoint
    restore and single-person model stubbed to give ``out``."""
    sys.path.insert(0, TOOLS)
    try:
        import _common
    finally:
        sys.path.remove(TOOLS)
    from hig_tpu.models import interaction_model as jim
    from hig_tpu.train import checkpoint as jckpt
    from hig_tpu.train import trainer as jtr

    class Stub:
        model = sched = params = None

        def __init__(self, **_):
            pass

        def init(self, *_):
            return {}

    monkeypatch.setattr(_common, "restore_trainer_state", lambda *_: (Stub(), Stub(), 0, 0))
    monkeypatch.setattr(jtr, "make_sampler", lambda *_, **__: lambda *_: jnp.asarray(out))
    monkeypatch.setattr(jtr, "make_single_sampler", lambda *_, **__: lambda *_: jnp.asarray(out))
    monkeypatch.setattr(jim, "SingleMotionModel", Stub)
    monkeypatch.setattr(jckpt, "restore_params", lambda *_: {})
    run_tool("visualization", argv)


MODES = {"cap_id": ["--class_id", "3"], "tokens": ["--caption1", "two people hug"],
         "single": ["--single", "--caption1", "a person jumps"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_visualize_joints_match_jaxs_tool(runs, mode, tmp_path, monkeypatch):
    """The CLI's own sampling writes finite joints of the right shape; then
    both tools decode one sampler output of real scale (the untrained tiny
    models' samples reach 1e3 in normalized units, where the decode's
    trigonometry of integrated angles is ill-conditioned)."""
    argv = ["--opt_path", runs[mode], *MODES[mode], *SAMPLING, "--seed", "5", "--no-gif"]
    clip = None if mode == "cap_id" else PORT_CLIP
    port = argv + ["--device", "cpu", "--result_path", str(tmp_path / "port")]
    made = visualize.main(port, clip_config=clip)
    got = np.load(made["path"])
    shape = (MOTION_LENGTH, 22, 3) if mode == "single" else (2, MOTION_LENGTH, 22, 3)
    assert got.shape == shape and np.isfinite(got).all()
    out = dataset_output(runs, mode)
    sampler = "make_single_sampler" if mode == "single" else "make_sampler"
    monkeypatch.setattr(visualize, sampler,
                        lambda *_, **__: lambda *_, **__: torch.from_numpy(out))
    got = np.load(visualize.main(port, clip_config=clip)["path"])
    jax_tool(monkeypatch, argv + ["--result_path", str(tmp_path / "jax")], out)
    want = np.load(tmp_path / "jax" / os.path.basename(made["path"]))
    assert want.shape == shape and np.abs(got - want).max() <= JOINT_TOL


def test_visualize_draws_a_gif_or_names_no_gif(runs, tmp_path, monkeypatch):
    argv = ["--opt_path", runs["cap_id"], *SAMPLING, "--device", "cpu", "--result_path",
            str(tmp_path), "--ddim_steps", "1", "--motion_length", "3"]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="--no-gif"):
            visualize.main(argv)
    else:
        made = visualize.main(argv)
        with open(made["path"][:-4] + ".gif", "rb") as f:
            assert f.read(6) in (b"GIF87a", b"GIF89a")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="--no-gif"):
        visualize.main(argv)
