"""Parity of the port's single-person model (the paper's baseline and
``--pretrained`` donor) against hig_tpu on the CPU.

- The ``SingleMotionModel`` tree: the port's shapes against JAX's init
  structure (no ``joint_embed2``, no ``out2``, no interaction block).
- ``MotionDenoiser`` and the whole ``SingleMotionModel`` forward (caption
  tokens through the tiny CLIP tower and suffix), efficient and
  ``--no_eff``, directly and with the text KᵀV hoisted: 2e-5.
- One train step's loss and every gradient against ``jax.value_and_grad``
  of the loss of JAX's ``make_single_train_step``, with t and the noise
  drawn from its key as that step draws them: the tolerances of
  ``tests/test_torch_train.py``.
- ``make_single_sampler`` DDIM and DPM against JAX's from JAX's x_T: 1e-5 of
  the output's largest magnitude.
- ``SingleMotionDataset`` batches equal JAX's bit for bit on synthetic
  t2m- and kit-format data (caption segments, one clamped at the init row,
  one too short, clips outside the length range).
- ``python -m hig_tpu_torch.train_single`` on the CPU: opt.txt, meta/,
  metrics.jsonl and the checkpoint; a run resumed from the first epoch's
  checkpoint ends bit for bit where an unbroken run does.

Tiny widths (2 layers, latent 32) and ``torch.set_num_threads(1)``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.config import add_dataset_paths as jax_add_paths
from hig_tpu.data import dataset as jd
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.interaction_model import SingleMotionModel as JaxSingle
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths, single_model_config
from hig_tpu_torch.data import dataset as td
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models.interaction_model import SingleMotionModel
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import (
    flatten,
    flax_param_shapes,
    load_flax_tree,
    random_flax_tree,
    torch_state_from_flax,
)
from tests.test_torch_train import (
    JAX_CLIP,
    LOSS_RTOL,
    PORT_CLIP,
    TINY,
    assert_grads_close,
    rand,
    t_,
)

B, T, FEATS = 4, 20, 263
LENGTHS = np.array([20, 11, 16, 7], np.int32)
TOL = 2e-5
JAX_FIELDS = {k: v for k, v in TINY.items() if k != "diffusion_steps"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def models(no_eff=False):
    """(JAX SingleMotionModel, its params, the port's model in eval mode)
    with the same seeded weights."""
    cfg = ExperimentConfig(**TINY, dataset_name="t2m", no_eff=no_eff)
    mcfg = single_model_config(add_dataset_paths(cfg), PORT_CLIP)
    tree = random_flax_tree(mcfg, seed=0)
    port = load_flax_tree(SingleMotionModel(mcfg), tree["params"]).eval()
    jmodel = JaxSingle(**JAX_FIELDS, input_feats=FEATS, efficient=not no_eff,
                       clip_config=JAX_CLIP)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, tree), port


def tokens(n, seed=0):
    ids = np.random.RandomState(seed).randint(0, len(CAPS), n)
    return tokenize(CAPS).astype(np.int32)[ids]


def test_tree_matches_the_jax_init():
    jmodel, _, port = models()
    args = (jnp.zeros((1, T, FEATS)), jnp.zeros((1,), jnp.int32), jnp.full((1,), T),
            jnp.zeros((1, 77), jnp.int32))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree_util.tree_map(
        lambda a: a, dict(shapes), is_leaf=lambda a: hasattr(a, "shape"))).items()}
    got = {k: tuple(v) for k, v in flatten(flax_param_shapes(port.cfg)).items()}
    assert got == want
    assert not any(k[2] in ("joint_embed2", "out2") for k in want if k[1] == "denoiser")


def test_single_config_refuses_pair_options():
    cfg = add_dataset_paths(ExperimentConfig(**TINY, dataset_name="kit"))
    assert single_model_config(cfg, PORT_CLIP).input_feats == 251
    from hig_tpu_torch.models.interaction_model import SingleModelConfig

    with pytest.raises(ValueError, match="cap_id"):
        SingleModelConfig(cap_id=True)


@pytest.mark.parametrize("no_eff", [False, True], ids=["efficient", "no_eff"])
def test_forward_matches_jax(no_eff):
    """MotionDenoiser on given conditioning, directly and with the text KᵀV
    hoisted, and the whole model from caption tokens."""
    jmodel, params, port = models(no_eff)
    x, t = rand(B, T, FEATS, seed=1), np.array([3, 70, 500, 999])
    xf_proj = rand(B, port.cfg.time_embed_dim, seed=2)
    xf_out = rand(B, 9, TINY["text_latent_dim"], seed=3)
    want = jmodel.apply(params, *map(jnp.asarray, (x, t, LENGTHS, xf_proj, xf_out)),
                        method=JaxSingle.denoise)
    tok = tokens(B)
    want_full = jmodel.apply(params, *map(jnp.asarray, (x, t, LENGTHS, tok)))
    with torch.no_grad():
        direct = port.denoise(t_(x), t_(t), t_(LENGTHS), t_(xf_proj), t_(xf_out))
        hoisted = port.denoise(t_(x), t_(t), t_(LENGTHS), t_(xf_proj),
                               text_kv=port.text_kv(t_(xf_out)))
        full = port(t_(x), t_(t), t_(LENGTHS), t_(tok))
    for got, ref in ((direct, want), (hoisted, want), (full, want_full)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_train_step_loss_and_grads_match_jax():
    """The loss of make_single_train_step (JAX) under value_and_grad, t and
    noise drawn from the step's key as it draws them."""
    cfg = add_dataset_paths(ExperimentConfig(**TINY, dataset_name="t2m"))
    jmodel, params, _ = models()
    sched = jg.make_schedule(jg.linear_betas(100))
    batch = {"motion": rand(B, T, FEATS, seed=4), "lengths": LENGTHS, "tokens": tokens(B, 1)}
    rng = jax.random.key(5)

    def loss_fn(p, b, r):  # make_single_train_step's loss_fn
        motion = b["motion"]
        lengths = jnp.minimum(b["lengths"], T)
        t_rng, n_rng = jax.random.split(r)
        t = jax.random.randint(t_rng, (B,), 0, sched.num_timesteps)
        noise = jax.random.normal(n_rng, motion.shape, motion.dtype)
        x_t, target = jg.training_targets(sched, motion, t, noise)
        mask = (jnp.arange(T) < lengths[:, None]).astype(motion.dtype)
        pred = jmodel.apply(p, x_t, t, lengths, b["tokens"])
        per_tok = jnp.mean((pred - target) ** 2, axis=-1)
        return jnp.sum(per_tok * mask) / jnp.sum(mask)

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    t_rng, n_rng = jax.random.split(rng)
    t = np.asarray(jax.random.randint(t_rng, (B,), 0, 100))
    noise = np.asarray(jax.random.normal(n_rng, (B, T, FEATS), jnp.float32))

    model = load_flax_tree(SingleMotionModel(single_model_config(cfg, PORT_CLIP)),
                           jax.tree_util.tree_map(np.asarray, params)["params"]).train()
    tt.make_optimizer(cfg, model)  # the CLIP tower frozen
    tbatch = {"motion": t_(batch["motion"]), "lengths": t_(LENGTHS).long(),
              "tokens": t_(batch["tokens"]).long()}
    loss, _ = tt.compute_grads(model, tt.make_single_loss_fn(model, tg.make_schedule(
        tg.linear_betas(100))), tbatch, t=t_(t).long(), noise=t_(noise))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}
    frozen = model.clip_parameters()
    assert frozen and all(got[n].abs().max() == 0 for n in frozen)
    assert_grads_close(got, want)


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_single_sampler_matches_jax(sampler):
    jmodel, params, port = models()
    tok, lengths = tokens(2, 2), np.array([20, 13])
    rng = jax.random.key(9)
    want = np.asarray(jt.make_single_sampler(jmodel, jg.make_schedule(jg.linear_betas(100)),
                                             T=T, dim_pose=FEATS, sampler=sampler,
                                             ddim_steps=5)(
        params, jnp.asarray(tok), jnp.asarray(lengths), rng))
    _, init_rng = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(init_rng, (2, T, FEATS), jnp.float32))
    sample = tt.make_single_sampler(port, tg.make_schedule(tg.linear_betas(100)), T=T,
                                    dim_pose=FEATS, sampler=sampler, ddim_steps=5)
    got = sample(t_(tok), t_(lengths), noise=t_(noise)).numpy()
    scale = np.abs(want).max()
    assert got.shape == (2, T, FEATS) and np.isfinite(got).all() and scale > 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


# --- data and the CLI -------------------------------------------------------------------


def write_single_data(root: str, dataset: str, seed: int = 0) -> None:
    """Synthetic HumanML3D (t2m) or KIT-ML (kit) data: (rows, D) clips with
    the init row last, caption files with whole-clip and segment captions
    (one segment's to_tag past the clip's end, one too short), clips too
    short and too long, Mean.npy / Std.npy of D + 3 entries, train.txt."""
    D = {"t2m": 263, "kit": 251}[dataset]
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    names = []
    for i, rows in enumerate([30, 45, 61, 62, 80, 101, 140, 199, 200, 250]):
        name = f"{dataset}_{i:03d}"
        names.append(name)
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"),
                rs.randn(rows, D).astype(np.float32))
        caps = [CAPS[(3 * i + j) % len(CAPS)] for j in range(3)]
        lines = [f"{caps[0]}#a/DET person/NOUN#0.0#0.0", f"{caps[1]}#x#nan#nan"]
        if rows >= 100:
            lines += [f"{caps[2]}#x#0.5#{rows / 20 + 3:.1f}",  # to_tag past the end: clamped
                      f"{caps[2]}#x#1.0#1.5"]  # 10 frames: too short
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names + ["missing_clip"]) + "\n")
    np.save(os.path.join(root, "Mean.npy"), rs.randn(D + 3).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), (0.5 + rs.rand(D + 3)).astype(np.float32))


@pytest.mark.parametrize("dataset", ["t2m", "kit"])
def test_single_dataset_batches_match_jax_bitwise(tmp_path, dataset):
    root = str(tmp_path / dataset)
    write_single_data(root, dataset)
    mean = np.load(os.path.join(root, "Mean.npy"))
    std = np.load(os.path.join(root, "Std.npy"))
    jcfg = jax_add_paths(JaxConfig(dataset_name=dataset, data_root=root))
    cfg = add_dataset_paths(ExperimentConfig(dataset_name=dataset, data_root=root))
    jds = jd.SingleMotionDataset(jcfg, mean, std, "train.txt", times=2, seed=3)
    tds = td.SingleMotionDataset(cfg, mean, std, "train.txt", times=2, seed=3)
    assert [c.name for c in tds.clips] == [c.name for c in jds.clips]
    assert any(c.name.startswith("S2_") for c in tds.clips)  # the clamped segment
    assert not any(c.name.startswith("S3_") for c in tds.clips)  # the short one
    for a, b in zip(tds.clips, jds.clips):
        np.testing.assert_array_equal(a.motion, b.motion)
        assert a.texts == b.texts and a.length == b.length
    count = 0
    for epoch in (0, 1):
        for drop_last in (True, False):
            pairs = zip(jd.epoch_batches(jds, 4, epoch, drop_last=drop_last, seed=3),
                        td.epoch_batches(tds, 4, epoch, drop_last=drop_last, seed=3),
                        strict=True)
            for want, got in pairs:
                assert got["tokens"].shape == (4, 77)
                for key in ("motion", "lengths", "tokens", "class_id"):
                    assert got[key].dtype == want[key].dtype, key
                    np.testing.assert_array_equal(got[key], want[key])
                assert got["names"] == want["names"]
                count += 1
    assert count > 8


def run_single(root: str, ckpt_dir: str, *extra):
    from hig_tpu_torch.train_single import main

    return main(["--name", "single", "--dataset_name", "t2m", "--data_root", root,
                 "--checkpoints_dir", ckpt_dir, "--num_layers", "2", "--latent_dim", "32",
                 "--ff_size", "64", "--num_heads", "4", "--text_latent_dim", "16",
                 "--text_ff_size", "32", "--text_num_heads", "2", "--num_text_layers", "1",
                 "--diffusion_steps", "100", "--batch_size", "4", "--log_every", "1",
                 "--window", "20", "--device", "cpu", *extra], clip_config=PORT_CLIP)


def test_train_single_cli_writes_its_run_and_resumes(tmp_path):
    """Two epochs in one run, and one epoch then --is_continue for the
    second: the same parameters, Adam moments and step, bit for bit."""
    root = str(tmp_path / "data")
    write_single_data(root, "t2m")
    whole = run_single(root, str(tmp_path / "a"), "--num_epochs", "2")
    run_dir = tmp_path / "a" / "t2m" / "single"
    opt = (run_dir / "opt.txt").read_text()
    assert "dataset_name: t2m" in opt and "dim_pose: 263" in opt
    lines = [json.loads(s) for s in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == whole.step and all(np.isfinite(r["loss_mot_rec"]) for r in lines)
    std = np.load(os.path.join(root, "Std.npy"))
    np.testing.assert_array_equal(np.load(run_dir / "meta" / "std.npy"),
                                  td.rescale_std_train(std, 22, 5.0))
    payload = ckpt.load(str(run_dir / "model" / "latest.pt"))
    assert payload["epoch"] == 2 and payload["step"] == whole.step > 2

    run_single(root, str(tmp_path / "b"), "--num_epochs", "1")
    resumed = run_single(root, str(tmp_path / "b"), "--num_epochs", "2", "--is_continue")
    assert resumed.step == whole.step
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(whole.optimizer.exp_avg_sq, resumed.optimizer.exp_avg_sq):
        assert torch.equal(a, b)
