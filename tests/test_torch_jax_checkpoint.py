"""A JAX-trained run served by the port: a checkpoint written by JAX's
``save_state`` (orbax) is restored by JAX, its parameters flattened with
``np.savez`` under "params/..." keys, and served by ``python -m
hig_tpu_torch.serve --params x.npz --device cpu`` (a separate process,
which imports no JAX). The motion equals JAX's ``make_sampler`` on the same
x_T (``--noise``) within 1e-5 of its largest magnitude, the sampler tests'
measure. Tiny widths (tests/test_training.py's), caption ids and
caption tokens (the tiny CLIP tower: its widths in the model config)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.tokenizer import tokenize
from hig_tpu.train import checkpoint as jckpt
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, model_config
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.weights import flatten, random_flax_tree
from tests.test_training import TINY_CLIP, tiny_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLIP = ClipTextConfig(width=TINY_CLIP.width, heads=TINY_CLIP.heads, layers=TINY_CLIP.layers)
STEPS = 5


@pytest.mark.parametrize("cap_id", [True, False], ids=["cap_id", "tokens"])
def test_jax_checkpoint_served_by_the_port(tmp_path, cap_id):
    cfg = tiny_cfg(str(tmp_path), cap_id=cap_id, ema_decay=0.9)
    trainer = jt.Trainer(cfg, clip_config=TINY_CLIP)
    widths = {k: getattr(cfg, k) for k in ("num_layers", "latent_dim", "ff_size", "num_heads",
                                           "num_text_layers", "text_latent_dim",
                                           "text_ff_size", "text_num_heads")}
    mcfg = model_config(ExperimentConfig(**widths, cap_id=cap_id), PORT_CLIP)
    # every leaf nonzero (JAX's init zeroes the output heads); the EMA a
    # second seed's tree, so that serving must pick it
    params = jax.tree_util.tree_map(jnp.asarray, random_flax_tree(mcfg, 0))
    ema = jax.tree_util.tree_map(jnp.asarray, random_flax_tree(mcfg, 1))
    trainer.tx = jt.make_optimizer(cfg, params)
    state = jt.TrainState(params=params, opt_state=trainer.tx.init(params),
                          step=jnp.zeros((), jnp.int32), ema_params=ema)
    path = str(tmp_path / "model" / "latest")
    jckpt.save_state(path, state, 3, 7)

    # the recipe: restore with JAX, flatten, savez
    restored, epoch, _ = jckpt.restore_state(path, state)
    assert epoch == 3
    npz = str(tmp_path / "x.npz")
    tree = {"params": restored.params["params"], "ema_params": restored.ema_params["params"]}
    np.savez(npz, **{"/".join(k): np.asarray(v) for k, v in flatten(tree).items()})

    pairs = [(3, 4), (10, 11), (20, 5)]
    lengths = [11, 6, 9]
    T = max(lengths) + 1
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("".join(json.dumps({"caption1": CAPS[a], "caption2": CAPS[b], "length": n,
                                        "id": f"q{i}"}) + "\n"
                            for i, ((a, b), n) in enumerate(zip(pairs, lengths))))
    rng = jax.random.key(11)
    x_t = np.asarray(jax.random.normal(jax.random.split(rng)[1], (len(pairs), 2, T, 263)))
    np.save(tmp_path / "x_t.npy", x_t)
    (tmp_path / "model.json").write_text(json.dumps(dataclasses.asdict(mcfg)))
    out = tmp_path / "served"
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "hig_tpu_torch.serve",
         "--requests", str(reqs), "--params", npz, "--device",
         "cpu", "--model_config", str(tmp_path / "model.json"), "--sampler", "ddim",
         "--ddim_steps", str(STEPS), "--diffusion_steps", "100", "--blocks", "projected",
         "--noise", str(tmp_path / "x_t.npy"), "--out_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in res.stderr.splitlines() if line.startswith("import time:")}
    assert "hig_tpu_torch" in imported and not imported & {"jax", "jaxlib", "flax", "hig_tpu"}

    sample = jt.make_sampler(trainer.model, jg.make_schedule(jg.linear_betas(100)), T=T,
                             dim_pose=263, sampler="ddim", ddim_steps=STEPS)
    cond = (np.asarray(pairs, np.int32) if cap_id
            else tokenize(CAPS).astype(np.int32)[np.asarray(pairs)])
    want = np.asarray(sample(jt.eval_params(restored), jnp.asarray(cond),
                             jnp.asarray(np.asarray(lengths) + 1, jnp.int32), rng))
    scale = np.abs(want).max()
    assert np.isfinite(want).all() and scale > 1.0
    for i, n in enumerate(lengths):
        got = np.load(out / f"q{i}.npz")["features"]
        # the served features are de-normalized by identity stats: x itself
        np.testing.assert_allclose(got, want[i, :, :n + 1], atol=1e-5 * scale, rtol=0)
