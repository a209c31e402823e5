"""Parity of the PyTorch port's samplers against hig_tpu on the CPU.

- The beta schedules and float64 tables equal JAX's.
- ``p_mean_variance`` over both variance types, both mean types and x0
  clipping on/off, ``condition_mean`` and ``condition_score``, within 1e-6.
- The loops on a toy denoiser from JAX's key chain (x_T, each step's noise,
  the prefix and pin draws replayed into the port's hooks): DDPM with the
  ``pre_seq`` and ``transl_req`` hooks and classifier guidance, general DDIM
  at eta 0.5 with x0 clipping, DPM-Solver++(2M) at 5 and 20 steps; the
  general DDIM step as eta → 0 is the fast path.
- ``make_sampler("ddpm")`` through the whole model (caption tokens and
  caption ids, w ∈ {1, 2.5}) within 1e-5 of the output scale of JAX's
  ``make_sampler`` fed the same draws; DDPM builds no AdaLN grid.
- ``serve --sampler`` and ``--opt_path`` (the run's sampler and
  ddim_steps); ``load_opt_txt`` on an ``opt.txt`` written by
  ``hig_tpu.config.save_opt_txt``: model keys off their defaults refused
  by name, route keys accepted.

Tiny widths, ``diffusion_steps`` 100 and ``torch.set_num_threads(1)``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu import config as jcfg
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.diffusion import solvers as jsolvers
from hig_tpu.train import trainer as jt
from hig_tpu_torch import serve
from hig_tpu_torch.config import ExperimentConfig, load_opt_txt, model_config, save_opt_txt
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.diffusion import solvers as tsolvers
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.train import trainer as tt
from tests.test_torch_pipeline import FEATS, TINY, models, rand, t_

STEPS = 100
TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def schedules(name="linear"):
    betas = jg.named_betas(name, STEPS)
    return jg.make_schedule(betas), tg.make_schedule(tg.named_betas(name, STEPS))


def assert_scaled_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_beta_tables_equal_jax(name):
    want = jg.named_betas(name, STEPS)
    got = tg.named_betas(name, STEPS)
    np.testing.assert_array_equal(got, want)
    jt64, tt64 = jg.schedule_tables_f64(want), tg.schedule_tables_f64(got)
    assert jt64.keys() == tt64.keys()
    for k in jt64:
        np.testing.assert_array_equal(tt64[k], jt64[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown beta schedule"):
        tg.named_betas("quadratic", STEPS)


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("mean_type", ["EPSILON", "START_X"])
@pytest.mark.parametrize("var_type", ["FIXED_SMALL", "FIXED_LARGE"])
def test_p_mean_variance_matches_jax(var_type, mean_type, clip):
    jsched, tsched = schedules()
    x, out = rand(4, 2, 6, 5, seed=1), rand(4, 2, 6, 5, seed=2)
    t = np.array([0, 1, 57, 99])
    want = jg.p_mean_variance(jsched, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t),
                              jg.MeanType[mean_type], jg.VarType[var_type], clip)
    got = tg.p_mean_variance(tsched, t_(out), t_(x), t_(t), tg.MeanType[mean_type],
                             tg.VarType[var_type], clip)
    for a, b in zip(got, want):
        assert_scaled_close(a, b, TOL)


def test_condition_mean_and_score_match_jax():
    jsched, tsched = schedules()
    x, x0, mean = rand(3, 7, 5, seed=3), rand(3, 7, 5, seed=4), rand(3, 7, 5, seed=5)
    var, t = rand(3, 1, 1, seed=6) ** 2, np.array([2, 40, 98])
    jfn = lambda x, t: -0.3 * x + 0.01 * t[:, None, None]  # noqa: E731
    tfn = lambda x, t: -0.3 * x + 0.01 * t[:, None, None]  # noqa: E731
    want = jg.condition_mean(jsched, jfn, *map(jnp.asarray, (mean, var, x, t)))
    got = tg.condition_mean(tsched, tfn, *map(t_, (mean, var, x, t)))
    assert_scaled_close(got, want, TOL)
    want = jg.condition_score(jsched, jfn, *map(jnp.asarray, (x0, x, t)))
    got = tg.condition_score(tsched, tfn, *map(t_, (x0, x, t)))
    for a, b in zip(got, want):
        assert_scaled_close(a, b, TOL)


def toy_models():
    """The same toy denoiser in both packages: eps = 0.5·tanh(x) + t/1000."""
    def jmodel(x, t, aux=None):
        return 0.5 * jnp.tanh(x) + (t.astype(jnp.float32) / 1000.0).reshape(-1, 1, 1)

    def tmodel(x, t, aux=None):
        return 0.5 * torch.tanh(x) + (t.float() / 1000.0).reshape(-1, 1, 1)

    return jmodel, tmodel


def jax_ddpm_draws(rng, shape, pre_shape=None, pins=0):
    """What JAX's p_sample_loop draws: x_T from split(rng)[1], then per step
    (rng, noise_rng, pre_rng) = split(rng, 3): z from noise_rng, the prefix
    noise from pre_rng and pin i from fold_in(pre_rng, i + 1)."""
    rng, init = jax.random.split(rng)
    x_t = np.asarray(jax.random.normal(init, shape, jnp.float32))

    @jax.jit
    def chain(rng):
        def step(rng, _):
            rng, noise_rng, pre_rng = jax.random.split(rng, 3)
            out = {"z": jax.random.normal(noise_rng, shape, jnp.float32)}
            if pre_shape is not None:
                out["pre"] = jax.random.normal(pre_rng, pre_shape, jnp.float32)
            out["pins"] = jnp.stack([jax.random.normal(jax.random.fold_in(pre_rng, i + 1),
                                                       (shape[0], 2), jnp.float32)
                                     for i in range(pins)]) if pins else jnp.zeros(())
            return rng, out

        return jax.lax.scan(step, rng, None, length=STEPS)[1]

    draws = {k: np.asarray(v) for k, v in chain(rng).items()}
    return t_(x_t), draws


def test_ddpm_loop_on_a_toy_denoiser_matches_jax():
    """Every hook at once: the prefix re-noised each step, two root pins,
    classifier guidance."""
    jsched, tsched = schedules()
    jmodel, tmodel = toy_models()
    shape, rng = (2, 8, 5), jax.random.key(3)
    pre_seq = rand(*shape, seed=7)
    transl = [(4, 0.5, -0.25), (6, -1.0, 0.75)]
    pre_shape, pins = shape, len(transl)
    kw_j = dict(pre_seq=jnp.asarray(pre_seq), pre_seq_len=3, transl_req=transl,
                cond_fn=lambda x, t: -0.1 * x)
    kw_t = dict(pre_seq=t_(pre_seq), pre_seq_len=3, transl_req=transl,
                cond_fn=lambda x, t: -0.1 * x)
    want = jax.jit(lambda rng: jg.p_sample_loop(jsched, jmodel, shape, rng, **kw_j))(rng)
    x_t, d = jax_ddpm_draws(rng, shape, pre_shape, pins)
    got = tg.p_sample_loop(tsched, tmodel, x_t, step_noise=lambda i: t_(d["z"][i]),
                           pre_noise=lambda i: t_(d["pre"][i]),
                           pin_noise=lambda i, p: t_(d["pins"][i, p]), **kw_t)
    assert_scaled_close(got, want, 1e-5)


def test_ddpm_loop_draws_from_its_generator():
    _, tsched = schedules()
    _, tmodel = toy_models()
    x_t = t_(rand(2, 8, 5, seed=1))
    runs = [tg.p_sample_loop(tsched, tmodel, x_t, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="per-step draws or a torch.Generator"):
        tg.p_sample_loop(tsched, tmodel, x_t)


def test_general_ddim_matches_jax():
    """eta 0.5 with x0 clipping over 10 steps, JAX's per-step draws
    ((rng, noise_rng) = split(rng)); and the general step as eta → 0 is the
    fast path."""
    jsched, tsched = schedules()
    jmodel, tmodel = toy_models()
    shape, rng, n = (2, 8, 5), jax.random.key(5), 10
    want = jax.jit(lambda rng: jg.ddim_sample_loop(jsched, jmodel, shape, rng, num_steps=n,
                                                   eta=0.5, clip_denoised=True))(rng)
    rng, init = jax.random.split(rng)
    zs = []
    for _ in range(n):
        rng, noise_rng = jax.random.split(rng)
        zs.append(t_(np.asarray(jax.random.normal(noise_rng, shape, jnp.float32))))
    x_t = t_(np.asarray(jax.random.normal(init, shape, jnp.float32)))
    got = tg.ddim_sample_loop(tsched, tmodel, x_t, num_steps=n, eta=0.5, clip_denoised=True,
                              step_noise=lambda i: zs[i])
    assert_scaled_close(got, want, 1e-5)
    fast = tg.ddim_sample_loop(tsched, tmodel, x_t, num_steps=n)
    want_fast = jg.ddim_sample_loop(jsched, jmodel, shape, jax.random.key(0), num_steps=n,
                                    noise=jnp.asarray(x_t.numpy()))
    assert_scaled_close(fast, want_fast, 1e-5)
    near_zero = tg.ddim_sample_loop(tsched, tmodel, x_t, num_steps=n, eta=1e-12,
                                    generator=torch.Generator().manual_seed(0))
    assert_scaled_close(near_zero, fast, 1e-5)


@pytest.mark.parametrize("steps", [5, 20])
def test_dpm_solver_matches_jax(steps):
    jsched, tsched = schedules()
    jmodel, tmodel = toy_models()
    x_t = rand(3, 8, 5, seed=9)
    want = jsolvers.dpmpp_2m_sample_loop(jsched, jmodel, x_t.shape, jax.random.key(0),
                                         num_steps=steps,
                                         noise=jnp.asarray(x_t))
    got = tsolvers.dpmpp_2m_sample_loop(tsched, tmodel, t_(x_t), num_steps=steps)
    assert_scaled_close(got, want, 1e-5)


# --- make_sampler through the whole model --------------------------------------------


@pytest.mark.parametrize("cap_id,w", [(False, 2.5), (True, 1.0)],
                         ids=["tokens_guided", "cap_id"])
def test_ddpm_sampler_matches_jax(cap_id, w):
    """DDPM over the 100 steps of the tiny schedule, JAX's x_T and step
    noises replayed; 1e-5 of the output scale, the guided-DDIM test's
    measure."""
    jmodel, params, model = models(cap_id, drop=0.1)
    model.eval()
    cond = (np.array([[3, 4], [10, 11]], np.int32) if cap_id
            else tokenize(CAPS).astype(np.int32)[[[3, 4], [10, 11]]])
    lengths, Tg = np.array([12, 7], np.int32), 12
    jsched, tsched = schedules()
    rng = jax.random.key(13)
    jsample = jt.make_sampler(jmodel, jsched, T=Tg, dim_pose=FEATS, sampler="ddpm",
                              guidance_scale=w)
    want = np.asarray(jsample(params, jnp.asarray(cond), jnp.asarray(lengths), rng))
    x_t, d = jax_ddpm_draws(rng, (2, 2, Tg, FEATS))
    sample = tt.make_sampler(model, tsched, T=Tg, dim_pose=FEATS, sampler="ddpm",
                             guidance_scale=w)
    got = sample(t_(cond).long(), t_(lengths), noise=x_t,
                 step_noise=lambda i: t_(d["z"][i])).numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm"])
def test_only_ddim_and_dpm_hoist_the_adaln_grid(sampler, monkeypatch):
    """DDPM runs 1000 steps: its grid would be 1000 × 2B sequences × 32
    blocks × 2·latent floats, 13.6 GB at 52 pairs. It never builds one."""
    _, _, model = models(cap_id=True)
    calls = []
    real = tt.adaln_scale_shift_grid
    monkeypatch.setattr(tt, "adaln_scale_shift_grid",
                        lambda *a: calls.append(len(a[1])) or real(*a))
    sample = tt.make_sampler(model.eval(), schedules()[1], T=8, dim_pose=FEATS,
                             sampler=sampler, ddim_steps=3)
    out = sample(torch.tensor([[1, 2]]), torch.tensor([8]),
                 generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 2, 8, FEATS) and torch.isfinite(out).all()
    assert calls == ([] if sampler == "ddpm" else [3])
    with pytest.raises(ValueError, match="unknown sampler"):
        tt.make_sampler(model, schedules()[1], T=8, dim_pose=FEATS, sampler="euler")


# --- serve and opt.txt -------------------------------------------------------------


def test_serve_picks_the_runs_sampler(tmp_path, monkeypatch):
    cfg = ExperimentConfig(**TINY, cap_id=True, sampler="dpm", ddim_steps=3,
                           checkpoints_dir=str(tmp_path / "runs"))
    opt = str(tmp_path / "runs" / "ntu_mul" / "test" / "opt.txt")
    save_opt_txt(cfg, opt)
    meta = tmp_path / "runs" / "ntu_mul" / "test" / "meta"
    meta.mkdir()
    np.save(meta / "mean.npy", np.zeros(FEATS + 4, np.float32))
    np.save(meta / "std.npy", np.ones(FEATS + 4, np.float32))
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"caption1": CAPS[0], "caption2": CAPS[1], "length": 6}) + "\n")
    picked = []
    real = serve.make_sampler

    def spy(*args, **kwargs):
        picked.append((kwargs["sampler"], kwargs["ddim_steps"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(serve, "make_sampler", spy)
    common = ["--requests", str(reqs), "--random_init", "0", "--device", "cpu",
              "--out_dir", str(tmp_path / "out")]
    serve.main(common + ["--opt_path", opt])
    serve.main(common + ["--opt_path", opt, "--sampler", "ddim", "--ddim_steps", "2"])
    with open(tmp_path / "tiny.json", "w") as f:
        json.dump({"latent_dim": 32, "ff_size": 64, "num_layers": 1, "num_heads": 4,
                   "text_latent_dim": 16, "cap_id": True}, f)
    serve.main(common + ["--model_config", str(tmp_path / "tiny.json"), "--ddim_steps", "2"])
    assert picked == [("dpm", 3), ("ddim", 2), ("ddim", 2)]
    served = np.load(tmp_path / "out" / "req0.npz")
    assert served["joints"].shape == (2, 6, 22, 3) and np.isfinite(served["joints"]).all()


MODEL_KEYS = {"fast_ln": True, "rms_norm": True, "only_language": True, "only_motion": True,
              "window_size": 60}
SERVED_MODEL_KEYS = ("fast_ln", "rms_norm")  # carried by the bf16 serving path


@pytest.mark.parametrize("key", list(MODEL_KEYS))
def test_load_opt_txt_refuses_jax_model_keys(tmp_path, key):
    """The JAX keys that change the model's function or its batches are all
    carried now, none refused: each loads into its field, fast_ln and
    rms_norm reach the model's config, and only_language, only_motion
    (--pretrained's filters) and window_size (the native loader's window)
    stay the run's."""
    path = str(tmp_path / "opt.txt")
    jcfg.save_opt_txt(jcfg.ExperimentConfig(**{key: MODEL_KEYS[key]}), path)
    cfg = load_opt_txt(path)
    assert getattr(cfg, key) == MODEL_KEYS[key]
    if key in SERVED_MODEL_KEYS:
        assert getattr(model_config(cfg), key) is True


def test_load_opt_txt_accepts_jax_route_keys(tmp_path):
    """A JAX run's opt.txt with every route key off its default loads, and
    its sampling fields are read."""
    path = str(tmp_path / "opt.txt")
    jax_run = jcfg.ExperimentConfig(
        **TINY, data_root="data/root", use_pallas=True, fused_blocks=True, sampler_unroll=4,
        distributed=True,
        mesh=jcfg.MeshConfig(data=2, model=2, dcn_data=2), label_model=True,
        save_label_dir="labels", multi=False, is_train=False, sampler="dpm", ddim_steps=20,
        which_epoch="ckpt_e004", split_file="val_sub.txt", result_path="out")
    jcfg.save_opt_txt(jax_run, path)
    cfg = load_opt_txt(path)
    assert (cfg.sampler, cfg.ddim_steps, cfg.which_epoch, cfg.split_file, cfg.result_path) == (
        "dpm", 20, "ckpt_e004", "val_sub.txt", "out")
    want = {f.name: getattr(jax_run, f.name) for f in dataclasses.fields(ExperimentConfig)}
    want["mesh"] = dataclasses.asdict(jax_run.mesh)  # the port's own MeshConfig
    assert dataclasses.asdict(cfg) == want
    default = str(tmp_path / "default.txt")
    jcfg.save_opt_txt(jcfg.ExperimentConfig(), default)
    assert load_opt_txt(default).sampler == "ddpm"
    assert os.path.exists(default)
