"""Parity of the port's progressive distillation and likelihood terms with
hig_tpu on the CPU.

- The likelihood terms (``normal_kl`` to ``prior_bpd``) within 1e-5 of the
  reference's largest magnitude; ``calc_bpd_loop`` of a closed-form
  denoiser with JAX's per-step draws fed in, within 1e-5.
- The distillation grids equal to JAX's as integers over a sweep of (T, N,
  teacher_steps), the 2 → 1 rung (mid = 0), the too-dense ``ValueError``
  and the halving ladder; ``ddim_step`` and ``distill_targets`` of a
  closed-form teacher within 1e-5.
- The distillation loss and every student gradient against
  ``jax.value_and_grad`` of JAX's ``make_distill_loss`` with JAX's draws
  (grid index, noise, keep) fed in, at the train step's tolerances (loss
  1e-5 relative, each leaf 1e-4 of its largest magnitude, the key biases'
  exact-zero gradients below 1e-6 of the tree's largest): plain, CFG
  branchwise (distill_w = 1 with caption dropout) and fixed-w guided
  (distill_w = 2.5). The port's teacher is fused (B1's plain version here),
  JAX's unfused: they compute the same function. The refusals of a non-CFG
  ``distill_w`` and of a ``fused_blocks`` student (JAX's step raises there).
- The step: a stage's teacher copied in place is the one the next stage's
  step reads; ``python -m hig_tpu_torch.distill`` for one tiny stage (its
  directory, opt.txt, checkpoint and metrics) and ``serve`` of that stage
  at DDIM-N. Graphed against eager runs on the card (``test_torch_cuda.py``).

Tiny widths, ``torch.set_num_threads(1)``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.diffusion import distill as jd
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu.models.text_encoder import ClipTextConfig as JaxClip
from hig_tpu_torch.config import ExperimentConfig, model_config
from hig_tpu_torch.data.vocab import CAPS, CLASSID2CAPS
from hig_tpu_torch.diffusion import distill as td
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree, torch_state_from_flax

TINY = dict(num_layers=2, latent_dim=32, ff_size=64, num_heads=4, num_text_layers=1,
            text_latent_dim=16, text_ff_size=32, text_num_heads=2, diffusion_steps=50)
PORT_CLIP = ClipTextConfig(width=32, heads=2, layers=1)
JAX_CLIP = JaxClip(width=32, heads=2, layers=1)
B, T, FEATS = 4, 12, 263
LENGTHS = np.array([12, 7, 10, 3])
TOL = 1e-5
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL = 1e-5, 1e-4, 1e-6
# leaves whose exact gradient is 0: every key bias (a softmax over the keys
# ignores it) and, over a caption id's one text token, the text
# cross-attention's query, key and norm
KEY_BIAS = "_block.key.bias"
CAP_ID_ZERO_GRAD = (KEY_BIAS, ".ca_block.key.weight", ".ca_block.query.weight",
                    ".ca_block.query.bias", ".ca_block.norm.weight", ".ca_block.norm.bias")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def schedules(steps=50):
    return jg.make_schedule(jg.linear_betas(steps)), tg.make_schedule(tg.linear_betas(steps))


# --- the likelihood terms ---------------------------------------------------------


def test_likelihood_terms_match_jax():
    """Each term within 1e-5. The discretized likelihood (and the vb term,
    which takes it at t = 0) in float64 on both sides
    (``jax.enable_x64``): a bin's mass cdf(a + δ) − cdf(a − δ)
    away from the mean cancels to a few float32 ulps of 1, where XLA's
    float32 tanh approximation (~1e-6 absolute) and torch's differ and the
    log magnifies it; in float64 both compute the formula."""
    js, ts = schedules(100)
    m1, m2, lv1, lv2 = (rand(3, 7, seed=s, scale=0.7) for s in (4, 5, 6, 7))
    close(tg.normal_kl(*map(torch.from_numpy, (m1, lv1, m2, lv2))), jg.normal_kl(m1, lv1, m2, lv2))
    a = rand(3, 7, seed=3, scale=3.0)
    close(tg._approx_standard_normal_cdf(torch.from_numpy(a)), jg._approx_standard_normal_cdf(a))
    x0 = np.clip(rand(3, 2, 5, 7, seed=1), -1.2, 1.2)  # both sides of the ±0.999 edges
    close(tg.prior_bpd(ts, torch.from_numpy(x0)), jg.prior_bpd(js, jnp.asarray(x0)))
    x0 = x0.astype(np.float64)
    x_t, out = rand(3, 2, 5, 7, seed=2).astype(np.float64), rand(3, 2, 5, 7, seed=3, scale=0.5)
    log_scales = lv1[0].astype(np.float64)
    t = np.array([0, 37, 99])
    with jax.enable_x64(True):
        want_ll = jg.discretized_gaussian_log_likelihood(jnp.asarray(x0), jnp.asarray(x_t),
                                                         jnp.asarray(log_scales))
        want, want_x0 = jg.vb_terms_bpd(js, jnp.asarray(out, jnp.float64), jnp.asarray(x0),
                                        jnp.asarray(x_t), jnp.asarray(t))
        assert want.dtype == jnp.float64
        want_ll, want, want_x0 = map(np.asarray, (want_ll, want, want_x0))
    close(tg.discretized_gaussian_log_likelihood(
        *map(torch.from_numpy, (x0, x_t, log_scales))), want_ll)
    got, got_x0 = tg.vb_terms_bpd(ts, torch.from_numpy(out).double(), torch.from_numpy(x0),
                                  torch.from_numpy(x_t), torch.from_numpy(t))
    close(got, want)
    close(got_x0, want_x0)


def test_calc_bpd_loop_matches_jax_with_its_draws():
    js, ts = schedules(100)
    x0 = rand(2, 2, 4, 6, seed=8, scale=0.5)
    w = rand(6, 6, seed=9, scale=0.3)

    def model(x, t, lib):
        return lib.tanh(x @ lib.asarray(w)) * 0.5 + 0.01 * t.reshape(-1, 1, 1, 1)

    key = jax.random.key(4)
    want = jg.calc_bpd_loop(js, lambda x, t: model(x, t, jnp), jnp.asarray(x0), key)
    draws, rng = [], key
    for _ in range(100):  # the scan's chain: split, draw with the second key
        rng, noise_rng = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(noise_rng, x0.shape, jnp.float32)))

    class Lib:
        tanh, asarray = staticmethod(torch.tanh), staticmethod(torch.from_numpy)

    got = tg.calc_bpd_loop(ts, lambda x, t: model(x, t.float(), Lib), torch.from_numpy(x0),
                           noise=torch.from_numpy(np.stack(draws)))
    for k in ("total_bpd", "prior_bpd", "vb", "mse"):
        close(got[k], want[k])


# --- grids and targets ------------------------------------------------------------


@pytest.mark.parametrize("T,N,teacher", [(100, 10, None), (100, 5, 9), (1000, 25, 50),
                                         (1000, 13, 25), (1000, 7, 13), (1000, 4, 7),
                                         (1000, 2, 4), (1000, 1, 2), (50, 25, 50), (37, 6, 11)])
def test_distill_grids_equal_jax(T, N, teacher):
    want, got = jd.distill_grids(T, N, teacher), td.distill_grids(T, N, teacher)
    for name in ("ts", "ts_prev", "ts_mid"):
        assert np.array_equal(getattr(got, name), np.asarray(getattr(want, name), np.int64)), name
    if N == 1:  # the 2 -> 1 rung: the 2-step teacher's own grid {T-1, 0}
        assert got.ts_mid.tolist() == [0]


def test_distill_grid_refusal_and_ladder():
    for args in ((100, 80), (50, 30)):
        with pytest.raises(ValueError, match="too dense"):
            jd.distill_grids(*args)
        with pytest.raises(ValueError, match="too dense"):
            td.distill_grids(*args)
    for args in ((50,), (8, 2), (2, 1), (1000, 4)):
        assert td.halving_stages(*args) == jd.halving_stages(*args)


def test_ddim_step_and_targets_match_jax():
    js, ts = schedules()
    x = rand(5, 2, 6, 7, seed=11)
    eps = rand(5, 2, 6, 7, seed=12)
    t = np.array([49, 30, 12, 0, 5])
    t_mid = np.array([40, 20, 6, 0, 3])
    t_prev = np.array([30, 12, 0, -1, -1])
    close(td.ddim_step(ts, *map(torch.from_numpy, (x, eps, t, t_prev))),
          jd.ddim_step(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(t_prev)))
    w = rand(7, 7, seed=13, scale=0.3)

    def teacher(xx, tt, lib, asarray):  # a closed-form eps predictor
        return lib.tanh(xx @ asarray(w)) + 0.02 * tt.reshape(-1, 1, 1, 1)

    want_x0, want_w = jd.distill_targets(js, lambda a, b: teacher(a, b, jnp, jnp.asarray),
                                         *map(jnp.asarray, (x, t, t_mid, t_prev)))
    got_x0, got_w = td.distill_targets(
        ts, lambda a, b: teacher(a, b.float(), torch, torch.from_numpy),
        *map(torch.from_numpy, (x, t, t_mid, t_prev)))
    close(got_x0, want_x0)
    close(got_w, want_w)


# --- the loss and the student's gradients -----------------------------------------

MODES = {
    "plain_tokens": dict(cap_id=False, cond_drop_prob=0.0, distill_w=1.0),
    "cfg_branchwise": dict(cap_id=True, cond_drop_prob=0.5, distill_w=1.0),
    "fixed_w": dict(cap_id=True, cond_drop_prob=0.2, distill_w=2.5),
}


def batch_for(cap_id: bool, seed=0):
    rs = np.random.RandomState(seed)
    cap_ids = rs.randint(0, len(CAPS), (B, 2))
    batch = dict(motion=rand(B, 2, T, FEATS, seed=seed + 1), lengths=LENGTHS.astype(np.int32))
    if cap_id:
        batch["cap_ids"] = cap_ids.astype(np.int32)
    else:
        batch["tokens"] = tokenize(CAPS).astype(np.int32)[cap_ids]
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def models_for(mode):
    """(JAX model, port config, student tree, teacher tree)."""
    c = MODES[mode]
    fields = dict(TINY, cap_id=c["cap_id"], cond_drop_prob=c["cond_drop_prob"], label_path="x")
    jmodel = model_from_config(JaxConfig(**fields), clip_config=JAX_CLIP)
    mcfg = model_config(ExperimentConfig(**fields), PORT_CLIP)
    return jmodel, mcfg, random_flax_tree(mcfg, seed=0), random_flax_tree(mcfg, seed=1)


def port_pair(mcfg, student_tree, teacher_tree):
    student = load_flax_tree(InteractionModel(mcfg), student_tree["params"]).train()
    teacher = load_flax_tree(InteractionModel(dataclasses.replace(mcfg, fused_blocks=True)),
                             teacher_tree["params"]).eval().requires_grad_(False)
    return student, teacher


def jax_draws(rng, n_steps, drop_prob):
    i_rng, n_rng = jax.random.split(rng)
    i = np.asarray(jax.random.randint(i_rng, (B,), 0, n_steps))
    noise = np.asarray(jax.random.normal(n_rng, (B, 2, T, FEATS), jnp.float32))
    keep = None
    if drop_prob > 0.0:
        keep = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 7), 1.0 - drop_prob, (B,)))
    return i, noise, keep


@pytest.mark.parametrize("mode", list(MODES))
def test_distill_loss_and_student_grads_match_jax(mode):
    c = MODES[mode]
    jmodel, mcfg, s_tree, t_tree = models_for(mode)
    js, ts = schedules()
    grids = td.distill_grids(50, 10, teacher_steps=25)
    jgrids = jd.distill_grids(50, 10, teacher_steps=25)
    batch = batch_for(c["cap_id"])
    rng = jax.random.key(3)
    loss_fn = jd.make_distill_loss(jmodel, js, jgrids, distill_w=c["distill_w"])
    (want_loss, _), want = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, s_tree), jax.tree_util.tree_map(jnp.asarray, t_tree),
        jax.tree_util.tree_map(jnp.asarray, batch), rng)
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, want))
    i, noise, keep = jax_draws(rng, grids.num_steps, c["cond_drop_prob"])
    if mode == "cfg_branchwise":
        assert 0 < keep.sum() < B  # both branches in the batch

    student, teacher = port_pair(mcfg, s_tree, t_tree)
    port_loss = td.make_distill_loss(student, teacher, ts, grids, c["distill_w"])
    loss, aux = port_loss(torch_batch(batch), None, torch.from_numpy(i), torch.from_numpy(noise),
                          None if keep is None else torch.from_numpy(keep))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert torch.equal(aux["t"], torch.from_numpy(grids.ts[i]))
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in student.named_parameters()}
    assert not any(p.grad is not None for p in teacher.parameters())
    scale = max(float(v.abs().max()) for v in want.values())
    assert got.keys() == want.keys() and scale > 0.1
    zero = CAP_ID_ZERO_GRAD if c["cap_id"] else (KEY_BIAS,)
    for name, w in want.items():
        if name.endswith(zero):  # exact gradient 0: rounding noise only
            assert float(w.abs().max()) <= ZERO_GRAD_TOL * scale, name
            assert float(got[name].abs().max()) <= ZERO_GRAD_TOL * scale, name
            continue
        err = float((got[name] - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), (name, err, float(w.abs().max()))
    if mode == "fixed_w":  # the guidance is internalized: the null branch takes no gradient
        assert not got["null_xf_proj"].any() and not got["null_xf_token"].any()
    if mode == "cfg_branchwise":
        assert got["null_xf_token"].abs().sum() > 0


def test_distill_refusals():
    jmodel, mcfg, _, _ = models_for("plain_tokens")
    js, ts = schedules()
    grids = td.distill_grids(50, 10)
    with pytest.raises(ValueError, match="distill_w"):
        jd.make_distill_loss(jmodel, js, jd.distill_grids(50, 10), distill_w=2.0)
    student = InteractionModel(mcfg)
    with pytest.raises(ValueError, match="distill_w"):
        td.make_distill_loss(student, student, ts, grids, distill_w=2.0)
    fused = InteractionModel(dataclasses.replace(mcfg, fused_blocks=True))
    with pytest.raises(ValueError, match="fused_blocks"):
        td.make_distill_loss(fused, fused, ts, grids)


def test_stage_change_reads_the_new_teacher():
    """A stage's step after the teacher is copied in place from the student
    computes what a fresh teacher holding those weights gives; the step
    updates the student and leaves the teacher alone."""
    _, mcfg, s_tree, t_tree = models_for("cfg_branchwise")
    ts = tg.make_schedule(tg.linear_betas(50))
    student, teacher = port_pair(mcfg, s_tree, t_tree)
    batch = torch_batch(batch_for(True, seed=2))
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = tt.TrainState(model=student, optimizer=tt.make_optimizer(ExperimentConfig(**TINY),
                                                                      student))
    step1 = td.make_distill_step(ts, td.distill_grids(50, 10, 25), teacher, graph=False)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        m = step1(state, batch, gen)
    assert set(m) == set(td.DISTILL_METRICS) and state.ema is None
    assert all(torch.equal(before[k], v) for k, v in teacher.state_dict().items())
    teacher.load_state_dict(student.state_dict())  # the stage change
    grids2 = td.distill_grids(50, 5, 10)
    fresh = InteractionModel(dataclasses.replace(mcfg, fused_blocks=True)).eval()
    fresh.load_state_dict(student.state_dict())
    draws = (torch.tensor([0, 4, 2, 1]), torch.from_numpy(rand(B, 2, T, FEATS, seed=5)),
             torch.tensor([True, False, True, True]))
    want, _ = td.make_distill_loss(student, fresh, ts, grids2)(batch, None, *draws)
    state2 = tt.TrainState(model=student, optimizer=tt.make_optimizer(ExperimentConfig(**TINY),
                                                                      student))
    got = td.make_distill_step(ts, grids2, teacher, graph=False)(state2, batch, None, *draws)
    assert float(got["loss_distill"]) == float(want)


# --- the CLI ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def cfg_run(tmp_path_factory):
    """A tiny supervised caption-id CFG run (DDIM-10 over 40 steps)."""
    from hig_tpu_torch.data.synthetic import generate_dataset
    from hig_tpu_torch.train.__main__ import main as train_main

    base = tmp_path_factory.mktemp("distill")
    root = str(base / "data")
    generate_dataset(root, clips_per_class=1, min_frames=30, max_frames=40, seed=0,
                     device="cpu", splits={"train_sub.txt": 1.0})
    with open(os.path.join(root, "train_sub.txt")) as f:
        names = f.read().split()
    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump({n: i % 2 for i, n in enumerate(names)}, f)
    widths = [a for k, v in TINY.items() if k != "diffusion_steps" for a in (f"--{k}", str(v))]
    train_main(["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", root,
                "--checkpoints_dir", str(base / "ck"), "--batch_size", "8", "--cap_id",
                "--label_path", os.path.join(root, "labels.json"), "--diffusion_steps", "40",
                "--sampler", "ddim", "--ddim_steps", "10", "--cond_drop_prob", "0.1",
                "--name", "cfg", "--num_epochs", "1", "--log_every", "1"] + widths)
    return str(base / "ck" / "synthetic_mul" / "cfg"), base


@pytest.mark.parametrize("distill_w", [1.0, 2.5])
def test_distill_cli_writes_a_stage_that_serve_samples(cfg_run, distill_w, capsys, monkeypatch):
    from hig_tpu_torch import distill, serve

    made = []

    def spy(*args, **kw):
        made.append(kw)
        return tt.make_sampler(*args, **kw)

    monkeypatch.setattr(serve, "make_sampler", spy)

    run, base = cfg_run
    name = f"w{distill_w}"
    out = distill.main(["--opt_path", os.path.join(run, "opt.txt"), "--stages", "5",
                        "--epochs_per_stage", "1", "--distill_w", str(distill_w),
                        "--log_every", "1", "--device", "cpu"])
    stage = run + "_distill5"
    assert out == [stage]
    opt = open(os.path.join(stage, "opt.txt")).read()
    assert "sampler: ddim" in opt and "ddim_steps: 5" in opt and "name: cfg_distill5" in opt
    assert "guidance_scale: 1.0" in opt
    for f in ("model/latest.pt", "meta/mean.npy", "meta/std.npy"):
        assert os.path.exists(os.path.join(stage, f)), f
    payload = ckpt.load(os.path.join(stage, "model", "latest.pt"))
    assert "ema_params" not in payload and payload["step"] == 3
    teacher = ckpt.load(os.path.join(run, "model", "latest.pt"))["params"]
    assert any(not torch.equal(teacher[k], v) for k, v in payload["params"].items())
    lines = [json.loads(x) for x in open(os.path.join(stage, "metrics.jsonl"))][-3:]
    assert [x["it"] for x in lines] == [1, 2, 3]
    assert all(set(x) == {"stage", "it", "epoch", "loss_distill", "grad_norm"}
               and x["stage"] == 5 and np.isfinite(x["loss_distill"]) for x in lines)
    printed = capsys.readouterr().out
    assert "distillation ladder: 10 -> [5]" in printed

    reqs = base / f"reqs_{name}.jsonl"
    reqs.write_text(json.dumps({"caption1": CLASSID2CAPS[0][0], "caption2": CLASSID2CAPS[0][1],
                                "length": 15, "id": "a"}) + "\n")
    serve.main(["--requests", str(reqs), "--opt_path", os.path.join(stage, "opt.txt"),
                "--device", "cpu", "--out_dir", str(base / name)])
    served = np.load(base / name / "a.npz")
    assert served["features"].shape == (2, 16, FEATS) and np.isfinite(served["joints"]).all()
    # DDIM-5, unguided, from the stage's opt.txt
    assert [(m["sampler"], m["ddim_steps"], m["guidance_scale"]) for m in made] == \
        [("ddim", 5, 1.0)]


def test_distill_cli_refuses_guided_without_cfg(tmp_path, capsys):
    from hig_tpu_torch import distill
    from hig_tpu_torch.config import save_opt_txt

    cfg = ExperimentConfig(**TINY, checkpoints_dir=str(tmp_path), dataset_name="synthetic_mul",
                           data_root=str(tmp_path))
    opt = os.path.join(cfg.save_root, "opt.txt")
    save_opt_txt(cfg, opt)
    with pytest.raises(SystemExit):
        distill.main(["--opt_path", opt, "--distill_w", "2.0", "--device", "cpu"])
    assert "CFG teacher" in capsys.readouterr().err
