"""Parity of the PyTorch port's training path against hig_tpu on the CPU.

- The backwards of B2, B3 and B4 (``*_backward``, which recompute the plain
  versions) against ``jax.vjp`` of the JAX wrappers, Pallas in interpret
  mode: 2e-5 of the reference's largest magnitude (B2's key bias, whose
  exact gradient is 0, within 2e-5 of the largest of all its gradients). The autograd Functions
  around the kernels, with the launch swapped for the plain forward (a CUDA
  kernel cannot run here), against autograd through the plain versions.
- ``q_sample`` / ``training_targets`` and the three losses: 1e-6 relative.
- Whole-step loss and gradients against ``jax.value_and_grad`` of
  ``make_loss_fn`` (its einsum path, the VJP its Pallas kernels carry), for
  PIT and supervised, efficient and ``no_eff``, the tower-feature and the
  tokens-only conditioning, ``grad_accum=2``, and PIT and supervised at
  ``dropout=0.5`` (JAX runs every path deterministically, so dropout is
  the identity in both packages), and PIT with ``causal`` efficient
  attention (the causal core, no kernel); JAX's t and noise are
  drawn with its own ``jax.random.split`` and handed to the port. Loss within
  1e-5 relative, every gradient leaf within 1e-4 of its largest magnitude.
  The key biases of the attention blocks have an exact gradient of 0 (a
  constant added to every key leaves a softmax over the keys unchanged), so
  both packages hold rounding noise there: those leaves must stay below
  1e-6 of the largest gradient of the tree instead.
- The optimizer fed identical gradients, against optax, for the constant,
  warmup and cosine schedules: parameters and EMA within 1e-6 after 3 steps,
  CLIP unchanged.
- The data pipeline against JAX's (bit for bit), the config, the trainer's
  resume (bit for bit) and rollback, and serving a trained checkpoint.

Tiny widths (2 layers, latent 32) and ``torch.set_num_threads(1)``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.config import add_dataset_paths as jax_add_paths
from hig_tpu.data import dataset as jd
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu.models.text_encoder import ClipTextConfig as JaxClip
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths, model_config
from hig_tpu_torch.data import dataset as td
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.ops import flash_attention as fa
from hig_tpu_torch.ops import pallas_attention as pa
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree, torch_state_from_flax

TINY = dict(num_layers=2, latent_dim=32, ff_size=64, num_heads=4, num_text_layers=1,
            text_latent_dim=16, text_ff_size=32, text_num_heads=2, diffusion_steps=100)
PORT_CLIP = ClipTextConfig(width=32, heads=2, layers=1)
JAX_CLIP = JaxClip(width=32, heads=2, layers=1)
H, D = 4, 32
B, T, FEATS = 4, 16, 263
LENGTHS = np.array([16, 9, 12, 5], np.int32)
KERNEL_TOL = 2e-5  # of the reference's largest magnitude
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL = 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    """26 synthetic clips of 101 rows (the random-window path) in the
    reference's layout, written by the JAX package's generator."""
    from hig_tpu.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("train_synth") / "data")
    generate_dataset(root, clips_per_class=1, min_frames=100, max_frames=101, seed=0)
    return root


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


def assert_rel_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max(), rtol=0)


def actor_mask(Tk=12):
    return (np.arange(Tk) < np.array([[12, 5], [7, 10]])[..., None]).astype(np.float32)


def port_cfg(**kw):
    return ExperimentConfig(**TINY, **kw)


def port_model(cfg):
    mcfg = model_config(cfg, PORT_CLIP)
    return load_flax_tree(InteractionModel(mcfg), random_flax_tree(mcfg, seed=0)["params"])


# --- backwards of the kernels against jax.vjp (Pallas in interpret mode) --------


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
def test_projected_attention_backward_matches_jax_vjp(same_source):
    from hig_tpu.ops.pallas_attention import fused_projected_attention as pallas_proj

    q_src = rand(2, 2, 12, D, seed=1)
    kv_src = q_src if same_source else rand(2, 2, 12, D, seed=2)
    ws = [rand(D, D, seed=3 + i, scale=D ** -0.5) if i % 2 == 0 else rand(D, seed=3 + i, scale=0.1)
          for i in range(6)]  # wq, bq, wk, bk, wv, bv in (in, out) layout
    mask, g = actor_mask(), rand(2, 2, 12, D, seed=9)
    _, vjp = jax.vjp(lambda *a: pallas_proj(*a, H, key_mask=jnp.asarray(mask), interpret=True),
                     jnp.asarray(q_src), jnp.asarray(kv_src), *map(jnp.asarray, ws))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tws = [t_(w.T.copy()) if w.ndim == 2 else t_(w) for w in ws]
    tq = t_(q_src)
    saved = (tq, tq if same_source else t_(kv_src), *tws, t_(mask))
    got = pa.projected_attention_backward(saved, t_(g), H, merged=same_source)
    if same_source:  # one input: its gradient holds both shares
        assert got[1] is None
        assert_rel_close(got[0], want[0] + want[1], KERNEL_TOL)
    else:
        assert_rel_close(got[0], want[0], KERNEL_TOL)
        assert_rel_close(got[1], want[1], KERNEL_TOL)
    scale = max(np.abs(w).max() for w in want)
    for i in range(2, 8):
        g_i = got[i].T if got[i].ndim == 2 else got[i]
        if i == 5:  # bk: the exact gradient is 0 (softmax over time ignores it)
            assert np.abs(want[i]).max() <= KERNEL_TOL * scale
            assert float(g_i.abs().max()) <= KERNEL_TOL * scale
            continue
        assert_rel_close(g_i, want[i], KERNEL_TOL)


def test_efficient_attention_backward_matches_jax_vjp():
    from hig_tpu.ops.pallas_attention import fused_efficient_attention as pallas_core

    q, k, v = rand(2, 2, 12, D, seed=1), rand(2, 2, 9, D, seed=2), rand(2, 2, 9, D, seed=3)
    mask, g = actor_mask(9), rand(2, 2, 12, D, seed=4)
    _, vjp = jax.vjp(lambda *a: pallas_core(*a, H, key_mask=jnp.asarray(mask), interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = pa.efficient_attention_backward((t_(q), t_(k), t_(v), t_(mask)), t_(g), H)
    for a, b in zip(got, want):
        assert_rel_close(a, b, KERNEL_TOL)


@pytest.mark.parametrize("case", ["self", "partner", "causal"])
def test_flash_attention_backward_matches_jax_vjp(case):
    from hig_tpu.ops.flash_attention import flash_attention as pallas_flash

    q, k, v = rand(2, 2, 12, D, seed=5), rand(2, 2, 12, D, seed=6), rand(2, 2, 12, D, seed=7)
    mask, g = actor_mask(), rand(2, 2, 12, D, seed=8)
    causal, partner = case == "causal", case == "partner"
    jk, jv, jm = jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)
    if partner:  # the Pallas kernel has no partner flag: flip on the actor axis
        jk, jv, jm = jnp.flip(jk, 1), jnp.flip(jv, 1), jnp.flip(jm, 1)
    _, vjp = jax.vjp(lambda *a: pallas_flash(*a, H, key_mask=jm, causal=causal, interpret=True),
                     jnp.asarray(q), jk, jv)
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    if partner:
        want[1], want[2] = want[1][:, ::-1], want[2][:, ::-1]
    got = fa.flash_attention_backward((t_(q), t_(k), t_(v), t_(mask)), t_(g), H, causal, partner)
    for a, b in zip(got, want):
        assert_rel_close(a, b, KERNEL_TOL)


@pytest.mark.parametrize("kernel", ["projected_self", "projected_partner", "efficient",
                                    "flash_self", "flash_partner_causal"])
def test_autograd_functions_carry_the_gradients(monkeypatch, kernel):
    """Each kernel's autograd Function, its launch replaced by the plain
    forward, passes back the gradients of autograd through the plain version:
    to q_src twice over when kv_src is q_src, and through B4's q/k/v views to
    the merged projection they were cut from."""
    monkeypatch.setattr(pa, "_launch_projected",
                        lambda q, kv, *w_mask: pa.fused_projected_attention_plain(
                            q, kv, *w_mask[:6], H, w_mask[6]))
    monkeypatch.setattr(pa, "_launch_efficient",  # its head width unused by the plain core
                        lambda q, k, v, mask, hd: pa.efficient_attention(q, k, v, H, mask))
    monkeypatch.setattr(fa, "_launch_flash",
                        lambda q, k, v, mask, heads, causal, partner: fa.flash_attention_plain(
                            q, k, v, heads, mask, causal, partner))
    x = t_(rand(2, 2, 12, D, seed=1)).requires_grad_()
    w = t_(rand(3 * D, D, seed=2, scale=D ** -0.5)).requires_grad_()
    b = t_(rand(3 * D, seed=3, scale=0.1)).requires_grad_()
    mask = t_(actor_mask())

    def run(route):
        xn = x * 1.5
        wq, wk, wv = w.chunk(3)
        bq, bk, bv = b.chunk(3)
        if kernel.startswith("projected"):
            same = kernel == "projected_self"
            kv, kmask = (xn, mask) if same else (xn.flip(1), mask.flip(1))
            args = (xn, kv, wq, bq, wk, bk, wv, bv)
            if route == "kernel":
                return pa.ProjectedAttention.apply(*args, kmask, H, same)
            return pa.fused_projected_attention_plain(*args, H, kmask)
        q, k, v = F.linear(xn, w, b).chunk(3, dim=-1)
        if kernel == "efficient":
            if route == "kernel":
                return pa.EfficientAttention.apply(q, k, v, mask, H)
            return pa.efficient_attention(q, k, v, H, mask)
        causal, partner = kernel != "flash_self", kernel != "flash_self"
        if route == "kernel":
            return fa.FlashAttention.apply(q, k, v, mask, H, causal, partner)
        return fa.flash_attention_plain(q, k, v, H, mask, causal, partner)

    g = t_(rand(2, 2, 12, D, seed=4))
    grads = {}
    for route in ("kernel", "plain"):
        grads[route] = torch.autograd.grad(run(route), (x, w, b), g)
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert_rel_close(got, want.numpy(), 1e-6)


# --- diffusion targets and losses ------------------------------------------------


def test_q_sample_and_training_targets_match_jax():
    jsched, sched = jg.make_schedule(jg.linear_betas(100)), tg.make_schedule(tg.linear_betas(100))
    x0, noise, t = rand(B, 2, T, FEATS, seed=1), rand(B, 2, T, FEATS, seed=2), np.array([0, 17, 63, 99])
    want_x, want_target = jg.training_targets(jsched, *map(jnp.asarray, (x0, t, noise)))
    got_x, got_target = tg.training_targets(sched, t_(x0), t_(t), t_(noise))
    assert_rel_close(got_x, want_x, 1e-6)
    assert_rel_close(tg.q_sample(sched, t_(x0), t_(t), t_(noise)), want_x, 1e-6)
    np.testing.assert_array_equal(got_target.numpy(), noise)


@pytest.mark.parametrize("loss", ["per_token", "supervised", "pit"])
def test_losses_match_jax(loss):
    mask = (np.arange(T) < LENGTHS[:, None]).astype(np.float32)
    if loss == "pit":
        pred, target = rand(B, 2, 2, T, FEATS, seed=3), rand(B, 2, 2, T, FEATS, seed=4)
    else:
        pred, target = rand(B, 2, T, FEATS, seed=3), rand(B, 2, T, FEATS, seed=4)
    if loss == "per_token":
        assert_rel_close(tt.per_token_loss(t_(pred), t_(target)),
                         jt.per_token_loss(jnp.asarray(pred), jnp.asarray(target)), 1e-6)
        return
    fn = {"supervised": (tt.supervised_loss, jt.supervised_loss), "pit": (tt.pit_loss, jt.pit_loss)}
    got, got_per = fn[loss][0](t_(pred), t_(target), t_(mask))
    want, want_per = fn[loss][1](*map(jnp.asarray, (pred, target, mask)))
    assert_rel_close(got, want, 1e-6)
    assert_rel_close(got_per, want_per, 1e-6)


# --- whole step against jax.value_and_grad --------------------------------------

STEP_CASES = {
    "pit_efficient": dict(pit=True, no_eff=False, no_clip=False, accum=1),
    "supervised_efficient_tokens": dict(pit=False, no_eff=False, no_clip=True, accum=1),
    "pit_no_eff": dict(pit=True, no_eff=True, no_clip=False, accum=1),
    "supervised_no_eff": dict(pit=False, no_eff=True, no_clip=False, accum=1),
    "pit_efficient_grad_accum2": dict(pit=True, no_eff=False, no_clip=False, accum=2),
    "pit_efficient_dropout": dict(pit=True, no_eff=False, no_clip=False, accum=1, dropout=0.5),
    "supervised_efficient_tokens_dropout": dict(pit=False, no_eff=False, no_clip=True, accum=1,
                                                dropout=0.5),
    "pit_efficient_causal": dict(pit=True, no_eff=False, no_clip=False, accum=1, causal=True),
}


@pytest.fixture(scope="module")
def jax_grad_fns():
    return {}  # jitted value_and_grad per (pit, no_eff, no_clip), shared by the cases


# The references' XLA:CPU backend without its LLVM optimizations: the same
# float32 program (fusion is decided before), compiled about twice as fast.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def fast_jit(fn):
    """``jax.jit(fn)`` compiled with FAST_COMPILE at its first call's
    arguments, the compiled program reused after (the same shapes)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE))
        return compiled[0](*args)

    return call


def step_batch(n, no_clip, seed=0):
    """A numpy batch of ``n`` pairs: ragged lengths, caption pairs, and the
    tiny CLIP tower's features of the captions unless ``no_clip``."""
    rs = np.random.RandomState(seed)
    cap_ids = rs.randint(0, len(CAPS), (n, 2))
    tokens = tokenize(CAPS).astype(np.int32)
    batch = dict(motion=rand(n, 2, T, FEATS, seed=seed + 1),
                 lengths=np.resize(LENGTHS, n).astype(np.int32), tokens=tokens[cap_ids])
    if not no_clip:
        tree = random_flax_tree(model_config(port_cfg(), PORT_CLIP), seed=0)
        feats = JaxModel(**{k: v for k, v in TINY.items() if k != "diffusion_steps"},
                         clip_config=JAX_CLIP).apply(
            tree, jnp.asarray(tokens), method=JaxModel.clip_tower)
        batch["tower_feats"] = np.asarray(feats)[cap_ids]
    return batch


def assert_grads_close(got: dict, want: dict):
    """Every leaf within GRAD_TOL of its largest reference magnitude; the
    key biases of the attention blocks, whose exact gradient is 0, within
    ZERO_GRAD_TOL of the largest gradient of the tree in both packages."""
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0.1
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if name.endswith(("_block.key.bias")):
            assert float(w.abs().max()) <= ZERO_GRAD_TOL * scale, name
            assert float(g.abs().max()) <= ZERO_GRAD_TOL * scale, name
            continue
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), (name, err, float(w.abs().max()))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_whole_step_loss_and_grads_match_jax(jax_grad_fns, case):
    c = STEP_CASES[case]
    dropout, causal = c.get("dropout", 0.0), c.get("causal", False)
    jcfg = JaxConfig(**TINY, no_eff=c["no_eff"], no_clip=c["no_clip"], dropout=dropout,
                     causal=causal)
    key = (c["pit"], c["no_eff"], c["no_clip"], dropout, causal)
    if key not in jax_grad_fns:
        jmodel = model_from_config(jcfg, clip_config=JAX_CLIP)
        loss_fn = jt.make_loss_fn(jmodel, jg.make_schedule(jg.linear_betas(100)), c["pit"])
        jax_grad_fns[key] = fast_jit(jax.value_and_grad(loss_fn, has_aux=True))
    cfg = port_cfg(no_eff=c["no_eff"], no_clip=c["no_clip"], grad_accum=c["accum"],
                   dropout=dropout, causal=causal)
    assert model_config(cfg, PORT_CLIP).dropout == dropout
    tree = random_flax_tree(model_config(cfg, PORT_CLIP), seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = step_batch(B * c["accum"], c["no_clip"])

    # JAX: grad_accum splits the rng per microbatch and averages (make_train_step)
    rng = jax.random.key(7)
    rngs = jax.random.split(rng, c["accum"]) if c["accum"] > 1 else [rng]
    losses, grads, ts, noises = [], [], [], []
    for i, r in enumerate(rngs):
        micro = {k: jnp.asarray(v[i * B:(i + 1) * B]) for k, v in batch.items()}
        (loss, _), g = jax_grad_fns[key](params, micro, r)
        losses.append(float(loss))
        grads.append(torch_state_from_flax(jax.tree_util.tree_map(np.asarray, g)))
        t_rng, n_rng = jax.random.split(r)
        ts.append(np.asarray(jax.random.randint(t_rng, (B,), 0, 100)))
        noises.append(np.asarray(jax.random.normal(n_rng, (B, 2, T, FEATS), jnp.float32)))
    want_loss = np.mean(losses)
    want = {k: sum(g[k] for g in grads) / len(grads) for k in grads[0]}

    model = port_model(cfg).train()
    tt.make_optimizer(cfg, model)  # marks the CLIP tower frozen unless no_clip
    tbatch = {k: t_(v).long() if v.dtype == np.int32 else t_(v) for k, v in batch.items()}
    loss_fn = tt.make_loss_fn(model, tg.make_schedule(tg.linear_betas(100)), c["pit"])
    loss, _ = tt.compute_grads(model, loss_fn, tbatch, c["accum"],
                               t=t_(np.concatenate(ts)).long(), noise=t_(np.concatenate(noises)))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}
    assert_grads_close(got, want)
    frozen = model.clip_parameters()
    assert all((n in frozen) != p.requires_grad or c["no_clip"] for n, p in model.named_parameters())


# --- optimizer and schedules against optax ---------------------------------------

SCHEDULES = {"constant": {}, "warmup": dict(warmup_steps=2),
             "cosine": dict(lr_schedule="cosine", warmup_steps=1, lr_decay_steps=5)}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_lr_schedule_matches_optax(schedule):
    kw = SCHEDULES[schedule]
    want = jt.lr_schedule(JaxConfig(**TINY, **kw))
    got = tt.lr_schedule(port_cfg(**kw))
    for count in range(8):
        w = float(want(count)) if callable(want) else want
        assert abs(got(count) - w) <= 1e-6 * 2e-4, (count, got(count), w)
    if schedule != "constant":
        assert got(0) == 0.0


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_optimizer_matches_optax(schedule):
    """Three updates from the same gradients (the first and third above the
    clip norm, the second below; CLIP's gradients huge, so a clip norm that
    counted them would differ) through optax's multi_transform and through
    the port's optimizer, with the EMA of make_train_step."""
    kw = dict(SCHEDULES[schedule], lr=1e-2, ema_decay=0.9, num_layers=1)  # fewer leaves to compile
    jcfg, cfg = JaxConfig(**{**TINY, **kw}), ExperimentConfig(**{**TINY, **kw})
    tree = random_flax_tree(model_config(cfg, PORT_CLIP), seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jt.make_optimizer(jcfg, params)
    opt_state, ema = tx.init(params), params

    @jax.jit
    def jax_step(params, opt_state, ema, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: e * 0.9 + (1.0 - 0.9) * p, ema, params)
        return params, opt_state, ema

    model = port_model(cfg).train()
    state = tt.TrainState(model=model, optimizer=tt.make_optimizer(cfg, model),
                          ema={n: p.detach().clone() for n, p in model.named_parameters()})
    clip0 = {n: p.detach().clone() for n, p in model.named_parameters() if "clip" in n}
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    for step, norm in enumerate((3.0, 0.2, 1.0)):  # clip norm 0.5
        scale = norm / np.sqrt(n_train)
        rs = np.random.RandomState(step)
        grads = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.asarray(rs.randn(*x.shape).astype(np.float32)
                                        * (1e3 if "clip" in str(path) else scale)), params)
        params, opt_state, ema = jax_step(params, opt_state, ema, grads)
        tgrads = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone()
        tt.apply_update(state, cfg.ema_decay)
    want_params = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    want_ema = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, ema))
    assert state.step == 3
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[n].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(state.ema[n].numpy(), want_ema[n].numpy(), atol=1e-6, rtol=0)
    assert all(torch.equal(p, clip0[n]) for n, p in model.named_parameters() if n in clip0)
    assert any(not torch.equal(p, state.ema[n]) for n, p in model.named_parameters())


# --- data pipeline --------------------------------------------------------------


@pytest.mark.parametrize("nframes", [5, 89, 90, 91, 150])
def test_window_indices_match_jax(nframes):
    for seed in range(3):
        want = jd.window_indices(nframes, np.random.default_rng(seed))
        got = td.window_indices(nframes, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def test_stats_match_jax(synth_data):
    jcfg = jax_add_paths(JaxConfig(dataset_name="synthetic_mul", data_root=synth_data))
    cfg = add_dataset_paths(ExperimentConfig(dataset_name="synthetic_mul", data_root=synth_data))
    jclips, clips = jd.load_clips(jcfg, "train_sub.txt"), td.load_clips(cfg, "train_sub.txt")
    assert [c.name for c in clips] == [c.name for c in jclips]
    for got, want in zip(td.compute_mean_std(clips), jd.compute_mean_std(jclips)):
        np.testing.assert_array_equal(got, want)
    std = np.load(os.path.join(synth_data, "Std.npy"))
    np.testing.assert_array_equal(td.rescale_std_train(std, 22, 5.0),
                                  jd.rescale_std_train(std, 22, 5.0))


@pytest.mark.parametrize("variant", ["pit", "labels_wrapped"])
def test_epoch_batches_match_jax_bitwise(synth_data, tmp_path, variant):
    jcfg = jax_add_paths(JaxConfig(dataset_name="synthetic_mul", data_root=synth_data))
    cfg = add_dataset_paths(ExperimentConfig(dataset_name="synthetic_mul", data_root=synth_data))
    mean = np.load(os.path.join(synth_data, "Mean.npy"))
    std = td.rescale_std_train(np.load(os.path.join(synth_data, "Std.npy")), 22, 5.0)
    labels = None
    if variant == "labels_wrapped":
        names = [c.name for c in td.load_clips(cfg, "train_sub.txt")]
        labels = str(tmp_path / "labels.json")
        with open(labels, "w") as f:
            json.dump({n: i % 2 for i, n in enumerate(names)}, f)
    jds = jd.PairDataset(jcfg, mean, std, "train_sub.txt", times=2, label_path=labels, seed=3)
    tds = td.PairDataset(cfg, mean, std, "train_sub.txt", times=2, label_path=labels, seed=3)
    drop_last = variant == "pit"
    count = 0
    for epoch in (0, 1):
        pairs = zip(jd.epoch_batches(jds, 4, epoch, drop_last=drop_last, seed=3),
                    td.epoch_batches(tds, 4, epoch, drop_last=drop_last, seed=3), strict=True)
        for want, got in pairs:
            for key in ("motion", "lengths", "tokens", "cap_ids", "class_id"):
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])
            assert got["names"] == want["names"]
            count += 1
    assert count == 2 * (len(tds) // 4 if drop_last else -(-len(tds) // 4))


# --- config ----------------------------------------------------------------------

REFUSED = {"pretrained": True, "use_native_loader": True, "fsdp": True, "tp": True,
           "pp_micro": 2}
PORTED = ("pretrained", "use_native_loader", "fsdp", "tp", "pp_micro")


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_config_refuses_unported_options(field):
    """Every option once refused is ported and accepted alone, the
    multi-device layouts too (each refused only in the combinations JAX's
    trainer refuses: tests/test_torch_parallel.py)."""
    assert field in PORTED
    assert getattr(ExperimentConfig(**{field: REFUSED[field]}), field) == REFUSED[field]


def test_config_accepts_dropout():
    """dropout > 0 is accepted by both configs and applies no dropout, as in
    JAX, whose every path runs deterministically (the whole-step cases at
    dropout 0.5 hold the loss and gradients to JAX's)."""
    from hig_tpu_torch.models.interaction_model import ModelConfig

    assert ExperimentConfig(dropout=0.1).dropout == 0.1
    assert ModelConfig(dropout=0.1).dropout == 0.1
    assert model_config(port_cfg(dropout=0.1), PORT_CLIP).dropout == 0.1


def test_load_opt_txt_reads_jax_dropout(tmp_path):
    """A JAX run trained with --dropout 0.1 loads from its opt.txt."""
    from hig_tpu.config import save_opt_txt as jax_save_opt_txt
    from hig_tpu_torch.config import load_opt_txt

    path = str(tmp_path / "opt.txt")
    jax_save_opt_txt(JaxConfig(**TINY, dropout=0.1), path)
    cfg = load_opt_txt(path)
    assert cfg.dropout == 0.1
    assert model_config(cfg, PORT_CLIP).dropout == 0.1


def test_config_refuses_caption_dropout_under_pit():
    """Caption dropout belongs to the supervised stage (a label file), as
    the JAX loss has it; the options this slice ports are accepted."""
    with pytest.raises(ValueError, match="cond_drop_prob requires the supervised"):
        ExperimentConfig(cond_drop_prob=0.1)
    ExperimentConfig(cond_drop_prob=0.1, label_path="labels.json", cap_id=True,
                     loss_aware_sampler=True)


def test_config_fields_are_the_jax_fields_with_their_defaults():
    jax_fields = {f.name: f for f in dataclasses.fields(JaxConfig)}
    for f in dataclasses.fields(ExperimentConfig):
        assert f.name in jax_fields, f.name
        assert f.default == jax_fields[f.name].default, f.name
    with pytest.raises(ValueError, match="grad-accumulation"):
        ExperimentConfig(batch_size=6, grad_accum=4)


def test_cli_profile_writes_its_trace_and_step_times(synth_data, tmp_path, capsys):
    """``--profile`` is accepted (JAX's option) and, on the CPU, the CLI
    writes a ``torch.profiler`` trace of steps [5, 10) under
    ``<save_root>/profile``, ``step_times.jsonl`` with every step's time
    and the "step latency" line, as ``hig_tpu/train/trainer.py`` does."""
    from hig_tpu_torch.train.__main__ import main

    assert ExperimentConfig(profile=True).profile
    argv = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", synth_data,
            "--checkpoints_dir", str(tmp_path), "--name", "prof", "--cap_id", "--batch_size",
            "2", "--limit_data_num", "12", "--num_epochs", "3", "--log_every", "1", "--profile"]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v)]
    trainer, state = main(argv)
    lines = capsys.readouterr().out.splitlines()
    root = trainer.cfg.save_root
    assert state.step == 12  # 4 a pass: the trace covers steps [5, 10)
    trace = json.load(open(os.path.join(root, "profile", "trace.json")))
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
    (times,) = [json.loads(x) for x in open(os.path.join(root, "step_times.jsonl"))]
    assert times["steps"] == 12 and times["p50_ms"] > 0 and times["items_per_sec"] > 0
    assert any(line.startswith("step latency: ") for line in lines)
    assert any(line.startswith("device trace written to ") for line in lines)


def test_cli_refuses_unported_options(capsys):
    from hig_tpu_torch.train.__main__ import main

    for argv, what in ((["--fsdp", "--tp"], "fsdp and tp"),
                       (["--cond_drop_prob", "0.1"], "cond_drop_prob")):
        with pytest.raises(SystemExit) as e:
            main([*argv, "--device", "cpu"])
        assert e.value.code == 2
        assert what in capsys.readouterr().err


# --- trainer ---------------------------------------------------------------------


def trainer_cfg(synth_data, tmp_path, **kw):
    return add_dataset_paths(ExperimentConfig(
        **TINY, dataset_name="synthetic_mul", data_root=synth_data,
        checkpoints_dir=str(tmp_path), batch_size=4, log_every=1, **kw))


def dataset_for(cfg):
    mean = np.load(os.path.join(cfg.data_root, "Mean.npy"))
    std = np.load(os.path.join(cfg.data_root, "Std.npy"))
    return td.PairDataset(cfg, mean, std, "train_sub.txt", times=1, seed=cfg.seed)


def test_resume_continues_the_run_bitwise(synth_data, tmp_path):
    """Two epochs, then a resume from ``latest`` for a third, end where three
    epochs in a row end (one step per epoch), EMA and metrics included."""
    base = dict(limit_data_num=4, ema_decay=0.9, save_every_e=1)
    whole = trainer_cfg(synth_data, tmp_path, name="whole", num_epochs=3, **base)
    trainer = tt.Trainer(whole, "cpu", PORT_CLIP)
    want = trainer.train(dataset_for(whole), trainer.init_state(), log=lambda *_: None)

    part = trainer_cfg(synth_data, tmp_path, name="part", num_epochs=2, **base)
    trainer = tt.Trainer(part, "cpu", PORT_CLIP)
    trainer.train(dataset_for(part), trainer.init_state(), log=lambda *_: None)
    resumed = dataclasses.replace(part, num_epochs=3, is_continue=True)
    trainer = tt.Trainer(resumed, "cpu", PORT_CLIP)
    state, epoch, it = ckpt.restore_state(os.path.join(part.model_dir, "latest.pt"),
                                          trainer.init_state())
    assert (epoch, it, state.step) == (2, 2, 2)
    got = trainer.train(dataset_for(resumed), state, start_epoch=epoch, log=lambda *_: None)

    assert got.step == want.step == 3
    for (name, p), q in zip(got.model.named_parameters(), want.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(got.ema[name], want.ema[name]), name
    lines = [[json.loads(x) for x in open(os.path.join(c.save_root, "metrics.jsonl"))]
             for c in (whole, part)]
    assert lines[0] == lines[1] and len(lines[0]) == 3
    assert os.path.exists(os.path.join(part.model_dir, "ckpt_e002.pt"))


@pytest.mark.parametrize("checkpoint", [True, False], ids=["rollback", "no_checkpoint"])
def test_non_finite_loss_rolls_back_to_latest(synth_data, tmp_path, checkpoint):
    cfg = trainer_cfg(synth_data, tmp_path, name="nan", num_epochs=1,
                      save_latest=1 if checkpoint else 1000)
    trainer = tt.Trainer(cfg, "cpu", PORT_CLIP)
    real, calls = trainer._device_batch, {"n": 0}

    def poisoned(batch, tower_feats):
        calls["n"] += 1
        if calls["n"] == 2:
            batch = dict(batch, motion=np.full_like(batch["motion"], np.nan))
        return real(batch, tower_feats)

    trainer._device_batch = poisoned
    logs = []
    if not checkpoint:
        with pytest.raises(FloatingPointError):
            trainer.train(dataset_for(cfg), trainer.init_state(), log=logs.append)
        return
    state = trainer.train(dataset_for(cfg), trainer.init_state(), log=logs.append)
    assert any("rolling back" in line for line in logs)
    steps = len(dataset_for(cfg)) // cfg.batch_size
    assert state.step == steps - 1  # the poisoned batch is skipped, not replayed
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    metrics = [json.loads(x) for x in open(os.path.join(cfg.save_root, "metrics.jsonl"))]
    assert len(metrics) == steps - 1 and all(np.isfinite(m["loss_mot_rec"]) for m in metrics)


@pytest.mark.parametrize("ema_decay", [0.0, 0.5], ids=["params", "ema"])
def test_serve_loads_the_trainer_checkpoint(synth_data, tmp_path, ema_decay):
    """``serve.build_model`` takes a trainer checkpoint's EMA parameters when
    the run kept them (``eval_params``), else its parameters, in eval mode."""
    from hig_tpu_torch import serve

    cfg = trainer_cfg(synth_data, tmp_path, name="serve", num_epochs=1, limit_data_num=8,
                      ema_decay=ema_decay)
    trainer = tt.Trainer(cfg, "cpu", PORT_CLIP)
    state = trainer.train(dataset_for(cfg), trainer.init_state(), log=lambda *_: None)
    model = serve.build_model(trainer.model_config, "cpu",
                              params=os.path.join(cfg.model_dir, "latest.pt"))
    assert not model.training
    want = state.ema if ema_decay else dict(state.model.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, want[name]), name
