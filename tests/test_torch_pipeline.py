"""Parity of the PyTorch port's three-stage pipeline against hig_tpu on the CPU.

- Caption-id conditioning: ``ClassConditioner`` and the cap-id
  ``InteractionModel`` (encode and denoise) within 2e-5; the null
  conditioning exactly; the weight bridge's shapes equal ``model.init``'s
  for ``cap_id`` × ``cond_drop_prob``.
- Timestep samplers: the loss-aware history after updates with repeated
  timesteps in a batch (counts exactly, losses within 1e-6) on cold, partly
  warm and full histories, its sampling distribution and the importance
  weights of given t.
- Losses and gradients against ``jax.value_and_grad`` of ``make_loss_fn``:
  cap-id PIT, cap-id supervised, supervised with caption dropout (also for
  the quadratic ``--no_eff`` model), and the loss-aware sampler; JAX's t, noise, keep and ``choice`` draws are
  reproduced from its rng and handed to the port. Tolerances of
  ``tests/test_torch_train.py`` (``assert_grads_close``).
- Labeling: the assignment scorer's (B, 2) scores within 1e-5 relative for
  the tokens, cap-id and quadratic tokens models, and ``discover_roles`` / ``pseudo_label``
  return the JAX package's dicts when the port is fed JAX's rng chain of
  noises.
- Guided sampling: DDIM at w = 2.5 within 1e-5 of the output scale of
  JAX's ``make_sampler`` from the same x_T, for caption tokens, caption
  ids and the quadratic model; w = 1 is the unguided sampler; w ≠ 1 is refused without null
  parameters.
- The CLIs on the CPU: ``train --cap_id`` (PIT) → ``python -m
  hig_tpu_torch.label`` → ``train --cap_id --label_path ... --cond_drop_prob
  --loss_aware_sampler --eval_every_e 1`` → ``serve --opt_path
  --guidance_scale``; ``opt.txt`` read back; a rollback resets the
  loss-aware history.

Tiny widths (1 layer, latent 32) and ``torch.set_num_threads(1)``; data
is seeded random features in the reference's layout.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.config import add_dataset_paths as jax_add_paths
from hig_tpu.data import dataset as jd
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.diffusion import timestep_samplers as jtss
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu.models.text_encoder import ClipTextConfig as JaxClip
from hig_tpu.train import labeling as jlab
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths, load_opt_txt, model_config
from hig_tpu_torch.config import save_opt_txt
from hig_tpu_torch.data import dataset as td
from hig_tpu_torch.data.vocab import CAPS, CLASSID2CAPS
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.diffusion import timestep_samplers as tss
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.train import labeling as tl
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import flatten, flax_param_shapes, load_flax_tree, random_flax_tree
from hig_tpu_torch.weights import torch_state_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_layers=1, latent_dim=32, ff_size=64, num_heads=4, num_text_layers=1,
            text_latent_dim=16, text_ff_size=32, text_num_heads=2, diffusion_steps=100)
PORT_CLIP = ClipTextConfig(width=32, heads=2, layers=1)
JAX_CLIP = JaxClip(width=32, heads=2, layers=1)
B, T, FEATS = 4, 16, 263
LENGTHS = np.array([16, 9, 12, 5], np.int32)
MODULE_TOL = 2e-5
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL = 1e-5, 1e-4, 1e-6
DROP = 0.5  # caption dropout of the tests: drops some pairs of 4, keeps others


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


def port_mcfg(cap_id=False, drop=0.0, no_eff=False):
    mcfg = model_config(ExperimentConfig(**TINY, cap_id=cap_id, no_eff=no_eff), PORT_CLIP)
    return dataclasses.replace(mcfg, cond_drop_prob=drop)


def jax_model(cap_id=False, drop=0.0, no_eff=False):
    jcfg = JaxConfig(**TINY, cap_id=cap_id, cond_drop_prob=drop, no_eff=no_eff)
    return model_from_config(jcfg, clip_config=JAX_CLIP)


def models(cap_id=False, drop=0.0, no_eff=False):
    """(JAX model, its params, the port's model with the same weights); the
    quadratic (``--no_eff``) model with ``no_eff``."""
    mcfg = port_mcfg(cap_id, drop, no_eff)
    tree = random_flax_tree(mcfg, seed=0)
    port = load_flax_tree(InteractionModel(mcfg), tree["params"])
    return jax_model(cap_id, drop, no_eff), jax.tree_util.tree_map(jnp.asarray, tree), port


def assert_rel_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max(), rtol=0)


# --- caption-id conditioning and the weight bridge --------------------------------


def test_cap_id_model_matches_jax():
    jmodel, params, port = models(cap_id=True)
    ids = np.array([[0, 1], [5, 6], [42, 42], [13, 2]], np.int32)
    x, t = rand(B, 2, T, FEATS, seed=1), np.array([3, 40, 77, 99])

    @jax.jit
    def run(params, ids, x, t, lengths):
        proj, out = jmodel.apply(params, ids, method=JaxModel.encode_text)
        return proj, out, jmodel.apply(params, x, t, lengths, proj, out, method=JaxModel.denoise)

    want_proj, want_out, want = run(params, *map(jnp.asarray, (ids, x, t, LENGTHS)))
    with torch.no_grad():
        proj, out = port.encode_text(t_(ids))
        got = port.denoise(t_(x), t_(t), t_(LENGTHS), proj, out)
        table = port.text(t_(ids[:, 0]))  # ClassConditioner alone
    assert out.shape == (B, 2, 1, TINY["text_latent_dim"])
    np.testing.assert_allclose(proj.numpy(), np.asarray(want_proj), atol=MODULE_TOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=MODULE_TOL, rtol=0)
    np.testing.assert_allclose(table[0].numpy(), np.asarray(want_proj)[:, 0],
                               atol=MODULE_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_TOL, rtol=0)
    assert port.clip_parameters() == set()


def test_null_conditioning_is_exact():
    jmodel, params, port = models(cap_id=False, drop=0.1)
    for L in (1, 77):
        want = jmodel.apply(params, 3, L, method=JaxModel.null_conditioning)
        got = port.null_conditioning(3, L)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="null conditioning"):
        models()[2].null_conditioning(3)


@pytest.mark.parametrize("drop", [0.0, 0.1], ids=["no_null", "null"])
@pytest.mark.parametrize("cap_id", [False, True], ids=["tokens", "cap_id"])
def test_bridge_shapes_equal_jax_init(cap_id, drop):
    jmodel = jax_model(cap_id, drop)
    cond = jnp.zeros((1, 2), jnp.int32) if cap_id else jnp.zeros((1, 2, 77), jnp.int32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 2, 91, FEATS)),
                            jnp.zeros((1,), jnp.int32), jnp.full((1,), 91, jnp.int32), cond)
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree_util.tree_map(
        lambda a: a, dict(shapes), is_leaf=lambda a: hasattr(a, "shape"))).items()}
    mcfg = port_mcfg(cap_id, drop)
    assert {k: tuple(v) for k, v in flatten(flax_param_shapes(mcfg)).items()} == want
    # a tree of the JAX init's structure loads with strict=True
    tree = jax.tree_util.tree_map(lambda a: np.ones(a.shape, np.float32), dict(shapes),
                                  is_leaf=lambda a: hasattr(a, "shape"))
    load_flax_tree(InteractionModel(mcfg), tree["params"])


# --- timestep samplers ------------------------------------------------------------------

HISTORY_CASES = {"cold": 0, "partial": 3, "full": 14}  # prior updates of one batch


@pytest.mark.parametrize("case", list(HISTORY_CASES))
def test_loss_aware_history_matches_jax(case):
    """Batches of 8 over 6 timesteps, with repeats inside each batch: the
    history rows, counts, sampling distribution, and the importance weights
    of the t JAX draws."""
    T_, H = 6, 4
    jstate = jtss.LossSecondMomentState.create(T_, H)
    state = tss.LossSecondMomentState.create(T_, H)
    rs = np.random.RandomState(0)
    jupdate = jax.jit(jtss.loss_aware_update)
    for _ in range(HISTORY_CASES[case] + 1):
        t = rs.randint(0, T_, 8).astype(np.int32)
        t[3] = t[5] = t[0]  # a timestep three times in one batch
        losses = rs.rand(8).astype(np.float32)
        jstate = jupdate(jstate, jnp.asarray(t), jnp.asarray(losses))
        state = tss.loss_aware_update(state, t_(t), t_(losses))
    np.testing.assert_array_equal(state.counts.numpy(), np.asarray(jstate.counts))
    np.testing.assert_allclose(state.losses.numpy(), np.asarray(jstate.losses), atol=1e-6, rtol=0)
    assert (state.counts.numpy() == H).all() == (case == "full")
    want_p = np.asarray(jtss.loss_aware_weights(jstate))
    np.testing.assert_allclose(tss.loss_aware_weights(state).numpy(), want_p, atol=1e-6, rtol=0)
    jt_draw, want_w = jtss.loss_aware_sample(jax.random.key(3), 16, jstate)
    got_t, got_w = tss.loss_aware_sample(16, state, t=t_(np.asarray(jt_draw)))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=0)
    draw, _ = tss.loss_aware_sample(4096, state, torch.Generator().manual_seed(0))
    assert draw.min() >= 0 and draw.max() < T_


# --- losses and gradients against jax.value_and_grad -----------------------------------

STEP_CASES = {
    "cap_id_pit": dict(pit=True, cap_id=True, drop=0.0, loss_aware=False),
    "cap_id_supervised": dict(pit=False, cap_id=True, drop=0.0, loss_aware=False),
    "supervised_cfg": dict(pit=False, cap_id=False, drop=DROP, loss_aware=False),
    "pit_loss_aware": dict(pit=True, cap_id=False, drop=0.0, loss_aware=True),
    "supervised_cfg_no_eff": dict(pit=False, cap_id=False, drop=DROP, loss_aware=False,
                                  no_eff=True),
}


def step_batch(cap_id):
    """A numpy batch of B pairs: ragged lengths, caption ids and, for the
    tokens model, tokens with the tiny CLIP tower's features."""
    rs = np.random.RandomState(0)
    cap_ids = rs.randint(0, len(CAPS), (B, 2)).astype(np.int32)
    batch = dict(motion=rand(B, 2, T, FEATS, seed=1), lengths=LENGTHS)
    if cap_id:
        batch["cap_ids"] = cap_ids
        return batch
    tokens = tokenize(CAPS).astype(np.int32)
    jmodel, params, _ = models()
    feats = jmodel.apply(params, jnp.asarray(tokens), method=JaxModel.clip_tower)
    batch.update(tokens=tokens[cap_ids], tower_feats=np.asarray(feats)[cap_ids])
    return batch


def warm_history(num_timesteps=100, H=10):
    rs = np.random.RandomState(4)
    losses = (rs.rand(num_timesteps, H) * np.linspace(0.1, 3.0, num_timesteps)[:, None])
    return losses.astype(np.float32), np.full((num_timesteps,), H)


# Leaves whose exact gradient is 0: the key biases (a softmax over the keys
# ignores a constant added to every key) and, with caption ids, the text
# cross-attention's query, key and norm: over a single text token the
# efficient cross-attention returns that token's value whatever the query.
ZERO_GRAD = {False: ("_block.key.bias",),
             True: ("_block.key.bias", ".ca_block.key.weight", ".ca_block.query.weight",
                    ".ca_block.query.bias", ".ca_block.norm.weight", ".ca_block.norm.bias")}


def assert_grads_close(got: dict, want: dict, cap_id: bool):
    """As ``tests/test_torch_train.py``: each leaf within GRAD_TOL of its
    largest magnitude; the leaves of ZERO_GRAD within ZERO_GRAD_TOL of the
    tree's largest gradient in both packages."""
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0.1
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if name.endswith(ZERO_GRAD[cap_id]):
            assert float(w.abs().max()) <= ZERO_GRAD_TOL * scale, name
            assert float(g.abs().max()) <= ZERO_GRAD_TOL * scale, name
            continue
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), (name, err, float(w.abs().max()))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_loss_and_grads_match_jax(case):
    c = STEP_CASES[case]
    jmodel, params, model = models(c["cap_id"], c["drop"], c.get("no_eff", False))
    sched = jg.make_schedule(jg.linear_betas(100))
    batch = step_batch(c["cap_id"])
    rng = jax.random.key(7)
    hist = warm_history()
    jstate = jtss.LossSecondMomentState(losses=jnp.asarray(hist[0]),
                                        counts=jnp.asarray(hist[1], jnp.int32))
    loss_fn = jt.make_loss_fn(jmodel, sched, c["pit"], loss_aware=c["loss_aware"])
    args = (params, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
            jstate if c["loss_aware"] else None)
    # XLA:CPU without its LLVM optimizations: the same float32 program,
    # compiled about twice as fast
    (want_loss, want_aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        *args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, g))

    # JAX's draws (make_loss_fn): t from t_rng (uniform or the resampler),
    # noise from n_rng, keep from fold_in(rng, 7)
    t_rng, n_rng = jax.random.split(rng)
    if c["loss_aware"]:
        t, _ = jtss.loss_aware_sample(t_rng, B, jstate)
    else:
        t = jax.random.randint(t_rng, (B,), 0, 100)
    noise = jax.random.normal(n_rng, (B, 2, T, FEATS), jnp.float32)
    keep = None
    if c["drop"]:
        keep = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 7), 1 - c["drop"], (B,)))
        assert 0 < keep.sum() < B  # drops some pairs and keeps others
        keep = t_(keep)

    model.train()
    tt.make_optimizer(ExperimentConfig(**TINY), model)  # marks the CLIP tower frozen
    port_fn = tt.make_loss_fn(model, tg.make_schedule(tg.linear_betas(100)), c["pit"],
                              c["loss_aware"])
    ts_state = tss.LossSecondMomentState(t_(hist[0]), t_(hist[1]).long())
    tbatch = {k: t_(v).long() if v.dtype == np.int32 else t_(v) for k, v in batch.items()}
    loss, aux = tt.compute_grads(model, port_fn, tbatch, t=t_(np.asarray(t)).long(),
                                 noise=t_(np.asarray(noise)), keep=keep, ts_state=ts_state)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    np.testing.assert_array_equal(aux["t"].numpy(), np.asarray(want_aux["t"]))
    assert_rel_close(aux["per_sample"], want_aux["per_sample"], 1e-5)
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}
    assert_grads_close(got, want, c["cap_id"])


@pytest.mark.parametrize("loss", ["supervised", "pit"])
def test_importance_weighted_losses_match_jax(loss):
    mask = (np.arange(T) < LENGTHS[:, None]).astype(np.float32)
    shape = (B, 2, 2, T, FEATS) if loss == "pit" else (B, 2, T, FEATS)
    pred, target, w = rand(*shape, seed=3), rand(*shape, seed=4), rand(B, seed=5) ** 2
    fn = {"supervised": (tt.supervised_loss, jt.supervised_loss),
          "pit": (tt.pit_loss, jt.pit_loss)}[loss]
    got, got_per = fn[0](t_(pred), t_(target), t_(mask), t_(w))
    want, want_per = fn[1](*map(jnp.asarray, (pred, target, mask, w)))
    assert_rel_close(got, want, 1e-6)
    assert_rel_close(got_per, want_per, 1e-6)


def test_cfg_is_refused_under_pit():
    _, _, model = models(drop=0.1)
    with pytest.raises(ValueError, match="cond_drop_prob requires the supervised"):
        tt.make_loss_fn(model, tg.make_schedule(tg.linear_betas(100)), pit=True)


def test_train_step_folds_every_microbatch_into_the_history():
    """With grad_accum 2 the step folds both microbatches' (t, per-sample
    loss) into the history, in batch order, as the JAX step does."""
    _, _, model = models(cap_id=True)
    model.train()
    cfg = ExperimentConfig(**TINY, cap_id=True)
    state = tt.TrainState(model=model, optimizer=tt.make_optimizer(cfg, model))
    sched = tg.make_schedule(tg.linear_betas(100))
    tbatch = {k: t_(v).long() if v.dtype == np.int32 else t_(v)
              for k, v in step_batch(cap_id=True).items()}
    t = torch.tensor([5, 7, 5, 9])
    noise = t_(rand(B, 2, T, FEATS, seed=8))
    hist = tss.LossSecondMomentState.create(100)
    loss_fn = tt.make_loss_fn(model, sched, pit=True, loss_aware=True)
    want_per = torch.cat([loss_fn({k: v[s] for k, v in tbatch.items()}, t=t[s], noise=noise[s],
                                  ts_state=hist)[1]["per_sample"].detach()
                          for s in (slice(0, 2), slice(2, 4))])
    step = tt.make_train_step(sched, pit=True, grad_accum=2, loss_aware=True)
    _, new = step(state, tbatch, t=t, noise=noise, ts_state=hist)
    want = tss.loss_aware_update(hist, t, want_per)
    np.testing.assert_array_equal(new.counts.numpy(), want.counts.numpy())
    np.testing.assert_array_equal(new.losses.numpy(), want.losses.numpy())
    assert new.counts.sum() == 4 and new.counts[5] == 2


# --- labeling --------------------------------------------------------------------------


def write_dataset(root, seed=0):
    """One clip per class of 100 frames of seeded random features in the
    reference's layout, every clip in train_sub.txt, test_ann_ids.txt and
    (8 of them) val_sub.txt; seeded 0/1 role annotations."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    names = []
    for i, (c1, c2) in enumerate(CLASSID2CAPS):
        name = f"C{i:03d}"
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"),
                rs.randn(2, 101, FEATS).astype(np.float32))
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write(f"{c1}_{c2}#none#0.0#0.0\n")
        names.append(name)
    for split, chosen in (("train_sub.txt", names), ("test_ann_ids.txt", names),
                          ("val_sub.txt", names[:8])):
        with open(os.path.join(root, split), "w") as f:
            f.write("\n".join(chosen) + "\n")
    with open(os.path.join(root, "test_active_anns.json"), "w") as f:
        json.dump({n: int(rs.randint(2)) for n in names}, f)
    np.save(os.path.join(root, "Mean.npy"), np.zeros(FEATS + 4, np.float32))
    np.save(os.path.join(root, "Std.npy"), np.ones(FEATS + 4, np.float32))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline") / "data")
    write_dataset(root)
    return root


LABEL_CLIPS, LABEL_BATCH = 12, 16  # one batch, wrapped round


def datasets(root, label_path=None):
    """The JAX and the port's PairDataset of LABEL_CLIPS clips of
    train_sub.txt."""
    kw = dict(dataset_name="synthetic_mul", data_root=root, limit_data_num=LABEL_CLIPS)
    jcfg, cfg = jax_add_paths(JaxConfig(**kw)), add_dataset_paths(ExperimentConfig(**kw))
    mean, std = np.zeros(FEATS + 4, np.float32), np.ones(FEATS + 4, np.float32)
    return (jd.PairDataset(jcfg, mean, std, "train_sub.txt", label_path=label_path),
            td.PairDataset(cfg, mean, std, "train_sub.txt", label_path=label_path))


def jax_noise_chain(seed):
    """The port's noise_fn drawing what ``_iter_scored_batches`` of the JAX
    package draws: rng, sub = split(rng); normal(sub, shape)."""
    state = {"rng": jax.random.key(seed)}

    def draw(shape):
        state["rng"], sub = jax.random.split(state["rng"])
        return t_(np.asarray(jax.random.normal(sub, tuple(shape), jnp.float32)))

    return draw


# (cap_id, no_eff) of the scorer and guided-sampler cases
MODEL_CASES = {"tokens": (False, False), "cap_id": (True, False), "tokens_no_eff": (False, True)}


@pytest.fixture(scope="module")
def scorers():
    """Per model case: the JAX params and scorer, and the port's scorer of
    the same weights (the JAX scorer's compiles are shared by the tests)."""
    out = {}
    for name, (cap_id, no_eff) in MODEL_CASES.items():
        jmodel, params, model = models(cap_id, no_eff=no_eff)
        out[name] = (params,
                     jlab.make_assignment_scorer(jmodel, jg.make_schedule(jg.linear_betas(1000))),
                     tl.make_assignment_scorer(model, tg.make_schedule(tg.linear_betas(1000))))
        assert not model.training
    return out


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_scorer_matches_jax(data_root, scorers, case):
    cap_id = MODEL_CASES[case][0]
    params, (jenc, jscore), (encode, score) = scorers[case]
    jds, _ = datasets(data_root)
    batch = next(jd.epoch_batches(jds, LABEL_BATCH, 0, shuffle=False, drop_last=False))
    cond = batch["cap_ids"] if cap_id else batch["tokens"]
    jxp, jxo = jenc(params, jnp.asarray(cond), jnp.flip(jnp.asarray(cond), axis=1))
    xp, xo = encode(t_(cond).long(), t_(cond).long().flip(1))
    for t in (830, 920):
        rng = jax.random.key(t)
        want = jscore(params, jnp.asarray(batch["motion"]), jnp.asarray(batch["lengths"]),
                      jxp, jxo, t, rng)
        noise = np.asarray(jax.random.normal(rng, batch["motion"].shape, jnp.float32))
        got = score(t_(batch["motion"]), t_(batch["lengths"]).long(), xp, xo, t, noise=t_(noise))
        assert got.shape == (LABEL_BATCH, 2)
        assert_rel_close(got, want, 1e-5)


@pytest.mark.parametrize("cap_id", [False, True], ids=["tokens", "cap_id"])
def test_discovery_and_pseudo_labels_match_jax(data_root, scorers, cap_id):
    """The whole labeling stage: discovery on the annotated clips, then
    labels with 3 draws per t; the port fed JAX's noises."""
    params, jscorer, scorer = scorers["cap_id" if cap_id else "tokens"]
    anns = os.path.join(data_root, "test_active_anns.json")
    jann, ann = datasets(data_root, anns)
    jtrain, train = datasets(data_root)
    want_roles = jlab.discover_roles(jscorer, params, jann, LABEL_BATCH, jd.epoch_batches,
                                     cap_id=cap_id)
    roles = tl.discover_roles(scorer, ann, LABEL_BATCH, "cpu", cap_id=cap_id,
                              noise_fn=jax_noise_chain(0))
    assert roles == want_roles
    assert sum("active_index" in r for r in roles.values()) == 17
    want = jlab.pseudo_label(jscorer, params, jtrain, LABEL_BATCH, want_roles,
                             jd.epoch_batches, repeats=3, cap_id=cap_id)
    got = tl.pseudo_label(scorer, train, LABEL_BATCH, roles, "cpu", repeats=3, cap_id=cap_id,
                          noise_fn=jax_noise_chain(1))
    assert got == want and len(got) == LABEL_CLIPS
    assert set(got.values()) == {0, 1}


# --- guided sampling -------------------------------------------------------------------


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_guided_ddim_matches_jax(case):
    """w = 2.5, 4 DDIM steps, from JAX's own x_T; tolerance 1e-5 of the
    output scale as the unguided sampler's test (the guided step scales the
    denoiser's rounding by up to |1 − w| + w = 4)."""
    cap_id, no_eff = MODEL_CASES[case]
    jmodel, params, model = models(cap_id, drop=0.1, no_eff=no_eff)
    model.eval()
    cond = (np.array([[3, 4], [10, 11]], np.int32) if cap_id
            else tokenize(CAPS).astype(np.int32)[[[3, 4], [10, 11]]])
    lengths, Tg = np.array([12, 7], np.int32), 12
    sched = jg.make_schedule(jg.linear_betas(1000))
    rng = jax.random.key(11)
    jsample = jt.make_sampler(jmodel, sched, T=Tg, dim_pose=FEATS, sampler="ddim", ddim_steps=4,
                              guidance_scale=2.5)
    want = np.asarray(jsample(params, jnp.asarray(cond), jnp.asarray(lengths), rng))
    _, init_rng = jax.random.split(rng)
    noise = t_(np.asarray(jax.random.normal(init_rng, (2, 2, Tg, FEATS), jnp.float32)))
    tsched = tg.make_schedule(tg.linear_betas(1000))
    got = tt.make_sampler(model, tsched, T=Tg, dim_pose=FEATS, ddim_steps=4,
                          guidance_scale=2.5)(t_(cond).long(), t_(lengths), noise=noise).numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_guidance_one_is_the_unguided_sampler_and_needs_null_parameters():
    _, _, with_null = models(cap_id=True, drop=0.1)
    plain = InteractionModel(port_mcfg(cap_id=True))
    plain.load_state_dict({k: v for k, v in with_null.state_dict().items()
                           if not k.startswith("null_")})
    sched = tg.make_schedule(tg.linear_betas(1000))
    cond, lengths = torch.tensor([[3, 4], [10, 11]]), torch.tensor([12, 7])
    noise = t_(rand(2, 2, 12, FEATS, seed=2))
    outs = [tt.make_sampler(m.eval(), sched, T=12, dim_pose=FEATS, ddim_steps=3,
                            guidance_scale=1.0)(cond, lengths, noise=noise)
            for m in (with_null, plain)]
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="cond_drop_prob > 0"):
        tt.make_sampler(plain, sched, T=12, dim_pose=FEATS, guidance_scale=2.5)


# --- the CLIs and the trainer ----------------------------------------------------------


def tiny_args(root, ckpts, name):
    args = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", root,
            "--checkpoints_dir", ckpts, "--name", name, "--batch_size", "2", "--num_epochs",
            "1", "--log_every", "1", "--limit_data_num", "4"]
    for k, v in TINY.items():
        if k != "diffusion_steps":  # labeling takes t up to 920
            args += [f"--{k}", str(v)]
    return args


def test_three_stage_pipeline_clis(data_root, tmp_path):
    """PIT with caption ids → labels through ``python -m
    hig_tpu_torch.label`` → the supervised stage on them with caption
    dropout, the loss-aware sampler and a validation pass every epoch →
    guided serving of its checkpoint, all on the CPU."""
    from hig_tpu_torch import serve
    from hig_tpu_torch.train.__main__ import main as train_main

    root, ckpts = str(tmp_path / "data"), str(tmp_path / "runs")
    write_dataset(root, seed=1)
    _, pit = train_main(tiny_args(root, ckpts, "pit") + ["--cap_id"])
    assert pit.step == 2 and not any(n.startswith("text.clip") for n, _ in
                                     pit.model.named_parameters())
    opt = os.path.join(ckpts, "synthetic_mul", "pit", "opt.txt")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-m", "hig_tpu_torch.label", "--device", "cpu",
                    "--opt_path", opt, "--label_model", "--save_label", "--batch_size", "4"],
                   cwd=REPO, env=env, check=True, capture_output=True, timeout=300)
    roles = json.load(open(os.path.join(ckpts, "synthetic_mul", "pit", "pit_labels.json")))
    assert len(roles) == 26 and sum("active_index" in r for r in roles.values()) == 17
    labels_path = os.path.join(root, "pseudo_labels.json")
    labels = json.load(open(labels_path))
    assert len(labels) == 4 and set(labels.values()) <= {0, 1}

    trainer, sup = train_main(tiny_args(root, ckpts, "sup") + [
        "--cap_id", "--label_path", labels_path, "--cond_drop_prob", "0.1",
        "--loss_aware_sampler", "--eval_every_e", "1"])
    assert sup.step == 2 and "null_xf_proj" in dict(sup.model.named_parameters())
    lines = [json.loads(x) for x in open(os.path.join(trainer.cfg.save_root, "metrics.jsonl"))]
    assert [("loss_mot_rec" in x, "val_loss" in x) for x in lines] == [(True, False)] * 2 + [
        (False, True)]
    assert np.isfinite(lines[-1]["val_loss"])

    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"caption1": CLASSID2CAPS[0][0], "caption2": CLASSID2CAPS[0][1],
                                "length": 20, "id": "a"}) + "\n")
    out = tmp_path / "served"
    serve.main(["--requests", str(reqs), "--opt_path", trainer.cfg.save_root + "/opt.txt",
                "--guidance_scale", "2.5", "--ddim_steps", "2", "--device", "cpu",
                "--out_dir", str(out)])
    served = np.load(out / "a.npz")
    assert served["joints"].shape == (2, 20, 22, 3) and np.isfinite(served["joints"]).all()


def test_opt_txt_round_trip(tmp_path):
    cfg = ExperimentConfig(**TINY, cap_id=True, label_path="x.json", cond_drop_prob=0.1,
                           loss_aware_sampler=True, eval_every_e=2, guidance_scale=2.5)
    path = str(tmp_path / "opt.txt")
    save_opt_txt(cfg, path)
    assert load_opt_txt(path) == add_dataset_paths(dataclasses.replace(cfg))
    assert load_opt_txt(path, name="other").name == "other"


def test_rollback_resets_the_loss_aware_history(data_root, tmp_path):
    cfg = add_dataset_paths(ExperimentConfig(
        **TINY, dataset_name="synthetic_mul", data_root=data_root, checkpoints_dir=str(tmp_path),
        batch_size=4, log_every=1, name="nan", num_epochs=1, save_latest=1, cap_id=True,
        loss_aware_sampler=True, limit_data_num=12))
    trainer = tt.Trainer(cfg, "cpu")
    real_batch, real_history, calls = trainer._device_batch, trainer.new_loss_history, []

    def poisoned(batch, tower_feats):
        calls.append("batch")
        if calls.count("batch") == 2:
            batch = dict(batch, motion=np.full_like(batch["motion"], np.nan))
        return real_batch(batch, tower_feats)

    def history():
        calls.append("history")
        return real_history()

    trainer._device_batch, trainer.new_loss_history = poisoned, history
    logs = []
    dataset = td.PairDataset(cfg, np.zeros(FEATS + 4, np.float32), np.ones(FEATS + 4, np.float32),
                             "train_sub.txt")
    state = trainer.train(dataset, trainer.init_state(), log=logs.append)
    assert any("rolling back" in line for line in logs)
    assert calls == ["history", "batch", "batch", "history", "batch"]
    assert state.step == 2 and all(torch.isfinite(p).all() for p in state.model.parameters())
