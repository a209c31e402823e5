"""The port's train step is ready for CUDA-graph capture, checked on the CPU.

A capture records the step's device work once and replays it, so the step
may read no value back to the host, copy nothing from the host, size no
tensor by the data, and must keep every tensor it updates where the graph
recorded it:

- the loss-aware history's fold in fixed shapes equals the fold through
  ``torch.unique`` that it replaces (kept below as the reference; its
  parity with ``hig_tpu`` is ``test_torch_pipeline.py``'s), on cold,
  partial and full histories with a timestep repeated in each batch;
- with ``Tensor.item``, ``__bool__``, ``__float__``, ``__int__``,
  ``tolist``, ``torch.unique``, ``nonzero``, ``torch.tensor``,
  ``torch.as_tensor`` and ``DiffusionSchedule.on`` made to raise, the step
  a graph captures (a shape's second: the first, the eager warm-up, makes
  the device tables and the gradient buffers) runs for float32 PIT,
  loss-aware CFG supervised, caption ids, bf16 PIT, ``grad_accum`` 2 and
  the EMA; the old fold put back in the step makes the check raise;
- ``make_train_step(..., graph=True)`` on the CPU runs the eager step:
  three steps equal ``graph=False``'s bit for bit (parameters, Adam's
  moments, EMA, history, metrics), and the gradients keep their storage;
- a rollback (``checkpoint.restore_state``) writes into the tensors the
  state holds (parameters, gradients, moments, the optimizer's scalars,
  EMA), with the values of a restore into a fresh state;
- the device-scalar Adam, driven as the graphed step drives it (the host
  fills the step scalars, the update reads them) through a checkpoint
  round trip, against optax; a ``torch.optim.Adam`` state dict (the
  checkpoints of earlier port runs) loads and continues as Adam does.

Tiny widths, ``torch.set_num_threads(1)``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, model_config
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.diffusion import timestep_samplers as tss
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree, torch_state_from_flax

TINY = dict(num_layers=1, latent_dim=32, ff_size=64, num_heads=4, num_text_layers=1,
            text_latent_dim=16, text_ff_size=32, text_num_heads=2, diffusion_steps=100)
CLIP = ClipTextConfig(width=32, heads=2, layers=1)
B, T, FEATS = 4, 8, 263


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the loss-aware history in fixed shapes -----------------------------------------


def unique_fold(state, t, losses):
    """The fold the port had before (one ``torch.unique`` of the batch's
    timesteps, each touched row rebuilt once): the reference here."""
    H = state.losses.shape[1]
    t = t.long()
    rows, inverse, repeats = torch.unique(t, return_inverse=True, return_counts=True)
    order = torch.argsort(inverse, stable=True)
    first = torch.cumsum(repeats, 0) - repeats
    j = torch.empty_like(t)
    j[order] = torch.arange(t.shape[0]) - first[inverse[order]]
    count = state.counts[rows]
    ext = torch.zeros((rows.shape[0], H + t.shape[0]), dtype=state.losses.dtype)
    ext[:, :H] = state.losses[rows]
    ext[inverse, count[inverse] + j] = losses.detach().to(ext.dtype)
    total = count + repeats
    start = (total - H).clamp(min=0)
    new_rows = ext.gather(1, start[:, None] + torch.arange(H))
    losses_out, counts_out = state.losses.clone(), state.counts.clone()
    losses_out[rows] = new_rows
    counts_out[rows] = total.clamp(max=H)
    return tss.LossSecondMomentState(losses=losses_out, counts=counts_out)


HISTORY_CASES = {"cold": 0, "partial": 3, "full": 14}  # prior updates of one batch


@pytest.mark.parametrize("case", list(HISTORY_CASES))
def test_fixed_shape_fold_equals_the_unique_fold(case):
    """Batches of 8 over 6 timesteps with a history of 4, a timestep three
    times in each batch: rows and counts bit for bit after every batch, and
    the input state left as it was."""
    T_, H = 6, 4
    got = want = tss.LossSecondMomentState.create(T_, H)
    rs = np.random.RandomState(0)
    for _ in range(HISTORY_CASES[case] + 1):
        t = rs.randint(0, T_, 8)
        t[3] = t[5] = t[0]
        t, losses = torch.from_numpy(t), torch.from_numpy(rs.rand(8).astype(np.float32))
        prior, before = got, (got.losses.clone(), got.counts.clone())
        got, want = tss.loss_aware_update(got, t, losses), unique_fold(want, t, losses)
        assert torch.equal(got.losses, want.losses) and torch.equal(got.counts, want.counts)
        assert torch.equal(prior.losses, before[0]) and torch.equal(prior.counts, before[1])
    assert (got.counts == H).all() == (case == "full")


# --- one step, as a graph captures it ------------------------------------------------

# variant → (config fields, PIT)
VARIANTS = {
    "f32_pit": ({}, True),
    "cfg_loss_aware_supervised": (dict(label_path="labels.json", cond_drop_prob=0.5,
                                       loss_aware_sampler=True), False),
    "cap_id": (dict(cap_id=True), True),
    "bf16_pit": (dict(compute_dtype="bfloat16"), True),
    "grad_accum_2": (dict(grad_accum=2), True),
    "ema": (dict(ema_decay=0.9), True),
}


def make_state(cfg):
    mcfg = model_config(cfg, CLIP)
    model = InteractionModel(mcfg)
    load_flax_tree(model, random_flax_tree(mcfg, seed=0)["params"])
    model.train()
    ema = None
    if cfg.ema_decay > 0:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return tt.TrainState(model=model, optimizer=tt.make_optimizer(cfg, model), ema=ema)


def make_batch(model, cfg, seed=0):
    rs = np.random.RandomState(seed)
    cap_ids = torch.from_numpy(rs.randint(0, len(CAPS), (B, 2)))
    batch = {"motion": torch.from_numpy(rs.randn(B, 2, T, FEATS).astype(np.float32)),
             "lengths": torch.from_numpy(np.array([T, 5, 7, 3]))}
    if cfg.cap_id:
        batch["cap_ids"] = cap_ids
        return batch
    batch["tokens"] = torch.from_numpy(tokenize(CAPS).astype(np.int64))[cap_ids]
    with torch.no_grad():
        feats = model.clip_tower(batch["tokens"].reshape(-1, 77))
    batch["tower_feats"] = feats.reshape(B, 2, 77, -1)
    return batch


def setup(variant, graph=True):
    fields, pit = VARIANTS[variant]
    cfg = ExperimentConfig(**TINY, **fields)
    state = make_state(cfg)
    sched = tg.make_schedule(tg.linear_betas(cfg.diffusion_steps))
    step = tt.make_train_step(sched, pit, cfg.grad_accum, cfg.ema_decay,
                              cfg.loss_aware_sampler, graph=graph)
    history = tss.LossSecondMomentState.create(100) if cfg.loss_aware_sampler else None
    return cfg, state, step, history


def take(step, state, batch, history, gen):
    if history is None:
        return step(state, batch, gen), None
    return step(state, batch, gen, ts_state=history)


def _refuse(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"the train step called {name}")
    return fn


HOST_CALLS = [(torch.Tensor, "item"), (torch.Tensor, "__bool__"), (torch.Tensor, "__float__"),
              (torch.Tensor, "__int__"), (torch.Tensor, "tolist"), (torch, "unique"),
              (torch.Tensor, "unique"), (torch, "nonzero"), (torch.Tensor, "nonzero"),
              (torch, "tensor"), (torch, "as_tensor"), (tg.DiffusionSchedule, "on")]


def refuse_host_calls(monkeypatch):
    for owner, name in HOST_CALLS:
        monkeypatch.setattr(owner, name, _refuse(f"{getattr(owner, '__name__', owner)}.{name}"))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_the_captured_step_reads_and_copies_nothing_from_the_host(variant, monkeypatch):
    cfg, state, step, history = setup(variant)
    batch = make_batch(state.model, cfg)
    gen = torch.Generator().manual_seed(0)
    _, history = take(step, state, batch, history, gen)  # the warm-up
    refuse_host_calls(monkeypatch)
    metrics, history = take(step, state, batch, history, gen)
    monkeypatch.undo()
    assert set(metrics) == set(tt.TRAIN_METRICS)
    assert all(torch.isfinite(v) for v in metrics.values()) and state.step == 2
    if history is not None:
        assert int(history.counts.sum()) == 2 * B


def test_the_check_catches_a_data_sized_fold(monkeypatch):
    """The fold through ``torch.unique`` (its output sized by the data: a
    host sync on the card) put back in the step makes the check raise."""
    cfg, state, step, history = setup("cfg_loss_aware_supervised")
    batch = make_batch(state.model, cfg)
    gen = torch.Generator().manual_seed(0)
    _, history = take(step, state, batch, history, gen)
    monkeypatch.setattr(tss, "loss_aware_update", unique_fold)
    refuse_host_calls(monkeypatch)
    with pytest.raises(AssertionError, match="unique"):
        take(step, state, batch, history, gen)


def state_tensors(state, history=None):
    out = {f"param.{n}": p for n, p in state.model.named_parameters()}
    out.update({f"grad.{n}": p.grad for n, p in state.model.named_parameters()
                if p.grad is not None})
    opt = state.optimizer
    out.update({f"exp_avg.{i}": m for i, m in enumerate(opt.exp_avg)})
    out.update({f"exp_avg_sq.{i}": v for i, v in enumerate(opt.exp_avg_sq)})
    out.update(step_size=opt.step_size, bias_correction2_sqrt=opt.bias_correction2_sqrt)
    out.update({f"ema.{n}": e for n, e in (state.ema or {}).items()})
    if history is not None:
        out.update(history_losses=history.losses, history_counts=history.counts)
    return out


@pytest.mark.parametrize("variant", ["cfg_loss_aware_supervised", "grad_accum_2", "ema"])
def test_graph_keyword_runs_the_eager_step_on_the_cpu(variant):
    runs = []
    for graph in (True, False):
        cfg, state, step, history = setup(variant, graph=graph)
        batch = make_batch(state.model, cfg)
        gen = torch.Generator().manual_seed(3)
        metrics, storage = [], None
        for _ in range(3):
            m, history = take(step, state, batch, history, gen)
            metrics.append(torch.stack([m[k] for k in tt.TRAIN_METRICS]))
            grads = {n: p.grad.data_ptr() for n, p in state.model.named_parameters()
                     if p.grad is not None}
            assert storage is None or grads == storage  # gradients keep their storage
            storage = grads
        assert step.graphs == {}
        runs.append((torch.stack(metrics), state_tensors(state, history), gen.get_state()))
    (m1, s1, g1), (m2, s2, g2) = runs
    assert torch.equal(m1, m2) and torch.equal(g1, g2) and s1.keys() == s2.keys()
    for name in s1:
        assert torch.equal(s1[name], s2[name]), name


# --- rollback -----------------------------------------------------------------------


def test_rollback_restores_into_the_tensors_the_state_holds(tmp_path):
    """Two steps, a checkpoint, two more steps, then ``restore_state`` into
    the same state: every tensor a graph replays on keeps its storage and
    holds what a restore into a fresh state holds."""
    cfg, state, step, _ = setup("ema")
    batch = make_batch(state.model, cfg)
    gen = torch.Generator().manual_seed(1)
    path = str(tmp_path / "latest.pt")
    for i in range(4):
        step(state, batch, gen)
        if i == 1:
            ckpt.save_state(path, state, epoch=0, total_it=2)
    held = state_tensors(state)
    ptrs = {n: t.data_ptr() for n, t in held.items()}
    state, epoch, it = ckpt.restore_state(path, state)
    fresh, _, _ = ckpt.restore_state(path, make_state(cfg))
    assert (epoch, it, state.step, state.optimizer.count) == (0, 2, 2, 2)
    now = state_tensors(state)
    assert {n: t.data_ptr() for n, t in now.items()} == ptrs
    want = state_tensors(fresh)
    for name, t in now.items():
        if name.startswith("grad.") or name in ("step_size", "bias_correction2_sqrt"):
            continue  # the next step overwrites these before it reads them
        assert torch.equal(t, want[name]), name
    # the next step from either state is the same step
    for s in (state, fresh):
        step_s = tt.make_train_step(tg.make_schedule(tg.linear_betas(100)), True,
                                    ema_decay=cfg.ema_decay)
        step_s(s, batch, torch.Generator().manual_seed(7))
    for name, t in state_tensors(state).items():
        assert torch.equal(t, state_tensors(fresh)[name]), name


# --- the device-scalar Adam ----------------------------------------------------------


def test_device_scalar_adam_through_a_checkpoint_matches_optax():
    """Four updates under the warmup schedule, each as the graphed step
    runs it (``prepare`` fills the step scalars, ``update`` reads them),
    the optimizer's state dict loaded into a fresh optimizer after the
    second, against optax's multi_transform: parameters within 1e-6, the
    frozen CLIP tower unchanged."""
    kw = dict(lr=1e-2, warmup_steps=2, num_layers=1)
    jcfg, cfg = JaxConfig(**{**TINY, **kw}), ExperimentConfig(**{**TINY, **kw})
    tree = random_flax_tree(model_config(cfg, CLIP), seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jt.make_optimizer(jcfg, params)
    opt_state = tx.init(params)
    jax_step = jax.jit(lambda p, s, g: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    state = make_state(cfg)
    model = state.model
    clip0 = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    for count, norm in enumerate((3.0, 0.2, 1.0, 0.4)):
        rs = np.random.RandomState(count)
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rs.randn(*x.shape).astype(np.float32) * norm
                                  / np.sqrt(n_train)), params)
        params, opt_state = jax_step(params, opt_state, grads)
        tgrads = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = tgrads[n].clone()
        state.optimizer.prepare(count)
        state.optimizer.update()
        if count == 1:
            saved = state.optimizer.state_dict()
            state.optimizer = tt.make_optimizer(cfg, model)
            state.optimizer.load_state_dict(saved)
            assert state.optimizer.count == 2
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=0)
    assert all(torch.equal(p, clip0[n]) for n, p in model.named_parameters() if n in clip0)


def test_a_torch_adam_state_dict_loads_and_continues_as_adam():
    """An ``opt_state`` that ``torch.optim.Adam`` wrote (the port's
    checkpoints before the device-scalar Adam) after two updates loads into
    the optimizer, which then takes the third update as Adam does: moments
    and parameters within 1e-7 of the largest magnitude."""
    cfg = ExperimentConfig(**TINY, lr=1e-3)
    state = make_state(cfg)
    opt = state.optimizer
    twin = [p.detach().clone().requires_grad_() for p in opt.params]
    adam = torch.optim.Adam(twin, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    rs = np.random.RandomState(0)
    scale = 0.1 / np.sqrt(sum(p.numel() for p in twin))  # a global norm below the clip
    grads = [[torch.from_numpy((rs.randn(*p.shape) * scale).astype(np.float32)) for p in twin]
             for _ in range(3)]
    for g in grads[:2]:
        for p, gi in zip(twin, g):
            p.grad = gi.clone()
        adam.step()
    with torch.no_grad():
        for p, q in zip(opt.params, twin):
            p.copy_(q)
    opt.load_state_dict(copy.deepcopy(adam.state_dict()))
    assert opt.count == 2
    for p, q, gi in zip(opt.params, twin, grads[2]):
        p.grad, q.grad = gi.clone(), gi.clone()
    adam.step()
    opt.prepare(2)
    opt.update()
    moments = adam.state_dict()["state"]
    for i, (p, q) in enumerate(zip(opt.params, twin)):
        for got, want in ((p, q), (opt.exp_avg[i], moments[i]["exp_avg"]),
                          (opt.exp_avg_sq[i], moments[i]["exp_avg_sq"])):
            got, want = got.detach(), want.detach()
            assert float((got - want).abs().max()) <= 1e-7 * float(want.abs().max())
