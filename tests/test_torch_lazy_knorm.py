"""``LAZY_KNORM`` in the port (``hig_tpu_torch/models/attention.py``)
against JAX's flag of the same name (``hig_tpu/models/attention.py:114-155``)
on the CPU.

- The float32 lazy core (``efficient_attention(..., lazy=True)``, B3's
  twin) against JAX's ``efficient_attention`` with the flag set, at 2e-5;
  the model's ``_attend`` reads the flag.
- B3-bf16's lazy twin, forward and VJP, bit for bit against JAX's lazy
  chain compiled without excess precision (as ``tests/test_torch_bf16.py``
  compiles it), beside the eager twin and the eager backward, which must
  differ.
- One bfloat16 PIT step of a 2-layer model (the einsum route, B3-bf16's
  lazy twin) against JAX's ``make_loss_fn`` under the flag with JAX's t and
  noise fed in: the loss within LOSS_RATIO and the gradients within
  GRAD_RATIO of the bfloat16 effect, as ``tests/test_torch_bf16_train.py``
  holds the eager step.
- The CUDA graph caches of the train step and the sampler are keyed on the
  flag.

The flag is module state on both sides: every test resets it in
``finally``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models import attention as jatt
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models import attention as tatt
from hig_tpu_torch.ops import pallas_attention as pa
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import torch_state_from_flax
from tests.test_torch_bf16 import BF16, KH, b3_inputs, f32, jax_run, jb, tb
from tests.test_torch_bf16_train import (
    B,
    FEATS,
    GRAD_RATIO,
    LOSS_RATIO,
    TINY2,
    T,
    jax_exact,
    jax_step_inputs,
    port_model_for,
    t_,
    tree_ratio,
)

SHAPES = {"t91": (91, 91), "tq91_tk77": (91, 77), "t196": (196, 196)}
F32_TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def lazy(jax_side: bool = True, port_side: bool = True):
    """Both packages' LAZY_KNORM set (JAX reads it when it traces), then
    reset."""
    try:
        jatt.LAZY_KNORM, tatt.LAZY_KNORM = jax_side, port_side
        yield
    finally:
        jatt.LAZY_KNORM = tatt.LAZY_KNORM = False


def jax_core(q, k, v, mask, bf16: bool):
    """JAX's ``efficient_attention`` under the flag, compiled as ``jax_run``."""
    dt = jnp.bfloat16 if bf16 else jnp.float32
    with lazy():
        return jax_run(lambda *a: jatt.efficient_attention(*a[:3], KH, key_mask=a[3]), bf16,
                       *[jnp.asarray(jb(a) if bf16 else a, dt) for a in (q, k, v, mask)])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_float32_lazy_core_matches_jax(shape):
    """B3's lazy twin and the model's ``_attend`` under the flag against
    JAX's lazy core, float32, at 2e-5; the eager twin stays what it was."""
    q, k, v, mask = b3_inputs(*SHAPES[shape])
    want = np.asarray(jax_core(q, k, v, mask, False))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = pa.fused_efficient_attention_plain(*args, KH, torch.from_numpy(mask), lazy=True)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    with lazy(jax_side=False):
        routed = tatt._attend(*args, KH, torch.from_numpy(mask))
    assert torch.equal(routed, got)
    eager = tatt._attend(*args, KH, torch.from_numpy(mask))
    assert torch.equal(eager, pa.efficient_attention(*args, KH, torch.from_numpy(mask)))
    assert not torch.equal(eager, got)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_lazy_twin_is_jaxs_lazy_chain(shape):
    """B3-bf16's lazy twin against JAX's lazy chain on bfloat16 q, k, v and
    mask: bit for bit. The eager twin (the flag ignored) is not."""
    q, k, v, mask = b3_inputs(*SHAPES[shape])
    want = f32(jax_core(q, k, v, mask, True))
    args = (tb(q), tb(k), tb(v), KH, torch.from_numpy(mask))
    got = pa.fused_efficient_attention_plain(*args, lazy=True)
    assert got.dtype == BF16
    np.testing.assert_array_equal(f32(got), want)
    assert not np.array_equal(f32(pa.fused_efficient_attention_plain(*args)), want)
    for point in pa.B3_LAZY_ROUNDINGS[-2:]:  # the state's two roundings
        control = pa.fused_efficient_attention_plain(*args, unrounded=(point,), lazy=True)
        assert not np.array_equal(f32(control), want), point


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_lazy_backward_is_xlas_vjp(shape):
    """B3-bf16's lazy backward against ``jax.vjp`` of the lazy chain in
    bfloat16: bit for bit, for q, k and v; the eager backward is not, and
    neither is the twin's autograd (through HandBackward) any other than it."""
    q, k, v, mask = b3_inputs(*SHAPES[shape])
    g = np.random.RandomState(27).randn(*q.shape).astype(np.float32)

    def grads(q_, k_, v_, m_, g_):
        _, vjp = jax.vjp(lambda a, b, c: jatt.efficient_attention(a, b, c, KH, key_mask=m_),
                         q_, k_, v_)
        return vjp(g_)

    with lazy():
        want = jax_run(grads, True, *[jnp.asarray(jb(a), jnp.bfloat16)
                                      for a in (q, k, v, mask, g)])
    saved = (tb(q), tb(k), tb(v), torch.from_numpy(mask))
    got = pa.efficient_attention_backward(saved, tb(g), KH, lazy=True)
    eager = pa.efficient_attention_backward(saved, tb(g), KH)
    leaves = [t.clone().requires_grad_() for t in saved[:3]]
    y = pa.fused_efficient_attention_plain(*leaves, KH, saved[3], lazy=True)
    through = torch.autograd.grad(y, leaves, tb(g))
    for name, a, e, th, w in zip("qkv", got, eager, through, want):
        assert a.dtype == BF16
        np.testing.assert_array_equal(f32(a), f32(w), err_msg=name)
        assert torch.equal(th, a), name
        if name != "q":  # q's gradient takes no key normalization
            assert not np.array_equal(f32(e), f32(w)), name


def test_bf16_pit_step_under_the_flag_matches_jax():
    """One bfloat16 PIT step (caption ids, 2 layers: the efficient blocks'
    einsum route through B3-bf16's lazy twin) against JAX's ``make_loss_fn``
    (``use_pallas=False``) traced under the flag, JAX's t and noise fed in:
    the loss within LOSS_RATIO and every gradient within GRAD_RATIO of the
    bfloat16 effect (the port's float32 step); the step without the flag
    fails the loss gate."""
    fields = dict(TINY2, cap_id=True)
    jm, params, batch, rng = jax_step_inputs(fields, "bfloat16")
    fn = jax.value_and_grad(jt.make_loss_fn(jm, jg.make_schedule(jg.linear_betas(100)), True),
                            has_aux=True)
    with lazy():
        (want_loss, _), g = jax_exact(fn, params, batch, rng)
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, g))
    t_rng, n_rng = jax.random.split(rng)
    t = t_(np.asarray(jax.random.randint(t_rng, (B,), 0, 100))).long()
    noise = t_(np.asarray(jax.random.normal(n_rng, (B, 2, T, FEATS), jnp.float32)))

    def port_step(dtype):
        model, _ = port_model_for(fields, dtype)
        tt.make_optimizer(ExperimentConfig(**TINY2), model)
        loss_fn = tt.make_loss_fn(model, tg.make_schedule(tg.linear_betas(100)), True)
        tbatch = {k: t_(np.asarray(v)).long() if v.dtype == jnp.int32 else t_(f32(v))
                  for k, v in batch.items()}
        loss, _ = tt.compute_grads(model, loss_fn, tbatch, t=t, noise=noise)
        return float(loss), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    loss32, grads32 = port_step("float32")
    with lazy(jax_side=False):
        loss, grads = port_step("bfloat16")
    eager_loss, _ = port_step("bfloat16")
    effect = abs(float(want_loss) - loss32)
    assert effect > 0
    assert abs(loss - float(want_loss)) <= LOSS_RATIO * effect, (loss, float(want_loss), loss32)
    assert tree_ratio(grads, want, grads32) <= GRAD_RATIO
    # the control: the same step without the flag (the eager core) fails the
    # loss gate (the gradients' gate bounds the drift and cannot tell them
    # apart, as in tests/test_torch_bf16_train.py)
    assert abs(eager_loss - float(want_loss)) > LOSS_RATIO * effect


def test_graph_keys_follow_the_flag():
    """The train step's and the sampler's graph keys carry the flag: a
    graph captured under one value is never replayed under the other."""
    parts = (("motion", (2, 2, 9, 263), torch.float32),)
    eager = tt.graph_key(parts)
    with lazy(jax_side=False):
        flagged = tt.graph_key(parts)
    assert eager != flagged and eager[:-1] == flagged[:-1] == (parts,)
    assert tt.graph_key(parts) == eager
