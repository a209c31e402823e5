"""bfloat16 training and labeling of the PyTorch port (hig_tpu_torch) against
hig_tpu on the CPU: ``compute_dtype: bfloat16`` (with ``fast_ln`` and
``rms_norm``) on float32 master weights.

- B3-bf16's twin is JAX's ``efficient_attention`` on bfloat16 inputs (the
  einsum route a bfloat16 model trains through), bit for bit; B3-bf16's and
  B4-bf16's backwards are XLA's VJPs of their JAX references in bfloat16,
  beside the forms they replace (the float32 VJP rounded once; autograd
  through B4's twin), which fail the same gates; the ordered bfloat16 sum
  they take is XLA's bfloat16 reduce bit for bit, where a float32 sum
  rounded once is not.
- B2 on bfloat16 activations with float32 weights (the Pallas kernel in
  interpret mode on those dtypes), and its refusal under grad; JAX's
  ``use_pallas=True`` bfloat16 train step raising, which is why the port's
  bfloat16 training is held against ``use_pallas=False``.
- One self-attention and one interaction block in train mode, forward and
  every parameter gradient; the loss and every gradient of a 2-layer model
  (PIT, supervised with a keep mask, rms_norm + fast_ln, caption ids,
  --no_eff) against JAX's ``make_loss_fn`` with t and noise fed in; the
  labeling scorer (fused and projected blocks) against
  ``make_assignment_scorer``.
- A CPU ``Trainer`` run in bfloat16 (float32 parameters and Adam state,
  losses tracking the float32 run), and the train and label CLIs on a
  bfloat16 run.

Tolerances. JAX references in bfloat16 are compiled without excess
precision (``tests/test_torch_bf16.py``), so XLA rounds after every op. The
"bfloat16 effect" is the distance of JAX's bfloat16 result from the float32
one on the same inputs and weights; each comparison is an RMS distance as a
fraction of it. Where the port rounds op for op as XLA does (the kernels'
forwards and backwards, the loss) the gates are tight, and a control that
leaves the rounding points out sits near the effect. Elsewhere torch's
autograd rounds a bfloat16 op chain's backward at its own points (a bias
gradient, for one, is a float32 sum rounded once, where XLA adds in
bfloat16), so model gradients sit 0.41-0.72 of the effect from JAX's and
are held to GRAD_RATIO: that gate bounds the drift and proves no rounding
point. No gradient gate of a block or a model can: the backwards' earlier
forms, planted back (B3-bf16's float32 VJP rounded once, autograd
through B4-bf16's twin), read within PLANTED_SPREAD of the repaired ones
there (``test_loss_and_grads_match_jax`` pins it), so the kernels'
backwards are held at kernel level only.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.attention import efficient_attention as jax_efficient_attention
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu.train import labeling as jlab
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, model_config, save_opt_txt
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models import attention as tatt
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.ops import flash_attention as fa
from hig_tpu_torch.ops import pallas_attention as pa
from hig_tpu_torch.ops.flash_attention import (
    _flash_bf16_plain,
    flash_attention,
    flash_attention_backward,
)
from hig_tpu_torch.train import labeling as tl
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import (
    cast_floating,
    load_flax_tree,
    random_flax_tree,
    torch_state_from_flax,
)
from tests.test_torch_bf16 import (
    BF16,
    KH,
    ULP,
    b3_inputs,
    f32,
    jax_run,
    jb,
    kernel_inputs,
    tb,
)
from tests.test_torch_pipeline import (  # noqa: F401
    B,
    FEATS,
    JAX_CLIP,
    LENGTHS,
    PORT_CLIP,
    T,
    TINY,
    data_root,
    rand,
    t_,
)
from tests.test_torch_train import dataset_for, trainer_cfg

TINY2 = dict(TINY, num_layers=2)
# kernels: rms(port − XLA) / bfloat16 effect; the replaced forms sit near 1
KERNEL_RATIO, CONTROL_RATIO = 0.05, 0.5
# model: the loss (its forward rounds as XLA's does; at 2 layers one rounding
# flipped by a float32 sum taken in another order moves the later ones: the
# caption-id case reads 0.037, the controls 0.074-0.24) and the gradients
# (0.41-0.55 a model, 0.61-0.72 a block; see the module doc)
LOSS_RATIO, GRAD_RATIO = 0.05, 0.75
BLOCK_RATIO = 0.5  # a block's forward
# the model-level JAX references: no excess precision, and the backend's
# code generation left cheap (its numbers are the same; compiles are faster)
EXACT_FAST = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0,
              "xla_llvm_disable_expensive_passes": True}


def jax_exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_FAST)(*args)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def ratio(got, want, want_f32) -> float:
    """rms(got − want) as a fraction of rms(want − want_f32)."""
    got, want, want_f32 = f32(got), f32(want), f32(want_f32)
    effect = rms(want - want_f32)
    assert effect > 0
    return rms(got - want) / effect


def tree_ratio(got: dict, want: dict, want_f32: dict) -> float:
    """:func:`ratio` over every leaf of ``got`` at once; a leaf of ``want``
    that ``got`` lacks (the frozen CLIP tower's) must be exactly 0."""
    keys = sorted(got)
    assert set(keys) <= set(want)
    assert all(not np.any(f32(want[k])) for k in set(want) - set(keys))
    cat = [np.concatenate([f32(d[k]).ravel() for k in keys]) for d in (got, want, want_f32)]
    return ratio(*cat)


# --- the kernels ------------------------------------------------------------------------

B3_SHAPES = {"t91": (91, 91), "tq91_tk77": (91, 77), "t196": (196, 196)}


@pytest.mark.parametrize("shape", list(B3_SHAPES))
def test_b3_twin_is_efficient_attention_in_bf16(shape):
    """B3-bf16's twin against JAX's einsum ``efficient_attention`` on
    bfloat16 q, k, v and mask (a bfloat16 model's core in train mode): bit
    for bit. The twin without its state rounding is not."""
    q, k, v, mask = b3_inputs(*B3_SHAPES[shape])
    want = jax_run(lambda *a: jax_efficient_attention(*a[:3], KH, key_mask=a[3]), True,
                   *[jb(a) for a in (q, k, v, mask)])
    args = (tb(q), tb(k), tb(v), KH, t_(mask))
    got = pa.fused_efficient_attention_plain(*args)
    assert got.dtype == BF16
    np.testing.assert_array_equal(f32(got), f32(want))
    control = pa.fused_efficient_attention_plain(*args, unrounded=("att",))
    assert not np.array_equal(f32(control), f32(want))


SUM_TERMS = (1, 12, 32, 33, 64, 91, 95, 97, 196, 394, 1000, 1025, 2048, 4096)


@pytest.mark.parametrize("n", SUM_TERMS)
def test_bf16_sum_is_xlas_bf16_reduce(n):
    """The ordered bfloat16 sum (its plain version, which a CPU tensor
    takes) against XLA's reduce of a bfloat16 array over the middle and the
    last axis (``lax.reduce``, no upcast), bit for bit; the float32 sum
    rounded once differs (past 2 terms)."""
    from hig_tpu_torch.ops.bf16_sum import bf16_sum

    x = np.random.RandomState(n).randn(3, n, 5).astype(np.float32)
    for axis in (1, 2):
        xt = tb(np.moveaxis(x, 1, axis).copy()).float()
        want = jax_run(lambda a: jax.lax.reduce(a, np.array(0, a.dtype), jax.lax.add, (axis,)),
                       True, jb(xt.numpy()))
        before = bf16_sum.launches
        got = bf16_sum(xt, axis)
        assert bf16_sum.launches == before
        assert got.dtype == torch.float32 and got.shape[axis] == 1
        np.testing.assert_array_equal(f32(got).squeeze(axis), f32(want))
        if n > 2:
            once = xt.sum(axis).to(BF16)
            assert not np.array_equal(f32(once), f32(want))


# The sum kernel's two layouts at the shapes the bfloat16 backwards give it:
# B3-bf16's feature softmax (64 contiguous terms: rows staged in shared
# memory) and its time softmax (91 terms 512 apart: a thread per output and
# window); (shape, axis)
SUM_LAYOUTS = {"contiguous_64": ((300, 64), 1), "stride512_91": ((2, 91, 512), 1)}


@pytest.mark.parametrize("layout", list(SUM_LAYOUTS))
def test_bf16_sum_is_xlas_bf16_reduce_at_the_kernel_layouts(layout):
    """The plain ordered sum, which the kernel is held to bit for bit on
    the card, against XLA's reduce of the bfloat16 array (``lax.reduce``),
    bit for bit, at each of the kernel's layouts."""
    from hig_tpu_torch.ops.bf16_sum import bf16_sum

    shape, axis = SUM_LAYOUTS[layout]
    xt = tb(np.random.RandomState(0).randn(*shape).astype(np.float32)).float()
    want = jax_run(lambda a: jax.lax.reduce(a, np.array(0, a.dtype), jax.lax.add, (axis,)),
                   True, jb(xt.numpy()))
    got = bf16_sum(xt, axis)
    np.testing.assert_array_equal(f32(got).squeeze(axis), f32(want))


def sum_rounded_once(x, dim):
    """A float32 sum rounded once, in the ordered bfloat16 sum's place."""
    return x.sum(dim, keepdim=True).to(BF16).float()


def sum_once_grads(monkeypatch, backward, *args):
    """``backward(*args)`` with every bfloat16 sum of the softmax VJPs taken
    in float32 and rounded once: the gradients of q and k (v's takes no
    softmax)."""
    from hig_tpu_torch.models import embeddings

    with monkeypatch.context() as m:
        m.setattr(embeddings, "bf16_sum", sum_rounded_once)
        return backward(*args)[:2]


def once_rounded_b3_backward(q, k, v, mask, g):
    """B3-bf16's earlier backward, a fault: the float32 VJP of the core
    on the bfloat16 operands, rounded once."""
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = pa.efficient_attention(*leaves, KH, mask)
    return [d.to(BF16) for d in torch.autograd.grad(out, leaves, g.float())]


@pytest.mark.parametrize("shape", list(B3_SHAPES))
def test_b3_bf16_backward_is_xlas_vjp(shape, monkeypatch):
    """B3-bf16's backward against ``jax.vjp`` of ``efficient_attention`` in
    bfloat16: within KERNEL_RATIO of the bfloat16 effect (all but a few
    elements equal: float32 sums in another order); the once-rounded
    float32 VJP sits near the effect and fails, and so does the backward
    with its softmaxes' bfloat16 sums taken in float32 and rounded once."""
    tq, tk = B3_SHAPES[shape]
    q, k, v, mask = b3_inputs(tq, tk)
    g = np.random.RandomState(27).randn(*q.shape).astype(np.float32)

    def jax_grads(bf16):
        def grads(q_, k_, v_, m_, g_):
            _, vjp = jax.vjp(lambda a, b, c: jax_efficient_attention(a, b, c, KH, key_mask=m_),
                             q_, k_, v_)
            return vjp(g_)

        dt = jnp.bfloat16 if bf16 else jnp.float32
        return jax_run(grads, bf16, *[jnp.asarray(jb(a), dt) for a in (q, k, v, mask, g)])

    want, want32 = jax_grads(True), jax_grads(False)
    got = pa.efficient_attention_backward((tb(q), tb(k), tb(v), t_(mask)), tb(g), KH)
    control = once_rounded_b3_backward(tb(q), tb(k), tb(v), t_(mask), tb(g))
    for a, c, w, w32 in zip(got, control, want, want32):
        assert a.dtype == BF16
        assert np.mean(f32(a) != f32(w)) <= 1e-3
        assert ratio(a, w, w32) <= KERNEL_RATIO
        assert ratio(c, w, w32) > CONTROL_RATIO
    once = sum_once_grads(monkeypatch, pa.efficient_attention_backward,
                          (tb(q), tb(k), tb(v), t_(mask)), tb(g), KH)
    for c, w, w32 in zip(once, want, want32):
        assert ratio(c, w, w32) > KERNEL_RATIO


@pytest.mark.parametrize("case", ["self", "partner", "causal"])
def test_b4_bf16_backward_is_xlas_vjp(case, monkeypatch):
    """B4-bf16's backward (the ``--no_eff`` bfloat16 train step) against
    ``jax.vjp`` of the Pallas flash kernel (``_flash_bwd``, its einsum
    reference) in bfloat16; autograd through B4's twin, the backward it
    replaces, fails, and so does the backward with its softmax's bfloat16
    sum taken in float32 and rounded once."""
    from hig_tpu.ops.flash_attention import flash_attention as pallas_flash

    _, _, mask, _, _ = kernel_inputs(tq=T, seed=30)
    rng = np.random.RandomState(31)
    q, k, v, g = (rng.randn(2, 2, T, 64).astype(np.float32) for _ in range(4))
    causal, partner = case == "causal", case == "partner"

    def jax_grads(bf16):
        def grads(q_, k_, v_, m_, g_):
            if partner:
                k_, v_, m_ = jnp.flip(k_, 1), jnp.flip(v_, 1), jnp.flip(m_, 1)
            _, vjp = jax.vjp(lambda a, b, c: pallas_flash(a, b, c, KH, key_mask=m_,
                                                          causal=causal, interpret=True),
                             q_, k_, v_)
            dq, dk, dv = vjp(g_)
            return (dq, jnp.flip(dk, 1), jnp.flip(dv, 1)) if partner else (dq, dk, dv)

        dt = jnp.bfloat16 if bf16 else jnp.float32
        return jax_run(grads, bf16, *[jnp.asarray(jb(a), dt) for a in (q, k, v, mask, g)])

    want, want32 = jax_grads(True), jax_grads(False)
    operands = (tb(q), tb(k), tb(v))
    got = flash_attention_backward((*operands, t_(mask)), tb(g), KH, causal, partner)
    control = pa.recompute_grads(
        lambda a, b, c: _flash_bf16_plain(a, b, c, KH, t_(mask), causal, partner),
        operands, (True,) * 3, tb(g))
    for a, c, w, w32 in zip(got, control, want, want32):
        assert a.dtype == BF16
        assert ratio(a, w, w32) <= KERNEL_RATIO
        assert ratio(c, w, w32) > CONTROL_RATIO
    once = sum_once_grads(monkeypatch, flash_attention_backward, (*operands, t_(mask)), tb(g),
                          KH, causal, partner)
    for c, w, w32 in zip(once, want, want32):
        assert ratio(c, w, w32) > KERNEL_RATIO


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
def test_mixed_b2_twin_matches_pallas(same_source):
    """B2 on bfloat16 activations with float32 weights (a bfloat16 model's
    ``use_pallas`` blocks on master weights) against ``_proj_impl`` in
    interpret mode: float32 q|k|v and core, y rounded once. Held to 1
    bfloat16 ulp of the largest output and KERNEL_RATIO of the effect of
    that one rounding; the twin with B1-bf16's core roundings fails."""
    from hig_tpu.ops.pallas_attention import fused_projected_attention as pallas_proj

    w, x, mask, _, _ = kernel_inputs(tq=T, seed=32)
    kv, kmask = (x, mask) if same_source else (np.flip(x, 1).copy(), np.flip(mask, 1).copy())
    weights = [w[n] for n in ("wq", "bq", "wk", "bk", "wv", "bv")]

    def pallas(dt):
        return pallas_proj(jnp.asarray(jb(x), dt), jnp.asarray(jb(kv), dt),
                           *[jnp.asarray(a) for a in weights], KH,
                           key_mask=jnp.asarray(kmask, dt), interpret=True)

    want, want32 = pallas(jnp.bfloat16), pallas(jnp.float32)
    assert want.dtype == jnp.bfloat16
    torch_w = [t_(a.T.copy() if a.ndim == 2 else a) for a in weights]  # torch (out, in)
    args = (tb(x), tb(x) if same_source else tb(kv), *torch_w, KH, t_(kmask))
    before = pa.fused_projected_attention.launches_mixed
    with torch.no_grad():
        got = pa.fused_projected_attention(*args)  # a CPU tensor takes the twin
        control = pa.fused_projected_attention_plain(*args, rounded=pa.CORE_ROUNDINGS)
    assert pa.fused_projected_attention.launches_mixed == before
    assert got.dtype == BF16
    assert np.abs(f32(got) - f32(want)).max() <= ULP * np.abs(f32(want)).max()
    assert ratio(got, want, want32) <= KERNEL_RATIO
    assert ratio(control, want, want32) > CONTROL_RATIO


def test_mixed_b2_has_no_backward():
    """JAX's VJP of the mixed form fails, so the port's raises on either
    device when a gradient is asked of it; under no_grad it runs."""
    w, x, mask, _, _ = kernel_inputs(tq=12, seed=33)
    ws = [t_(w[n]) for n in ("wq", "bq", "wk", "bk", "wv", "bv")]
    xb = tb(x).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        pa.fused_projected_attention(xb, xb, *ws, KH, t_(mask))
    with torch.no_grad():
        assert pa.fused_projected_attention(xb, xb, *ws, KH, t_(mask)).dtype == BF16


def test_jax_pallas_bf16_train_step_raises():
    """JAX's ``use_pallas=True`` bfloat16 train step fails in its B2 VJP
    (the float32 recompute meets a bfloat16 cotangent), while
    ``use_pallas=False`` trains: the port's bfloat16 training is held
    against the latter. If JAX ever takes this VJP, revisit the route rule
    in ``hig_tpu_torch/models/attention.py``."""
    jm, params, batch, rng = jax_step_inputs(dict(TINY, cap_id=True), "bfloat16",
                                             use_pallas=True)
    loss_fn = jt.make_loss_fn(jm, jg.make_schedule(jg.linear_betas(100)), True)
    with pytest.raises(ValueError, match="bfloat16"):
        jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params, batch, rng)


# --- blocks and the model in train mode ---------------------------------------------------


def port_model_for(fields: dict, dtype: str):
    """The port's model of ``fields`` (TINY-style) with the seeded tree's
    weights, float32 parameters, in train mode."""
    jfields = {k: v for k, v in fields.items() if k not in ("drop",)}
    mcfg = model_config(ExperimentConfig(**jfields, compute_dtype=dtype), PORT_CLIP)
    mcfg = dataclasses.replace(mcfg, cond_drop_prob=fields.get("drop", 0.0))
    tree = random_flax_tree(dataclasses.replace(mcfg, compute_dtype="float32"), seed=0)
    return load_flax_tree(InteractionModel(mcfg), tree["params"]).train(), tree


def jax_step_inputs(fields: dict, dtype: str, use_pallas=False):
    """(JAX model, params, batch, rng) of one train step on B pairs."""
    model, tree = port_model_for(fields, "float32")
    del model
    jfields = {k: v for k, v in fields.items() if k != "drop"}
    jm = model_from_config(JaxConfig(**jfields, cond_drop_prob=fields.get("drop", 0.0),
                                     compute_dtype=dtype, use_pallas=use_pallas),
                           clip_config=JAX_CLIP)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rs = np.random.RandomState(0)
    cap_ids = rs.randint(0, 43, (B, 2)).astype(np.int32)
    batch = {"motion": rand(B, 2, T, FEATS, seed=1), "lengths": LENGTHS}
    if fields.get("cap_id"):
        batch["cap_ids"] = cap_ids
    else:
        from hig_tpu_torch.models.tokenizer import tokenize
        from hig_tpu_torch.data.vocab import CAPS

        tokens = tokenize(CAPS).astype(np.int32)
        feats = jax.jit(lambda p, tk: jm.apply(p, tk, method=JaxModel.clip_tower))(
            params, jnp.asarray(tokens))
        batch.update(tokens=tokens[cap_ids], tower_feats=np.asarray(feats)[cap_ids])
    return jm, params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(7)


BLOCK_CASES = {"self_attention": "sa_block", "interaction": "int_ca_block"}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_train_mode_block_matches_flax(case):
    """One efficient block of layer 0 in train mode on float32 master
    weights, its forward and every parameter gradient against the flax block
    in bfloat16 on JAX's einsum route (``use_pallas=False``); the bfloat16
    effect is against the port's float32 block. The forward (through
    B3-bf16's twin) within BLOCK_RATIO of the effect, the same block with
    its core unrounded above it; the gradients within GRAD_RATIO, a bound
    on the drift (the module doc says why no control fails it)."""
    name = BLOCK_CASES[case]
    fields = dict(TINY, cap_id=True)
    jm, params, _, _ = jax_step_inputs(fields, "bfloat16")
    D, E = 32, 128
    h, emb = rand(B, 2, T, D, seed=8), rand(B, 2, E, seed=9)
    mask = (np.arange(T) < LENGTHS[:, None]).astype(np.float32)[:, None, :]
    cot = rand(B, 2, T, D, seed=10)

    def jax_block():
        def out_and_loss(p, *a):
            y = jm.apply(p, *a, method=lambda m, *b: getattr(m.denoiser.layers[0], name)(*b))
            return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot)), y

        fn = jax.value_and_grad(out_and_loss, has_aux=True)
        (_, y), g = jax_exact(fn, params, *[jb(a) for a in (h, emb, mask)])
        g = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, g))
        prefix = f"denoiser.layers.0.{name}."
        return y, {k: v for k, v in g.items() if k.startswith(prefix)}

    def port_block(dtype, core=None):
        model, _ = port_model_for(fields, dtype)
        block = getattr(model.denoiser.layers[0], name)
        cast = tb if dtype == "bfloat16" else (lambda a: tb(a).float())
        saved = tatt.fused_efficient_attention
        if core is not None:
            tatt.fused_efficient_attention = core
        try:
            y = block(cast(h), cast(emb), cast(mask))
        finally:
            tatt.fused_efficient_attention = saved
        (y.float() * t_(cot)).sum().backward()
        prefix = f"denoiser.layers.0.{name}."
        return y.detach(), {prefix + k: p.grad for k, p in block.named_parameters()}

    y16, g16 = jax_block()
    y32, g32 = port_block("float32")  # JAX's float32 block within 2e-5 (test_torch_port.py)
    got, grads = port_block("bfloat16")
    unrounded, _ = port_block("bfloat16", core=lambda q, k, v, heads, key_mask=None: (
        pa.efficient_attention(q.float(), k.float(), v.float(), heads, key_mask.float())
        .to(BF16)))
    assert got.dtype == BF16
    assert ratio(got, y16, y32) <= BLOCK_RATIO
    assert np.abs(f32(got) - f32(y16)).max() <= 2 * ULP * np.abs(f32(y16)).max()
    assert ratio(unrounded, y16, y32) > BLOCK_RATIO
    assert tree_ratio(grads, g16, g32) <= GRAD_RATIO


# name → the model's fields (``drop``: caption dropout, supervised)
STEP_CASES = {
    "pit": dict(TINY2),
    "supervised_keep": dict(TINY2, drop=0.5),
    "rms_norm_fast_ln": dict(TINY2, cap_id=True, rms_norm=True, fast_ln=True),
    "cap_id": dict(TINY2, cap_id=True),
    "no_eff": dict(TINY2, cap_id=True, no_eff=True),
}


def planted_b3_backward(query, key, value, key_mask, grad_out, num_heads):
    """B3-bf16's backward before its repair, in
    ``efficient_attention_bf16_backward``'s place: the float32 VJP rounded
    once."""
    leaves = [t.detach().float().requires_grad_() for t in (query, key, value)]
    with torch.enable_grad():
        out = pa.efficient_attention(*leaves, num_heads, key_mask)
    return tuple(d.to(BF16) for d in torch.autograd.grad(out, leaves, grad_out.float()))


def planted_b4_backward(query, key, value, key_mask, grad_out, num_heads, causal, partner):
    """B4-bf16's backward before the repair, in
    ``flash_attention_bf16_backward``'s place: autograd through its twin."""
    leaves = [t.detach().requires_grad_() for t in (query, key, value)]
    with torch.enable_grad():
        out = _flash_bf16_plain(*leaves, num_heads, key_mask, causal, partner)
    return torch.autograd.grad(out, leaves, grad_out)


# step case → (module, backward, the repaired backward's name) planted back
PLANTED = {"cap_id": (pa, planted_b3_backward, "efficient_attention_bf16_backward"),
           "no_eff": (fa, planted_b4_backward, "flash_attention_bf16_backward")}
PLANTED_SPREAD = 0.1  # a planted fault moves the gradient reading less than this


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_loss_and_grads_match_jax(case, monkeypatch):
    """One bfloat16 train step's loss and every gradient against JAX's
    ``make_loss_fn`` in bfloat16 (``use_pallas=False``; ``use_pallas=True``
    for --no_eff, the quadratic blocks' kernel) with JAX's t, noise and keep
    fed in; the bfloat16 effect is against the port's float32 model (held
    to JAX's float32 loss in ``test_torch_pipeline.py``). Parameters stay
    float32. The loss within LOSS_RATIO, with the efficient blocks' core
    unrounded above it (the quadratic model: the float32 model); the
    gradients within GRAD_RATIO, a bound on the drift: the kernels' backwards
    before their repair, planted back (``PLANTED``), read within
    PLANTED_SPREAD of the repaired ones and pass it too."""
    fields = STEP_CASES[case]
    pit = "drop" not in fields
    no_eff = fields.get("no_eff", False)
    jm, params, batch, rng = jax_step_inputs(fields, "bfloat16", use_pallas=no_eff)
    sched = jg.make_schedule(jg.linear_betas(100))
    fn = jax.value_and_grad(jt.make_loss_fn(jm, sched, pit), has_aux=True)
    (want_loss, _), g = jax_exact(fn, params, batch, rng)
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, g))

    t_rng, n_rng = jax.random.split(rng)
    t = t_(np.asarray(jax.random.randint(t_rng, (B,), 0, 100))).long()
    noise = t_(np.asarray(jax.random.normal(n_rng, (B, 2, T, FEATS), jnp.float32)))
    keep = None
    if not pit:
        keep = t_(np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 7), 0.5, (B,))))
        assert 0 < keep.sum() < B

    def port_step(dtype, core=None):
        """Loss and gradients; with ``core`` (a control), the loss alone."""
        model, _ = port_model_for(fields, dtype)
        tt.make_optimizer(ExperimentConfig(**TINY), model)  # marks the CLIP tower frozen
        loss_fn = tt.make_loss_fn(model, tg.make_schedule(tg.linear_betas(100)), pit)
        tbatch = {k: t_(np.asarray(v)).long() if v.dtype == jnp.int32 else t_(f32(v))
                  for k, v in batch.items()}
        if "tower_feats" in tbatch and dtype == "bfloat16":  # the bfloat16 tower's features
            tbatch["tower_feats"] = tbatch["tower_feats"].to(BF16)
        if core is not None:
            saved = tatt.fused_efficient_attention
            tatt.fused_efficient_attention = core
            try:
                with torch.no_grad():
                    return float(loss_fn(tbatch, t=t, noise=noise, keep=keep)[0]), None
            finally:
                tatt.fused_efficient_attention = saved
        loss, _ = tt.compute_grads(model, loss_fn, tbatch, t=t, noise=noise, keep=keep)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        return float(loss), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    loss32, grads32 = port_step("float32")
    loss, grads = port_step("bfloat16")
    effect = abs(float(want_loss) - loss32)
    assert effect > 0
    assert abs(loss - float(want_loss)) <= LOSS_RATIO * effect, (loss, float(want_loss), loss32)
    if no_eff:
        control_loss = loss32
    else:
        control_loss, _ = port_step("bfloat16", core=lambda q, k, v, heads, key_mask=None: (
            pa.efficient_attention(q.float(), k.float(), v.float(), heads, key_mask.float())
            .to(BF16)))
    assert abs(control_loss - float(want_loss)) > LOSS_RATIO * effect
    assert all(g.dtype == torch.float32 for g in grads.values())
    reading = tree_ratio(grads, want, grads32)
    assert reading <= GRAD_RATIO
    if case in PLANTED:
        module, backward, name = PLANTED[case]
        monkeypatch.setattr(module, name, backward)
        _, planted = port_step("bfloat16")
        assert abs(tree_ratio(planted, want, grads32) - reading) < PLANTED_SPREAD


# --- labeling ---------------------------------------------------------------------------

# port blocks → JAX route flags of make_assignment_scorer
SCORER_ROUTES = {"fused": dict(fused_blocks=True, use_pallas=True), "projected": dict(use_pallas=True)}


@pytest.mark.parametrize("blocks", list(SCORER_ROUTES))
def test_scorer_matches_jax(blocks):
    """The labeling scorer of a bfloat16 model on its float32 parameters
    against JAX's ``make_assignment_scorer`` on the raw tree: fused blocks
    (B1-bf16 on weights cast per call) and projected ones (B2 on bfloat16
    activations with float32 weights). Within BLOCK_RATIO of the bfloat16
    effect (the port's float32 scorer); the same model with its weights
    cast to bfloat16 (the serving route) fails."""
    fields = dict(TINY, cap_id=True)
    jm = model_from_config(JaxConfig(**fields, compute_dtype="bfloat16",
                                     **SCORER_ROUTES[blocks]), clip_config=JAX_CLIP)
    _, tree = port_model_for(fields, "float32")
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jenc, jscore = jlab.make_assignment_scorer(jm, jg.make_schedule(jg.linear_betas(1000)))
    rs = np.random.RandomState(3)
    cond = rs.randint(0, 43, (B, 2)).astype(np.int32)
    motion = rand(B, 2, T, FEATS, seed=4)
    rng, t = jax.random.key(11), 860
    enc_args = (params, jnp.asarray(cond), jnp.flip(jnp.asarray(cond), axis=1))
    xp, xo = jenc.lower(*enc_args).compile(compiler_options=EXACT_FAST)(*enc_args)
    score_args = (params, jnp.asarray(motion), jnp.asarray(LENGTHS), xp, xo, t, rng)
    want = jscore.lower(*score_args).compile(compiler_options=EXACT_FAST)(*score_args)
    noise = t_(np.asarray(jax.random.normal(rng, motion.shape, jnp.float32)))

    def port_scores(dtype, cast=False):
        model, _ = port_model_for(fields, dtype)
        model = InteractionModel(dataclasses.replace(model.cfg, fused_blocks=blocks == "fused"))
        load_flax_tree(model, tree["params"])
        if cast:
            cast_floating(model, BF16)
        encode, score = tl.make_assignment_scorer(model, tg.make_schedule(tg.linear_betas(1000)))
        c = t_(cond).long()
        xf_proj, xf_out = encode(c, c.flip(1))
        return score(t_(motion), t_(LENGTHS).long(), xf_proj, xf_out, t, noise=noise)

    got, got32 = port_scores("bfloat16"), port_scores("float32")
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    assert ratio(got, want, got32) <= BLOCK_RATIO
    assert ratio(port_scores("bfloat16", cast=True), want, got32) > BLOCK_RATIO


# --- the trainer and the CLIs -----------------------------------------------------------


def test_bf16_trainer_keeps_float32_state_and_tracks_float32(data_root, tmp_path):  # noqa: F811
    """Six bfloat16 steps on the CPU: parameters, Adam's moments, the EMA and
    the checkpoint stay float32, the losses are finite and track the float32
    run's within 5% (as ``tests/test_bf16.py`` asks of JAX), and both fall."""
    from hig_tpu_torch.train import checkpoint as ckpt

    losses = {}
    for dt in ("float32", "bfloat16"):
        cfg = trainer_cfg(data_root, tmp_path, name=f"run_{dt}", num_epochs=6,
                          limit_data_num=4, compute_dtype=dt, ema_decay=0.9)
        trainer = tt.Trainer(cfg, "cpu", PORT_CLIP)
        state = trainer.train(dataset_for(cfg), trainer.init_state(), log=lambda *_: None)
        assert {p.dtype for p in state.model.parameters()} == {torch.float32}
        assert {v.dtype for v in state.ema.values()} == {torch.float32}
        moments = [t for s in state.optimizer.state_dict()["state"].values()
                   for t in s.values() if torch.is_tensor(t) and t.is_floating_point()]
        assert moments and {t.dtype for t in moments} == {torch.float32}
        saved = ckpt.load(f"{cfg.model_dir}/latest.pt")["params"]
        assert {v.dtype for v in saved.values() if v.is_floating_point()} == {torch.float32}
        with open(f"{cfg.save_root}/metrics.jsonl") as f:
            losses[dt] = [json.loads(line)["loss_mot_rec"] for line in f]
    assert len(losses["bfloat16"]) == 6 and np.isfinite(losses["bfloat16"]).all()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=0.05)
    for run in losses.values():
        assert run[-1] < run[0]


CLI_OPTIONS = {"layernorm": [], "fast_ln": ["--fast_ln"], "rms_norm": ["--rms_norm"],
               "no_eff": ["--no_eff"],
               "supervised_cfg": ["--label_path", "{labels}", "--cond_drop_prob", "0.1"]}


@pytest.mark.parametrize("option", list(CLI_OPTIONS))
def test_train_and_label_clis_take_bf16(data_root, tmp_path, option):
    """``python -m hig_tpu_torch.train`` trains a bfloat16 caption-id run
    (float32 parameters): PIT with each block option, or the supervised
    stage with caption dropout; ``python -m hig_tpu_torch.label`` discovers
    roles from a PIT run: fused blocks by default, projected ones for
    rms_norm, whose --blocks fused is refused, the quadratic blocks for
    --no_eff."""
    from hig_tpu_torch.label import main as label_main
    from hig_tpu_torch.train.__main__ import main as train_main

    labels = tmp_path / "labels.json"
    with open(f"{data_root}/train_sub.txt") as f:
        labels.write_text(json.dumps({name: i % 2 for i, name in enumerate(f.read().split())}))
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", data_root,
            "--checkpoints_dir", ck, "--name", "run", "--cap_id", "--num_layers", "1",
            "--latent_dim", "32", "--ff_size", "64", "--num_heads", "4",
            "--text_latent_dim", "16", "--batch_size", "4", "--limit_data_num", "4",
            "--num_epochs", "1", "--log_every", "1", "--compute_dtype", "bfloat16",
            *[a.replace("{labels}", str(labels)) for a in CLI_OPTIONS[option]]]
    trainer, state = train_main(argv)
    assert trainer.model_config.dtype == BF16 and state.step == 1
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    if option == "supervised_cfg":
        assert "null_xf_proj" in dict(state.model.named_parameters())
        return
    opt = f"{trainer.cfg.save_root}/opt.txt"
    seen = {}
    real = tl.make_assignment_scorer

    def spy(model, sched):
        seen["fused"], seen["efficient"] = model.cfg.fused_blocks, model.cfg.efficient
        return real(model, sched)

    tl.make_assignment_scorer = spy
    try:
        label_main(["--opt_path", opt, "--device", "cpu", "--label_model", "--batch_size", "32"])
    finally:
        tl.make_assignment_scorer = real
    assert seen == {"fused": option in ("layernorm", "fast_ln"), "efficient": option != "no_eff"}
    with open(f"{trainer.cfg.save_root}/pit_labels.json") as f:
        assert len(json.load(f)) == 26
    if option == "rms_norm":
        with pytest.raises(SystemExit):
            label_main(["--opt_path", opt, "--device", "cpu", "--label_model",
                        "--blocks", "fused"])


def test_label_cli_refuses_fused_rms_norm_with_serves_message(tmp_path, capsys):
    """An rms_norm run's ``--blocks fused`` is refused with the message
    ``serve`` gives (``RMS_NORM_ROUTES``)."""
    from hig_tpu_torch.label import main as label_main
    from hig_tpu_torch.models.denoiser import RMS_NORM_ROUTES

    cfg = ExperimentConfig(**TINY, rms_norm=True, compute_dtype="bfloat16",
                           dataset_name="synthetic_mul", data_root=str(tmp_path))
    opt = str(tmp_path / "opt.txt")
    save_opt_txt(cfg, opt)
    with pytest.raises(SystemExit):
        label_main(["--opt_path", opt, "--device", "cpu", "--label_model", "--blocks", "fused"])
    assert RMS_NORM_ROUTES in capsys.readouterr().err
