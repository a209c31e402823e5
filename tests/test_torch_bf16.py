"""bfloat16 parity of the PyTorch port (hig_tpu_torch) against hig_tpu on the
CPU: serving and evaluation in ``compute_dtype: bfloat16``, with ``fast_ln``
and ``rms_norm``.

- The norm factory against flax's ``make_layer_norm`` in bfloat16: LayerNorm
  with float32 statistics, LayerNorm under ``fast_ln``, RMSNorm, and RMSNorm
  under ``fast_ln``.
- The bfloat16 twins of B1 (self, interaction), B2 (self, partner; T = 12,
  91, 196), B3 (T = 91, 91 queries on 77 keys, T = 196) and B4 (self,
  partner, causal, and a key range past one 128-key block) against the
  Pallas kernels in interpret mode on bfloat16 inputs; B3-bf16's backward
  against JAX's ``_fused_bwd`` on bfloat16 operands.
- The text encoder, each block, the FFN and the whole denoiser in bfloat16
  against the flax modules with the matching route flags: the port's fused
  blocks (B1) against JAX ``fused_blocks=True``, its projected blocks (B2)
  and quadratic blocks (B4) against JAX ``use_pallas=True``; routes fused,
  projected, no_eff, rms_norm (projected) and fast_ln (fused).
- (``test_torch_bf16_samplers.py``) ``make_sampler`` DDIM, DPM-Solver++,
  DDPM and guided DDIM in bfloat16 against JAX's ``make_sampler``.
- The RMSNorm weight bridge, ``load_opt_txt`` on JAX ``opt.txt`` files with
  each option, the tiny ``serve`` CLI, and ``rms_norm`` with fused blocks
  refused. (bfloat16 training and labeling: ``test_torch_bf16_train.py``.)

Tolerance. XLA rounds a bfloat16 graph after every op; the port rounds at
the same ops. They differ only where a float32 sum taken in another order,
or a transcendental function, lands on the other side of a bfloat16
rounding boundary. Each comparison is held to rms(port − JAX) ≤ 0.5 ·
rms(JAX bfloat16 − JAX float32) on the same inputs and weights (a port that
skipped or added a rounding would sit near 1), and to a maximum error stated
in bfloat16 ulps (2⁻⁸) of JAX's largest output magnitude. Every test also
checks that the port's output is bfloat16 (the samplers' state is float32)
and differs from the port's float32 output.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu import config as jcfg
from hig_tpu.models import embeddings as je
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu.train import trainer as jt
from hig_tpu_torch import serve
from hig_tpu_torch.config import ExperimentConfig, load_opt_txt, model_config
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.models import embeddings as te
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.ops.fused_block import fused_attention_block, fused_attention_block_plain
from hig_tpu_torch.ops.pallas_attention import (
    efficient_attention,
    efficient_attention_backward,
    fused_efficient_attention,
    fused_efficient_attention_plain,
    fused_projected_attention,
    fused_projected_attention_plain,
)
from hig_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import (
    cast_floating,
    flatten,
    flax_param_shapes,
    load_flax_tree,
    random_flax_tree,
)
from tests.test_torch_pipeline import FEATS, JAX_CLIP, PORT_CLIP, TINY, rand, t_

BF16, ULP = torch.bfloat16, 2.0 ** -8
RMS_RATIO = 0.5
B, T = 2, 12
LENGTHS = np.array([12, 7], np.int32)
# port route → (port ModelConfig fields, JAX ExperimentConfig fields)
ROUTES = {
    "fused": (dict(fused_blocks=True), dict(fused_blocks=True, use_pallas=True)),
    "projected": (dict(), dict(use_pallas=True)),
    "no_eff": (dict(efficient=False), dict(no_eff=True, use_pallas=True)),
    "rms_norm": (dict(rms_norm=True), dict(rms_norm=True, use_pallas=True)),
    "fast_ln": (dict(fused_blocks=True, fast_ln=True),
                dict(fused_blocks=True, use_pallas=True, fast_ln=True)),
}


# XLA may compute a fused chain of bfloat16 ops in float32 and round once at
# its end (xla_allow_excess_precision, on by default under jit); JAX's op
# semantics, which the port follows, round after every op. Every bfloat16
# JAX reference is compiled with the option off, so that it rounds where its
# ops say: jitted with it on, the bfloat16 sampler sits as far from its own
# op-by-op result as bfloat16 sits from float32.
EXACT_BF16 = {"xla_allow_excess_precision": False}


def jax_run(fn, bf16: bool, *args):
    """``jax.jit(fn)(*args)``, compiled without excess precision for a
    bfloat16 reference."""
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile(compiler_options=EXACT_BF16 if bf16 else None)(*args)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def jb(a):
    return jnp.asarray(a, jnp.bfloat16)


def tb(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def assert_bf16_parity(port, want, want_f32, port_f32=None, ulps=2.0, bf16_out=True):
    """rms(port − want) ≤ RMS_RATIO · rms(want − want_f32), max |port − want|
    ≤ ``ulps`` bfloat16 ulps of max |want|; the port's output is bfloat16
    (``bf16_out``) and differs from its float32 output ``port_f32``."""
    if bf16_out:
        assert port.dtype == BF16, port.dtype
    got, ref, ref32 = f32(port), f32(want), f32(want_f32)
    assert np.isfinite(got).all()
    d = got - ref
    rms, rms_ref = np.sqrt(np.mean(d ** 2)), np.sqrt(np.mean((ref - ref32) ** 2))
    assert rms_ref > 0
    assert rms <= RMS_RATIO * rms_ref, (rms, rms_ref)
    scale = np.abs(ref).max()
    assert np.abs(d).max() <= ulps * ULP * scale, (np.abs(d).max(), ulps * ULP * scale)
    if port_f32 is not None:
        assert not np.array_equal(got, f32(port_f32))


# --- norms ---------------------------------------------------------------------------


@pytest.mark.parametrize("rms", [False, True], ids=["layernorm", "rmsnorm"])
@pytest.mark.parametrize("fast_ln", [False, True], ids=["f32_stats", "fast_ln"])
def test_norm_matches_flax(rms, fast_ln):
    """The norm factory against flax's ``make_layer_norm`` in bfloat16 (its
    float32 scale and bias); float32 inputs of an offset scale, so the fast
    variance E[x²] − E[x]² loses digits as in flax."""
    D = 64
    x = rand(6, 5, D, seed=1) * 2.0 + 0.5
    scale, bias = 1 + 0.1 * rand(D, seed=2), 0.1 * rand(D, seed=3)
    params = {"scale": scale} if rms else {"scale": scale, "bias": bias}
    jnorm = je.make_layer_norm(jnp.bfloat16, fast_ln, rms=rms)
    want = jnorm.apply({"params": params}, jb(x))
    want_f32 = je.make_layer_norm(jnp.float32, fast_ln, rms=rms).apply(
        {"params": params}, jnp.asarray(f32(jb(x))))
    port = te.make_norm(D, BF16, fast_ln, rms)
    port.weight.data = t_(scale)
    if not rms:
        port.bias.data = t_(bias)
    port32 = te.make_norm(D, torch.float32, fast_ln, rms)
    port32.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = port(tb(x))
        got32 = port32(tb(x).float())
    assert_bf16_parity(got, want, want_f32, got32, ulps=1.0)


# --- the kernels' bfloat16 twins against the Pallas kernels ------------------------------

KD, KH = 64, 4  # width and heads of the kernel cases (head dim 16)


def kernel_inputs(n_pairs=2, tq=T, seed=20):
    rng = np.random.RandomState(seed)
    w = {name: (rng.randn(KD, KD) / np.sqrt(KD)).astype(np.float32)
         for name in ("wq", "wk", "wv", "wo")}
    w.update({name: (0.1 * rng.randn(KD)).astype(np.float32)
              for name in ("bq", "bk", "bv", "bo", "ln_b", "styl_b")})
    w.update({name: (1 + 0.1 * rng.randn(KD)).astype(np.float32)
              for name in ("ln_g", "styl_g")})
    x = rng.randn(n_pairs, 2, tq, KD).astype(np.float32)
    lengths = np.array([tq, max(1, tq * 2 // 3)] * n_pairs)[:n_pairs]
    mask = np.broadcast_to((np.arange(tq) < lengths[:, None])[:, None, :],
                           (n_pairs, 2, tq)).astype(np.float32)
    scale, shift = 0.5 * rng.randn(n_pairs, 2, KD), 0.5 * rng.randn(n_pairs, 2, KD)
    return w, x, mask, scale.astype(np.float32), shift.astype(np.float32)


def block_weights(w, dtype):
    from hig_tpu_torch.ops.fused_block import BlockWeights

    def lin(k):  # flax (in, out) → torch (out, in)
        return torch.from_numpy(np.ascontiguousarray(w[k].T)).to(dtype)

    def vec(k):
        return t_(w[k]).to(dtype)

    return BlockWeights(vec("ln_g"), vec("ln_b"), lin("wq"), vec("bq"), lin("wk"), vec("bk"),
                        lin("wv"), vec("bv"), vec("styl_g"), vec("styl_b"), lin("wo"),
                        vec("bo"))


def _b1_twin_vs_pallas(interaction, tq=T):
    from hig_tpu.ops.fused_block import fused_attention_block as pallas_block

    w, x, mask, scale, shift = kernel_inputs(tq=tq)
    params = {"norm": {"scale": w["ln_g"], "bias": w["ln_b"]},
              "query": {"kernel": w["wq"], "bias": w["bq"]},
              "key": {"kernel": w["wk"], "bias": w["bk"]},
              "value": {"kernel": w["wv"], "bias": w["bv"]},
              "proj_out": {"norm": {"scale": w["styl_g"], "bias": w["styl_b"]},
                           "out": {"kernel": w["wo"], "bias": w["bo"]}}}

    def pallas(dtype):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(jb(a), dtype), params)
        jx, jm = jnp.asarray(jb(x), dtype), jnp.asarray(mask, dtype)
        kv, km = (jnp.flip(jx, 1), jnp.flip(jm, 1)) if interaction else (jx, jm)
        return pallas_block(jx, kv, km, jnp.asarray(jb(scale), dtype),
                            jnp.asarray(jb(shift), dtype), p, num_heads=KH, interpret=True)

    args = (tb(x), t_(mask), tb(scale)[..., None, :], tb(shift)[..., None, :],
            block_weights(w, BF16), KH, interaction)
    w32 = type(args[4])(*[t.float() for t in args[4]])  # the same rounded weights
    args32 = (tb(x).float(), t_(mask), args[2].float(), args[3].float(), w32, KH, interaction)
    before = fused_attention_block.launches_bf16
    got = fused_attention_block(*args)  # a CPU tensor takes the twin
    assert fused_attention_block.launches_bf16 == before
    assert_bf16_parity(got, pallas(jnp.bfloat16), pallas(jnp.float32),
                       fused_attention_block_plain(*args32))


@pytest.mark.parametrize("interaction", [False, True], ids=["self", "interaction"])
def test_b1_twin_matches_pallas(interaction):
    _b1_twin_vs_pallas(interaction)


@pytest.mark.parametrize("interaction", [False, True], ids=["self", "interaction"])
def test_b1_twin_matches_pallas_at_t196(interaction):
    """T = 196, the evaluation length: the bfloat16 kernel's 4 tiles of 64
    rows, the last holding 4 rows."""
    _b1_twin_vs_pallas(interaction, tq=196)


@pytest.mark.parametrize("tq", [T, 91, 196])
@pytest.mark.parametrize("same_source", [False, True], ids=["partner", "self"])
def test_b2_twin_matches_pallas(same_source, tq):
    """B2's twin, kv from the partner (flipped) or q_src itself, at T = 12
    and at the lengths where the bfloat16 kernel cuts its 64-row tiles
    otherwise: 91 (two tiles) and 196 (four, the last holding 4 rows)."""
    from hig_tpu.ops.pallas_attention import fused_projected_attention as pallas_proj

    w, x, mask, _, _ = kernel_inputs(tq=tq, seed=21)
    q_src = x
    kv_src, kmask = (x, mask) if same_source else (np.flip(x, 1).copy(),
                                                  np.flip(mask, 1).copy())

    def pallas(dtype):
        cast = lambda a: jnp.asarray(jb(a), dtype)  # noqa: E731
        return pallas_proj(cast(q_src), cast(kv_src), cast(w["wq"]), cast(w["bq"]),
                           cast(w["wk"]), cast(w["bk"]), cast(w["wv"]), cast(w["bv"]), KH,
                           key_mask=jnp.asarray(kmask, dtype), interpret=True)

    bw = block_weights(w, BF16)
    xb = tb(q_src)
    args = (xb, xb if same_source else tb(kv_src), bw.wq, bw.bq, bw.wk, bw.bk, bw.wv, bw.bv,
            KH, t_(kmask))
    args32 = tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)
    got = fused_projected_attention(*args)
    assert_bf16_parity(got, pallas(jnp.bfloat16), pallas(jnp.float32),
                       fused_projected_attention_plain(*args32))


def b3_inputs(tq, tk, seed=24):
    """q (2, 2, tq, KD), k and v (2, 2, tk, KD), the keys' mask."""
    _, _, mask, _, _ = kernel_inputs(tq=tk, seed=seed)
    rng = np.random.RandomState(seed + 1)
    q = rng.randn(2, 2, tq, KD).astype(np.float32)
    k, v = (rng.randn(2, 2, tk, KD).astype(np.float32) for _ in range(2))
    return q, k, v, mask


def jax_b3(q, k, v, mask, dtype):
    """JAX's fused_efficient_attention (the Pallas kernel in interpret mode)
    on the bfloat16-rounded inputs in ``dtype``, compiled as ``jax_run``."""
    from hig_tpu.ops.pallas_attention import fused_efficient_attention as pallas_core

    args = [jnp.asarray(jb(a), dtype) for a in (q, k, v, mask)]
    return jax_run(lambda q_, k_, v_, m_: pallas_core(q_, k_, v_, KH, key_mask=m_,
                                                      interpret=True),
                   dtype == jnp.bfloat16, *args)


@pytest.mark.parametrize("tq,tk", [(91, 91), (91, 77), (196, 196)],
                         ids=["self_t91", "tq91_tk77", "self_t196"])
def test_b3_twin_matches_pallas(tq, tk):
    """B3-bf16's twin rounds after each bfloat16 op of the Pallas kernel:
    the mask bias, each softmax's subtraction, exp, sum and division, the
    state, and y."""
    q, k, v, mask = b3_inputs(tq, tk)
    args = (tb(q), tb(k), tb(v), KH, t_(mask))
    args32 = tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)
    before = fused_efficient_attention.launches_bf16
    got = fused_efficient_attention(*args)  # a CPU tensor takes the twin
    assert fused_efficient_attention.launches_bf16 == before
    assert_bf16_parity(got, jax_b3(q, k, v, mask, jnp.bfloat16),
                       jax_b3(q, k, v, mask, jnp.float32), fused_efficient_attention_plain(*args32))


def test_b3_backward_matches_jax():
    """B3-bf16's backward against JAX's ``_fused_bwd`` on bfloat16 operands,
    91 queries on 77 keys. Both differentiate the plain core op by op in
    bfloat16 (the einsum reference's VJP as XLA takes it), so the port sits
    within 0.05 of the bfloat16 effect (JAX's bfloat16 VJP against its
    float32 one) from JAX's bfloat16 VJP; the float32 VJP rounded once (the
    backward before bfloat16 training) sits near the effect itself (> 0.5)."""
    from hig_tpu.ops.pallas_attention import fused_efficient_attention as pallas_core

    q, k, v, mask = b3_inputs(91, 77)
    g = np.random.RandomState(26).randn(2, 2, 91, KD).astype(np.float32)

    def jax_grads(dtype):
        def grads(q_, k_, v_, m_, g_):
            _, vjp = jax.vjp(lambda a, b, c: pallas_core(a, b, c, KH, key_mask=m_,
                                                         interpret=True), q_, k_, v_)
            return vjp(g_)

        return jax_run(grads, dtype == jnp.bfloat16,
                       *[jnp.asarray(jb(a), dtype) for a in (q, k, v, mask, g)])

    def rms(d):
        return np.sqrt(np.mean(d ** 2))

    got = efficient_attention_backward((tb(q), tb(k), tb(v), t_(mask)), tb(g), KH)
    leaves = [tb(a).float().requires_grad_() for a in (q, k, v)]
    once = torch.autograd.grad(efficient_attention(*leaves, KH, t_(mask)), leaves,
                               tb(g).float())
    for a, c, b, b32 in zip(got, once, jax_grads(jnp.bfloat16), jax_grads(jnp.float32)):
        assert a.dtype == BF16
        a, c, b, b32 = f32(a), f32(c.to(BF16)), f32(b), f32(b32)
        effect = rms(b - b32)
        assert effect > 0
        assert rms(a - b) <= 0.05 * effect, (rms(a - b), effect)
        assert rms(c - b) > 0.5 * effect, (rms(c - b), effect)


def _b4_twin_vs_pallas(tq, tk, causal, partner, seed=22):
    from hig_tpu.ops.flash_attention import flash_attention as pallas_flash

    _, _, mask, _, _ = kernel_inputs(tq=tk, seed=seed)  # the keys' mask
    rng = np.random.RandomState(seed + 1)
    q = rng.randn(2, 2, tq, KD).astype(np.float32)
    k, v = (rng.randn(2, 2, tk, KD).astype(np.float32) for _ in range(2))

    def pallas(dtype):
        jq, jk, jv, jm = (jnp.asarray(jb(a), dtype) for a in (q, k, v, mask))
        if partner:
            jk, jv, jm = jnp.flip(jk, 1), jnp.flip(jv, 1), jnp.flip(jm, 1)
        return pallas_flash(jq, jk, jv, KH, key_mask=jm, causal=causal, interpret=True)

    args = (tb(q), tb(k), tb(v), KH, t_(mask), causal, partner)
    args32 = tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)
    got = flash_attention(*args)
    assert_bf16_parity(got, pallas(jnp.bfloat16), pallas(jnp.float32),
                       flash_attention_plain(*args32))


@pytest.mark.parametrize("case", ["self", "partner", "causal", "two_blocks"])
def test_b4_twin_matches_pallas(case):
    """B4's twin walks the Pallas kernel's 128-key blocks: ``two_blocks``
    has 150 keys, two blocks with a rescale between them."""
    tq = 150 if case == "two_blocks" else T
    _b4_twin_vs_pallas(tq, tq, case == "causal", case == "partner")


@pytest.mark.parametrize("tq,tk,causal,partner", [(91, 77, False, False),
                                                  (196, 196, False, True),
                                                  (196, 196, True, False)],
                         ids=["tq91_tk77", "partner_t196", "causal_t196"])
def test_b4_twin_matches_pallas_on_ragged_blocks(tq, tk, causal, partner):
    """Shapes the bfloat16 kernel cuts otherwise: 91 queries over one
    80-key block of 77 keys, and T = 196 (4 query tiles of 64, the last
    holding 4 rows; a 128-key block then a ragged one of 68 keys)."""
    _b4_twin_vs_pallas(tq, tk, causal, partner)


# --- modules and the whole denoiser -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def route_models(route: str):
    """(JAX bf16 model on the route's kernels, JAX f32 model, f32 params,
    port bf16 model with its parameters cast, port f32 model) of one route,
    from one seeded tree."""
    port_kw, jax_kw = ROUTES[route]
    base = ExperimentConfig(**TINY, cond_drop_prob=0.1, label_path="labels.json")
    mcfg = dataclasses.replace(model_config(base, PORT_CLIP), **port_kw)
    tree = random_flax_tree(mcfg, seed=0)
    jkw = dict(TINY, cond_drop_prob=0.1, **jax_kw)
    # the float32 reference takes JAX's einsum route, which computes the same
    # function as the Pallas kernels in float32 and compiles faster
    f32_kw = dict(jkw, use_pallas=False, fused_blocks=False)
    jmodels = [model_from_config(jcfg.ExperimentConfig(**kw, compute_dtype=dt),
                                 clip_config=JAX_CLIP)
               for kw, dt in ((jkw, "bfloat16"), (f32_kw, "float32"))]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ports = []
    for dt in ("bfloat16", "float32"):
        model = load_flax_tree(InteractionModel(dataclasses.replace(mcfg, compute_dtype=dt)),
                               tree["params"]).eval()
        ports.append(cast_floating(model, ModelConfig(compute_dtype=dt).dtype))
    return (*jmodels, params, *ports)


def jax_params(params, bf16: bool):
    return jt.cast_floating(params, jnp.bfloat16) if bf16 else params


def cond_tokens():
    return tokenize(CAPS).astype(np.int32)[[[3, 4], [10, 11]]]


def test_text_encoder_matches_flax():
    """The CLIP tower and the suffix in bfloat16 (float32 LayerNorm
    statistics, QuickGELU and exact GELU op chains, −inf masks)."""
    jm16, jm32, params, port16, port32 = route_models("projected")
    tokens = cond_tokens()
    outs = [jax_run(lambda p, tok, m=m: m.apply(p, tok, method=JaxModel.encode_text), bf16,
                    jax_params(params, bf16), jnp.asarray(tokens))
            for m, bf16 in ((jm16, True), (jm32, False))]
    with torch.no_grad():
        got = port16.encode_text(t_(tokens).long())
        got32 = port32.encode_text(t_(tokens).long())
    for i in range(2):  # xf_proj, xf_out
        assert_bf16_parity(got[i], outs[0][i], outs[1][i], got32[i], ulps=2.0)


def denoiser_inputs(E, D):
    x = rand(B, 2, T, FEATS, seed=5)
    t = np.array([700, 31])
    xf_proj = rand(B, 2, E, seed=6)
    xf_out = rand(B, 2, 77, 16, seed=7)
    h = rand(B, 2, T, D, seed=8)
    emb = rand(B, 2, E, seed=9)
    mask = (np.arange(T) < LENGTHS[:, None]).astype(np.float32)[:, None, :]
    return x, t, xf_proj, xf_out, h, emb, mask


# block → (JAX submodule accessor, port accessor, routes)
BLOCKS = {
    "sa_fused": ("sa_block", "fused"), "sa_projected": ("sa_block", "projected"),
    "sa_rms_norm": ("sa_block", "rms_norm"), "sa_fast_ln": ("sa_block", "fast_ln"),
    "int_fused": ("int_ca_block", "fused"), "int_projected": ("int_ca_block", "projected"),
    "ca": ("ca_block", "projected"), "ca_rms_norm": ("ca_block", "rms_norm"),
    "ffn": ("ffn", "projected"), "ffn_fast_ln": ("ffn", "fast_ln"),
    "sa_no_eff": ("sa_block", "no_eff"), "ca_no_eff": ("ca_block", "no_eff"),
    "int_no_eff": ("int_ca_block", "no_eff"),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_flax(block):
    """One block of layer 0 in bfloat16 on bfloat16 activations."""
    name, route = BLOCKS[block]
    jm16, jm32, params, port16, port32 = route_models(route)
    E, D = port16.cfg.time_embed_dim, port16.cfg.latent_dim
    _, _, _, xf_out, h, emb, mask = denoiser_inputs(E, D)

    def jax_block(model, bf16):
        dt = jnp.bfloat16 if bf16 else jnp.float32
        args = [jnp.asarray(jb(h), dt), jnp.asarray(jb(emb), dt)]
        if name == "ca_block":
            args.insert(1, jnp.asarray(jb(xf_out), dt))
        elif name != "ffn":
            args.append(jnp.asarray(mask, dt))

        def call(m, *a):
            return getattr(m.denoiser.layers[0], name)(*a)

        return jax_run(lambda p, *a: model.apply(p, *a, method=call), bf16,
                       jax_params(params, bf16), *args)

    def port_run(model, bf16):
        cast = tb if bf16 else (lambda a: tb(a).float())
        args = [cast(h), cast(emb)]
        if name == "ca_block":
            args.insert(1, cast(xf_out))
        elif name != "ffn":
            args.append(cast(mask))
        with torch.no_grad():
            return getattr(model.denoiser.layers[0], name)(*args)

    assert_bf16_parity(port_run(port16, True), jax_block(jm16, True), jax_block(jm32, False),
                       port_run(port32, False), ulps=2.0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_denoiser_matches_flax(route):
    """The whole denoiser (1 layer, all four blocks, the embeddings and the
    heads) in bfloat16 from float32 x and bfloat16 conditioning."""
    jm16, jm32, params, port16, port32 = route_models(route)
    E, D = port16.cfg.time_embed_dim, port16.cfg.latent_dim
    x, t, xf_proj, xf_out, _, _, _ = denoiser_inputs(E, D)

    def jax_den(model, bf16):
        dt = jnp.bfloat16 if bf16 else jnp.float32
        return jax_run(lambda p, *a: model.apply(p, *a, method=JaxModel.denoise), bf16,
                       jax_params(params, bf16), jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(LENGTHS), jnp.asarray(jb(xf_proj), dt),
                       jnp.asarray(jb(xf_out), dt))

    def port_run(model, bf16):
        cast = tb if bf16 else (lambda a: tb(a).float())
        with torch.no_grad():
            return model.denoise(t_(x), t_(t), t_(LENGTHS), cast(xf_proj), cast(xf_out))

    assert_bf16_parity(port_run(port16, True), jax_den(jm16, True), jax_den(jm32, False),
                       port_run(port32, False), ulps=2.0)


# --- config, weights and entry points ------------------------------------------------------


def test_rms_norm_weight_bridge():
    """An rms_norm model's JAX tree (RMSNorm leaves: scale, no bias) is the
    port's ``flax_param_shapes`` and loads into its modules."""
    jm16, _, params, port16, _ = route_models("rms_norm")
    tokens = jnp.asarray(cond_tokens())
    x = jnp.zeros((B, 2, T, FEATS))
    init = jax.eval_shape(lambda: jm16.init(jax.random.key(0), x, jnp.array([1, 2]),
                                            jnp.asarray(LENGTHS), tokens))
    want = {k: tuple(v.shape) for k, v in flatten(init["params"]).items()}
    got = {k: tuple(v) for k, v in flatten(flax_param_shapes(port16.cfg)["params"]).items()}
    assert got == want
    norm = port16.denoiser.layers[0].sa_block.norm
    assert isinstance(norm, te.Norm) and norm.rms and norm.bias is None
    assert isinstance(port16.denoiser.layers[0].ca_block.text_norm, te.Norm)
    assert port16.denoiser.layers[0].ca_block.text_norm.bias is not None


@pytest.mark.parametrize("key,value", [("compute_dtype", "bfloat16"), ("fast_ln", True),
                                       ("rms_norm", True)])
def test_load_opt_txt_reads_the_bf16_options(tmp_path, key, value):
    path = str(tmp_path / "opt.txt")
    jcfg.save_opt_txt(jcfg.ExperimentConfig(**TINY, **{key: value}), path)
    cfg = load_opt_txt(path)
    assert getattr(cfg, key) == value
    mcfg = model_config(cfg, PORT_CLIP)
    assert getattr(mcfg, key) == value
    assert mcfg.dtype == (BF16 if key == "compute_dtype" else torch.float32)


def test_rms_norm_refuses_fused_blocks_and_no_eff():
    from hig_tpu_torch.models.denoiser import RMS_NORM_ROUTES

    for kw in (dict(fused_blocks=True), dict(efficient=False)):
        with pytest.raises(ValueError, match="--rms_norm requires the efficient"):
            ModelConfig(rms_norm=True, **kw)
    assert "--fused_blocks" in RMS_NORM_ROUTES


def _tiny_model_config(tmp_path, **fields):
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        json.dump({"latent_dim": 64, "ff_size": 64, "num_layers": 1, "num_heads": 1,
                   "text_latent_dim": 16, "cap_id": True, **fields}, f)
    return path


@pytest.mark.parametrize("extra", [[], ["--blocks", "projected"], ["--no_eff"]],
                         ids=["fused", "projected", "no_eff"])
def test_serve_cli_bf16(tmp_path, extra, monkeypatch):
    """The tiny serve CLI from a bfloat16 --model_config: its wrappers see
    bfloat16 tensors (the plain twins on the CPU) and the outputs are finite."""
    reqs = tmp_path / "r.jsonl"
    reqs.write_text(json.dumps({"caption1": CAPS[0], "caption2": CAPS[1], "length": 5}) + "\n")
    calls = []
    real = serve.make_sampler

    def spy(model, *args, **kwargs):
        calls.append(model.cfg.dtype)
        out = real(model, *args, **kwargs)
        assert all(p.dtype == BF16 for p in model.parameters())
        return out

    out_dir = tmp_path / "out"
    monkeypatch.setattr(serve, "make_sampler", spy)
    serve.main(["--requests", str(reqs), "--random_init", "0", "--device", "cpu",
                "--out_dir", str(out_dir), "--ddim_steps", "2", "--model_config",
                _tiny_model_config(tmp_path, compute_dtype="bfloat16"), *extra])
    assert calls == [BF16]
    served = np.load(out_dir / "req0.npz")
    assert served["joints"].shape == (2, 5, 22, 3) and np.isfinite(served["joints"]).all()


def test_serve_cli_rms_norm_opt_txt(tmp_path):
    """A JAX opt.txt with rms_norm and bfloat16 serves (its default blocks are
    the projected ones); --blocks fused is refused with JAX's message."""
    opt = str(tmp_path / "opt.txt")
    jcfg.save_opt_txt(jcfg.ExperimentConfig(latent_dim=64, ff_size=64, num_layers=1,
                                            num_heads=1, text_latent_dim=16, cap_id=True,
                                            rms_norm=True, compute_dtype="bfloat16",
                                            sampler="ddim", ddim_steps=2), opt)
    reqs = tmp_path / "r.jsonl"
    reqs.write_text(json.dumps({"caption1": CAPS[0], "caption2": CAPS[1], "length": 4}) + "\n")
    stats = tmp_path / "meta"
    stats.mkdir()
    np.save(stats / "mean.npy", np.zeros(FEATS + 4, np.float32))
    np.save(stats / "std.npy", np.ones(FEATS + 4, np.float32))
    common = ["--requests", str(reqs), "--random_init", "0", "--device", "cpu",
              "--out_dir", str(tmp_path / "out"), "--opt_path", opt, "--stats", str(stats)]
    serve.main(common)
    assert np.isfinite(np.load(tmp_path / "out" / "req0.npz")["features"]).all()
    with pytest.raises(SystemExit):
        serve.main(common + ["--blocks", "fused"])
