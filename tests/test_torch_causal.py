"""Causal efficient attention (``--causal`` on the efficient model) in the
port against hig_tpu on the CPU.

- The core, ``causal_efficient_attention``, against JAX's in float32 within
  2e-5 of the reference's largest magnitude, with and without a key mask,
  and its gradients (the recomputing ``CausalCore``) against ``jax.vjp``.
- bfloat16: ``xla_cumsum`` is ``jnp.cumsum`` bit for bit (XLA:CPU rewrites
  the cumulative sum into blocks of 16), so the bfloat16 core is JAX's
  bfloat16 core compiled without excess precision (the reference
  ``tests/test_torch_bf16.py`` holds every bfloat16 route to) to within one
  bfloat16 ulp and 0.05 of the bfloat16 effect in rms; the core with
  torch's own cumulative sum (a float32 sum rounded once) is the control
  that must fail that gate.
- The causal self-attention and interaction blocks in eval mode (with
  ``fused``, which a causal block ignores) and in train mode, and the
  causal denoiser, in float32 within 2e-5: no kernel wrapper is reached.
- The denoiser cut to its first layer in bfloat16 within the bfloat16
  effect (``assert_bf16_parity``), beside the control that must fail it.
The whole causal PIT step is a case of
``tests/test_torch_train.py::test_whole_step_loss_and_grads_match_jax``
and the entry points a case of
``tests/test_torch_ablation_clis.py::test_train_label_serve_evaluate``.
Tiny widths, ``torch.set_num_threads(1)``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu import config as jcfg
from hig_tpu.models import attention as ja
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu_torch.config import ExperimentConfig, model_config
from hig_tpu_torch.models import attention as ta
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.weights import cast_floating, load_flax_tree, random_flax_tree
from tests.test_torch_bf16 import (
    BF16,
    EXACT_BF16,
    LENGTHS,
    ULP,
    assert_bf16_parity,
    denoiser_inputs,
    f32,
    jax_params,
    jax_run,
    jb,
    tb,
)
from tests.test_torch_pipeline import JAX_CLIP, PORT_CLIP, TINY, t_

ATOL = 2e-5
H, D = 4, 32
CORE_RMS = 0.05  # of the bfloat16 effect: the bfloat16 core against XLA's


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def core_inputs(T=91, width=64):
    q, k, v = (rand(2, 2, T, width, seed=s, scale=2.0) for s in (1, 2, 3))
    mask = (np.arange(T) < np.array([[T, T // 2], [T // 3, T - 5]])[..., None])
    return q, k, v, mask.astype(np.float32)


def relative_err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- the core ----------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_causal_core_and_grads_match_jax(masked):
    q, k, v, mask = core_inputs()
    m = mask if masked else None
    g = rand(*q.shape, seed=9)
    want, vjp = jax.vjp(
        lambda q, k, v: ja.causal_efficient_attention(
            q, k, v, H, None if m is None else jnp.asarray(m)), *map(jnp.asarray, (q, k, v)))
    leaves = [t_(a).requires_grad_() for a in (q, k, v)]
    got = ta.causal_efficient_attention(*leaves, H, None if m is None else t_(m))
    assert got.grad_fn is not None and "CausalCore" in type(got.grad_fn).__name__
    assert relative_err(got, want) <= ATOL
    got.backward(t_(g))
    for leaf, w in zip(leaves, vjp(jnp.asarray(g))):
        assert relative_err(leaf.grad, w) <= ATOL


def test_causal_core_is_causal():
    """Output i depends on keys and values j ≤ i only (up to rounding: the
    max over time that stabilizes exp sees every key)."""
    q, k, v, _ = core_inputs(T=20)
    base = ta.causal_efficient_attention(t_(q), t_(k), t_(v), H)
    k2, v2 = k.copy(), v.copy()
    k2[..., 12:, :] += 3.0
    v2[..., 12:, :] -= 1.0
    moved = ta.causal_efficient_attention(t_(q), t_(k2), t_(v2), H)
    assert relative_err(moved[..., :12, :], base[..., :12, :]) <= 1e-6
    assert relative_err(moved[..., 12:, :], base[..., 12:, :]) > 1e-2


@pytest.mark.parametrize("n", [7, 91, 300])
def test_xla_cumsum_is_jnp_cumsum_in_bf16(n):
    a = rand(3, n, 2, 5, seed=n) * np.random.RandomState(n).exponential(1, (3, n, 2, 5))
    want = f32(jax.jit(lambda x: jnp.cumsum(x, axis=1))(jb(a)))
    got = ta.xla_cumsum(tb(a), 1)
    assert got.dtype == BF16
    np.testing.assert_array_equal(f32(got), want)
    if n > 16:  # a float32 sum rounded once is another function
        assert not np.array_equal(f32(torch.cumsum(tb(a).float(), 1).to(BF16)), want)


def cumsum_rounded_once(x, dim):
    return torch.cumsum(x.float(), dim).to(x.dtype)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_bf16_core_is_xlas_beside_a_failing_control(masked, monkeypatch):
    q, k, v, mask = core_inputs()
    m = mask if masked else None
    args16 = (jb(q), jb(k), jb(v), None if m is None else jb(m))
    fn = jax.jit(lambda q, k, v, m: ja.causal_efficient_attention(q, k, v, H, m))
    want = f32(fn.lower(*args16).compile(compiler_options=EXACT_BF16)(*args16))
    want32 = f32(ja.causal_efficient_attention(*map(jnp.asarray, (q, k, v)), H,
                                               None if m is None else jnp.asarray(m)))
    effect = np.sqrt(np.mean((want - want32) ** 2))

    def run():
        out = ta.causal_efficient_attention(tb(q), tb(k), tb(v), H,
                                            None if m is None else tb(m))
        assert out.dtype == BF16
        return f32(out)

    d = run() - want
    assert np.abs(d).max() <= ULP * np.abs(want).max()
    assert np.sqrt(np.mean(d ** 2)) <= CORE_RMS * effect
    monkeypatch.setattr(ta, "xla_cumsum", cumsum_rounded_once)
    control = np.sqrt(np.mean((run() - want) ** 2))
    assert control > CORE_RMS * effect, (control, effect)


# --- blocks and denoiser -------------------------------------------------------------

CAUSAL = dataclasses.replace(model_config(ExperimentConfig(**TINY), PORT_CLIP), causal=True,
                             num_layers=2)
KERNEL_WRAPPERS = ("fused_attention_block", "fused_projected_attention",
                   "fused_efficient_attention")


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper the efficient blocks reach, made to raise."""
    def refuse(*args, **kw):
        raise AssertionError("a causal block reached a kernel wrapper")

    for name in KERNEL_WRAPPERS:
        monkeypatch.setattr(ta, name, refuse)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("block", ["sa_block", "int_ca_block"])
def test_causal_block_matches_flax(block, mode, no_kernels):
    tree = random_flax_tree(CAUSAL, seed=0)["params"]["denoiser"]["layer_0"][block]
    E, T = CAUSAL.time_embed_dim, 12
    x, emb = rand(2, 2, T, D, seed=4), rand(2, 2, E, seed=5)
    mask = (np.arange(T) < LENGTHS[:, None]).astype(np.float32)[:, None, :]
    cls, jcls = ((ta.EfficientSelfAttention, ja.EfficientSelfAttention) if block == "sa_block"
                 else (ta.EfficientInteractionAttention, ja.EfficientInteractionAttention))
    want = jcls(D, H, causal=True, fused=True, use_pallas=True).apply(
        {"params": tree}, *map(jnp.asarray, (x, emb, mask)))
    port = load_flax_tree(cls(D, H, E, fused=True, causal=True), tree)
    port.train(mode == "train")
    leaf = t_(x).requires_grad_(mode == "train")
    got = port(leaf, t_(emb), t_(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if mode == "train":
        got.sum().backward()
        assert torch.isfinite(leaf.grad).all()


def jax_denoise(model, params, bf16: bool, x, t, xf_proj, xf_out):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return jax_run(lambda p, *a: model.apply(p, *a, method=JaxModel.denoise), bf16,
                   jax_params(params, bf16), jnp.asarray(x), jnp.asarray(t),
                   jnp.asarray(LENGTHS), jnp.asarray(jb(xf_proj), dt),
                   jnp.asarray(jb(xf_out), dt))


def test_causal_denoiser_matches_jax(no_kernels):
    """Two causal layers, the port with fused blocks, JAX with
    ``fused_blocks`` and ``use_pallas`` (both ignored by a causal block)."""
    tree = random_flax_tree(CAUSAL, seed=0)
    jm = model_from_config(jcfg.ExperimentConfig(**{**TINY, "num_layers": 2}, causal=True,
                                                 fused_blocks=True, use_pallas=True),
                           clip_config=JAX_CLIP)
    x, t, xf_proj, xf_out, _, _, _ = denoiser_inputs(CAUSAL.time_embed_dim, D)
    want = jax_denoise(jm, jax.tree_util.tree_map(jnp.asarray, tree), False, x, t,
                       xf_proj, xf_out)
    port = load_flax_tree(InteractionModel(dataclasses.replace(CAUSAL, fused_blocks=True)),
                          tree["params"]).eval()
    with torch.no_grad():
        got = port.denoise(t_(x), t_(t), t_(LENGTHS), tb(xf_proj).float(), tb(xf_out).float())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bf16_first_layer_within_the_effect_beside_a_failing_control(monkeypatch):
    mcfg = dataclasses.replace(CAUSAL, num_layers=1)
    tree = random_flax_tree(mcfg, seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jms = [model_from_config(jcfg.ExperimentConfig(**TINY, causal=True, compute_dtype=dt),
                             clip_config=JAX_CLIP) for dt in ("bfloat16", "float32")]
    ports = [cast_floating(load_flax_tree(InteractionModel(dataclasses.replace(
        mcfg, compute_dtype=dt)), tree["params"]).eval(), ModelConfig(compute_dtype=dt).dtype)
        for dt in ("bfloat16", "float32")]
    x, t, xf_proj, xf_out, _, _, _ = denoiser_inputs(mcfg.time_embed_dim, D)
    want, want32 = (jax_denoise(jm, params, bf16, x, t, xf_proj, xf_out)
                    for jm, bf16 in zip(jms, (True, False)))

    def port_run(model, bf16):
        cast = tb if bf16 else (lambda a: tb(a).float())
        with torch.no_grad():
            return model.denoise(t_(x), t_(t), t_(LENGTHS), cast(xf_proj), cast(xf_out))

    assert_bf16_parity(port_run(ports[0], True), want, want32, port_run(ports[1], False))
    effect = np.sqrt(np.mean((f32(want) - f32(want32)) ** 2))
    got = np.sqrt(np.mean((f32(port_run(ports[0], True)) - f32(want)) ** 2))
    monkeypatch.setattr(ta, "xla_cumsum", cumsum_rounded_once)
    control = np.sqrt(np.mean((f32(port_run(ports[0], True)) - f32(want)) ** 2))
    assert got <= CORE_RMS * effect < control, (got, control, effect)


# --- configuration and serving ---------------------------------------------------


def test_config_takes_causal_efficient_and_keeps_jaxs_refusals():
    from hig_tpu_torch.models.denoiser import CAUSAL_SINGLE, RMS_NORM_ROUTES
    from hig_tpu_torch.models.interaction_model import SingleModelConfig

    assert ModelConfig(causal=True, fused_blocks=True).causal
    with pytest.raises(ValueError, match="single_transformer"):
        ModelConfig(causal=True, single_transformer=True)
    with pytest.raises(ValueError) as e:  # JAX's order: rms_norm first
        ModelConfig(causal=True, single_transformer=True, rms_norm=True, fused_blocks=True)
    assert str(e.value) == RMS_NORM_ROUTES and CAUSAL_SINGLE != RMS_NORM_ROUTES
    with pytest.raises(ValueError, match="causal"):
        SingleModelConfig(causal=True)


@pytest.mark.parametrize("blocks", ["fused", "projected"])
def test_serve_cli_takes_causal_on_the_efficient_model(tmp_path, blocks, capsys):
    from hig_tpu_torch import serve

    cfg = tmp_path / "m.json"
    cfg.write_text(json.dumps({k: v for k, v in TINY.items() if k != "diffusion_steps"}
                              | {"clip": {"width": 32, "heads": 2, "layers": 1}}))
    reqs = tmp_path / "r.jsonl"
    reqs.write_text(json.dumps({"caption1": "A person kicks.", "caption2": "A person falls.",
                                "length": 9, "id": "a"}) + "\n")
    serve.main(["--requests", str(reqs), "--random_init", "0", "--model_config", str(cfg),
                "--causal", "--blocks", blocks, "--ddim_steps", "2", "--device", "cpu",
                "--out_dir", str(tmp_path / "o")])
    said = capsys.readouterr().out
    assert '"causal": true' in said and '"efficient": true' in said
    assert np.isfinite(np.load(tmp_path / "o" / "a.npz")["joints"]).all()
