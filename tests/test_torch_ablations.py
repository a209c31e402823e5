"""Parity of the paper's ablation models in the PyTorch port against hig_tpu
on the CPU: ``--no_cross_attn`` (no interaction block) and
``--single_transformer`` (both actors on one 2T-token timeline), efficient
and ``--no_eff``.

- The parameter trees: the port's shapes and seeded tree against JAX's
  ``init`` structure, loaded with no leaf left over on either side.
- The denoiser forward against JAX (its einsum route; the port's fused
  blocks against JAX ``fused_blocks=True``, the Pallas block in interpret
  mode), directly and with the text KᵀV and the AdaLN grid hoisted: 2e-5.
- The AdaLN grid against JAX's ``adaln_scale_shift_grid`` (the actors' mean
  under ``single_transformer``, no "int" entry in either variant): 2e-5.
- DDIM through ``make_sampler`` from JAX's own x_T: 1e-5 of the output's
  largest magnitude.
- One PIT and one supervised step's loss and every gradient against
  ``jax.value_and_grad`` of JAX's ``make_loss_fn``, JAX's t and noise handed
  to the port: the tolerances of ``tests/test_torch_train.py``.
- The configuration: both options accepted and carried into ``ModelConfig``
  and the tree, from the CLI and from a JAX ``opt.txt``; JAX's refusals of
  ``causal`` with ``single_transformer`` and of ``rms_norm`` with
  ``fused_blocks`` kept.

Tiny widths (2 layers, latent 32) and ``torch.set_num_threads(1)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.config import save_opt_txt as jax_save_opt_txt
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, load_opt_txt, model_config
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models.denoiser import CAUSAL_SINGLE, RMS_NORM_ROUTES
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import (
    flatten,
    flax_param_shapes,
    load_flax_tree,
    random_flax_tree,
    torch_state_from_flax,
)
from tests.test_torch_train import (
    JAX_CLIP,
    LENGTHS,
    LOSS_RTOL,
    PORT_CLIP,
    TINY,
    B,
    FEATS,
    T,
    assert_grads_close,
    rand,
    step_batch,
    t_,
)

# variant → the training options that make it
VARIANTS = {
    "no_cross_attn": dict(no_cross_attn=True),
    "no_cross_attn_no_eff": dict(no_cross_attn=True, no_eff=True),
    "single_transformer": dict(single_transformer=True),
    "single_transformer_no_eff": dict(single_transformer=True, no_eff=True),
}
TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(variant, **kw):
    """(JAX config, port config) of ``variant`` at the tiny widths."""
    opts = {**VARIANTS[variant], **kw}
    return JaxConfig(**TINY, **opts), ExperimentConfig(**TINY, **opts)


def models(variant, fused=False):
    """(JAX model, its params, the port's model in eval mode) with the same
    seeded weights; ``fused``: both with fused blocks."""
    jcfg, cfg = configs(variant)
    jcfg.fused_blocks = fused
    mcfg = dataclasses.replace(model_config(cfg, PORT_CLIP), fused_blocks=fused)
    tree = random_flax_tree(mcfg, seed=0)
    port = load_flax_tree(InteractionModel(mcfg), tree["params"]).eval()
    return (model_from_config(jcfg, clip_config=JAX_CLIP),
            jax.tree_util.tree_map(jnp.asarray, tree), port)


def denoiser_inputs(E):
    x = rand(B, 2, T, FEATS, seed=4)
    t = np.array([17, 17, 530, 998])
    xf_proj = rand(B, 2, E, seed=5)
    xf_out = rand(B, 2, 9, TINY["text_latent_dim"], seed=6)
    return x, t, LENGTHS, xf_proj, xf_out


# --- configuration and parameter trees ---------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tree_matches_the_jax_init(variant):
    """The port's tree of the variant has JAX's init structure, and loads
    with no leaf left over or parameter unset."""
    jmodel, _, port = models(variant)
    args = (jnp.zeros((1, 2, T, FEATS)), jnp.zeros((1,), jnp.int32), jnp.full((1,), T),
            jnp.zeros((1, 2, 77), jnp.int32))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree_util.tree_map(
        lambda a: a, dict(shapes), is_leaf=lambda a: hasattr(a, "shape"))).items()}
    got = {k: tuple(v) for k, v in flatten(flax_param_shapes(port.cfg)).items()}
    assert got == want
    layer = {k[3] for k in want if k[2] == "layer_0"}
    assert layer == {"sa_block", "ca_block", "ffn"}
    assert not any(".int_ca_block." in name for name in port.state_dict())


@pytest.mark.parametrize("option", ["no_cross_attn", "single_transformer"])
def test_config_accepts_the_ablation(option, tmp_path):
    """The option is accepted, reaches ModelConfig and the tree, from the
    config and from a JAX run's opt.txt."""
    cfg = ExperimentConfig(**TINY, **{option: True})
    path = str(tmp_path / "opt.txt")
    jax_save_opt_txt(JaxConfig(**TINY, **{option: True}), path)
    for c in (cfg, load_opt_txt(path)):
        mcfg = model_config(c, PORT_CLIP)
        assert (mcfg.interaction, mcfg.single_transformer) == \
            ((False, False) if option == "no_cross_attn" else (True, True))
        assert "int_ca_block" not in flax_param_shapes(mcfg)["params"]["denoiser"]["layer_0"]


def test_causal_single_transformer_refused():
    """JAX's refusal (hig_tpu/models/denoiser.py:162-172), with its message."""
    cfg = ExperimentConfig(**TINY, no_eff=True, causal=True, single_transformer=True)
    with pytest.raises(ValueError, match="merged 2T") as e:
        model_config(cfg, PORT_CLIP)
    assert str(e.value) == CAUSAL_SINGLE
    with pytest.raises(ValueError, match="merged 2T"):
        model_from_config(JaxConfig(**TINY, no_eff=True, causal=True, single_transformer=True),
                          clip_config=JAX_CLIP).init(
            jax.random.key(0), jnp.zeros((1, 2, T, FEATS)), jnp.zeros((1,), jnp.int32),
            jnp.full((1,), T), jnp.zeros((1, 2, 77), jnp.int32))


def test_rms_norm_fused_blocks_refused_under_single_transformer():
    """JAX's setup refuses rms_norm with fused_blocks before it looks at
    single_transformer, whose layers would not fuse."""
    with pytest.raises(ValueError) as e:
        ModelConfig(rms_norm=True, fused_blocks=True, single_transformer=True)
    assert str(e.value) == RMS_NORM_ROUTES
    assert ModelConfig(rms_norm=True, single_transformer=True).single_transformer


# --- forward -----------------------------------------------------------------------------


ROUTES = [(v, False) for v in VARIANTS] + [("no_cross_attn", True), ("single_transformer", True)]


@pytest.mark.parametrize("variant,fused", ROUTES,
                         ids=[f"{v}-{'fused' if f else 'plain'}" for v, f in ROUTES])
def test_denoiser_matches_jax(variant, fused):
    """The denoiser directly and with the text KᵀV and the AdaLN grid
    hoisted, against JAX's (fused: both with fused_blocks; a
    single_transformer model fuses nothing in either). Tolerance 2e-5."""
    jmodel, params, port = models(variant, fused)
    x, t, lengths, xf_proj, xf_out = denoiser_inputs(port.cfg.time_embed_dim)
    want = jmodel.apply(params, *map(jnp.asarray, (x, t, lengths, xf_proj, xf_out)),
                        method=JaxModel.denoise)
    with torch.no_grad():
        direct = port.denoise(t_(x), t_(t), t_(lengths), t_(xf_proj), t_(xf_out))
        kv = port.text_kv(t_(xf_out))
        grids = [tt.adaln_scale_shift_grid(port, np.array([s]), t_(xf_proj[i:i + 1]))
                 for i, s in enumerate(t)]
        adaln = [{k: (torch.cat([g[j][k][0][0] for g in grids]),
                      torch.cat([g[j][k][1][0] for g in grids])) for k in grids[0][j]}
                 for j in range(len(grids[0]))]
        hoisted = port.denoise(t_(x), t_(t), t_(lengths), t_(xf_proj), text_kv=kv, adaln=adaln)
    np.testing.assert_allclose(direct.numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(hoisted.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("variant", ["no_cross_attn", "single_transformer"])
def test_adaln_grid_matches_jax(variant):
    jmodel, params, port = models(variant)
    ts = jg.ddim_timesteps(100, 5)
    xf_proj = rand(B, 2, port.cfg.time_embed_dim, seed=7)
    want = jt.adaln_scale_shift_grid(jmodel, params, ts, jnp.asarray(xf_proj))
    with torch.no_grad():
        got = tt.adaln_scale_shift_grid(port, ts, t_(xf_proj))
    lead = (len(ts), B, 1) if variant == "single_transformer" else (len(ts), B, 2, 1)
    for g_layer, w_layer in zip(got, want, strict=True):
        assert g_layer.keys() == w_layer.keys() == {"sa", "ca", "ffn"}
        for k in g_layer:
            for a, b in zip(g_layer[k], w_layer[k], strict=True):
                assert tuple(a.shape[:-1]) == lead
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)


@pytest.mark.parametrize("variant", ["no_cross_attn", "single_transformer",
                                     "single_transformer_no_eff"])
def test_ddim_sampler_matches_jax(variant):
    """DDIM-5 through make_sampler in both packages from JAX's own x_T.
    Tolerance: 1e-5 of the output's largest magnitude (each step scales the
    denoiser's rounding by |c2|)."""
    jmodel, params, port = models(variant)
    cond = step_batch(2, no_clip=True)["tokens"]
    lengths = np.array([16, 9])
    rng = jax.random.key(11)
    want = np.asarray(jt.make_sampler(jmodel, jg.make_schedule(jg.linear_betas(100)), T=T,
                                      dim_pose=FEATS, sampler="ddim", ddim_steps=5)(
        params, jnp.asarray(cond), jnp.asarray(lengths), rng))
    _, init_rng = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(init_rng, (2, 2, T, FEATS), jnp.float32))
    sample = tt.make_sampler(port, tg.make_schedule(tg.linear_betas(100)), T=T,
                             dim_pose=FEATS, ddim_steps=5)
    got = sample(t_(cond), t_(lengths), noise=t_(noise)).numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


# --- training -------------------------------------------------------------------------------

STEP_CASES = {
    "no_cross_attn-pit": ("no_cross_attn", True),
    "no_cross_attn-supervised": ("no_cross_attn", False),
    "single_transformer-pit": ("single_transformer", True),
    "single_transformer-supervised": ("single_transformer", False),
    "single_transformer_no_eff-pit": ("single_transformer_no_eff", True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_whole_step_loss_and_grads_match_jax(case):
    """One step's loss and every gradient against jax.value_and_grad of
    JAX's make_loss_fn (its einsum route), JAX's t and noise drawn from its
    key and handed to the port; the tower features precomputed, as the
    trainer does. Loss within 1e-5 relative, each leaf within 1e-4 of its
    largest magnitude (the key biases: noise below 1e-6 of the largest)."""
    variant, pit = STEP_CASES[case]
    jcfg, cfg = configs(variant)
    jmodel = model_from_config(jcfg, clip_config=JAX_CLIP)
    loss_fn = jt.make_loss_fn(jmodel, jg.make_schedule(jg.linear_betas(100)), pit)
    mcfg = model_config(cfg, PORT_CLIP)
    tree = random_flax_tree(mcfg, seed=0)
    batch = step_batch(B, no_clip=False)
    rng = jax.random.key(7)
    (want_loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    t_rng, n_rng = jax.random.split(rng)
    t = np.asarray(jax.random.randint(t_rng, (B,), 0, 100))
    noise = np.asarray(jax.random.normal(n_rng, (B, 2, T, FEATS), jnp.float32))

    model = load_flax_tree(InteractionModel(mcfg), tree["params"]).train()
    tt.make_optimizer(cfg, model)
    tbatch = {k: t_(v).long() if v.dtype == np.int32 else t_(v) for k, v in batch.items()}
    port_loss = tt.make_loss_fn(model, tg.make_schedule(tg.linear_betas(100)), pit)
    loss, _ = tt.compute_grads(model, port_loss, tbatch, t=t_(t).long(), noise=t_(noise))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}
    assert_grads_close(got, want)
