"""Parity of the PyTorch port's quadratic (``--no_eff``) path and of the plain
versions of kernels B3 and B4 against hig_tpu on the CPU: B4's plain version
against the Pallas flash-attention kernel and B3's against the Pallas
efficient-attention kernel (both in interpret mode), the quadratic blocks,
the ``efficient=False`` denoiser and DDIM sampler, the ``--no_eff`` weight
tree, the config refusals and the serving CLI.

Weights come from ``random_flax_tree`` (every leaf nonzero); inputs from
numpy, the same arrays for both packages. Masks differ between the two
actors of a pair, and ``norm`` and ``text_norm`` have different random
weights, so the tests pin the reference's quirks: the interaction block
normalizes the partner with its own ``text_norm``, and its key mask is the
partner's. Tolerance: 2e-5 absolute per block in float32; 1e-5 of the
output scale for the whole sampler.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.models import attention as ja
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.text_encoder import ClipTextConfig as JaxClip
from hig_tpu_torch.models import attention as ta
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.weights import flatten, load_flax_tree, random_flax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
TINY_FIELDS = dict(
    num_frames=16, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
    text_latent_dim=16, text_ff_size=32, text_num_heads=2, num_text_layers=1,
)
QUAD = ModelConfig(**TINY_FIELDS, clip=ClipTextConfig(width=32, heads=2, layers=1),
                   efficient=False)
D, H, E, B, T, F = QUAD.latent_dim, QUAD.num_heads, QUAD.time_embed_dim, 2, 12, 263
LENGTHS = np.array([12, 7])
ACTOR_LENGTHS = np.array([[12, 5], [7, 10]])  # (B, 2): the two actors differ
CAPTIONS = [("A person is hugging the other person.", "A person is kicked."),
            ("Two people shake hands.", "A person is pushed by the other person.")]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree():
    return random_flax_tree(QUAD, seed=0)


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def actor_mask(T_=T):
    """(B, 2, T) 0/1 mask with different lengths for the two actors."""
    return (np.arange(T_) < ACTOR_LENGTHS[..., None]).astype(np.float32)


def jax_model(**kw):
    return JaxModel(**TINY_FIELDS, clip_config=JaxClip(width=32, heads=2, layers=1),
                    efficient=False, **kw)


def port_model(cfg=QUAD):
    return load_flax_tree(InteractionModel(cfg), random_flax_tree(cfg, seed=0)).eval()


# --- plain kernel versions against the Pallas kernels (interpret mode) ------


@pytest.mark.parametrize("case", ["unmasked", "masked", "causal", "partner", "tq_ne_tk"])
def test_plain_flash_attention_matches_pallas(case):
    """Plain B4 (and the wrapper on CPU tensors, which takes it without a
    launch) against the Pallas flash kernel in interpret mode."""
    from hig_tpu.ops.flash_attention import flash_attention as pallas_flash
    from hig_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    Tk = 9 if case == "tq_ne_tk" else T
    q, k, v = rand(B, 2, T, D, seed=1), rand(B, 2, Tk, D, seed=2), rand(B, 2, Tk, D, seed=3)
    mask = None if case == "unmasked" else actor_mask(Tk)
    causal, partner = case == "causal", case == "partner"
    jk, jv, jm = jnp.asarray(k), jnp.asarray(v), None if mask is None else jnp.asarray(mask)
    if partner:  # the Pallas kernel has no partner flag: flip on the actor axis
        jk, jv, jm = jnp.flip(jk, 1), jnp.flip(jv, 1), jnp.flip(jm, 1)
    want = pallas_flash(jnp.asarray(q), jk, jv, H, key_mask=jm, causal=causal,
                        interpret=True)
    args = (t_(q), t_(k), t_(v), H, None if mask is None else t_(mask), causal, partner)
    close(flash_attention_plain(*args), want)
    before = flash_attention.launches
    close(flash_attention(*args), want)
    assert flash_attention.launches == before


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_plain_efficient_attention_matches_pallas(masked):
    """Plain B3 (and the port's ``_attend``, which routes to B3's wrapper)
    against the Pallas efficient-attention kernel in interpret mode, with
    Tq != Tk."""
    from hig_tpu.ops.pallas_attention import fused_efficient_attention as pallas_core
    from hig_tpu_torch.ops.pallas_attention import (
        efficient_attention,
        fused_efficient_attention,
    )

    Tk = 9
    q, k, v = rand(B, 2, T, D, seed=4), rand(B, 2, Tk, D, seed=5), rand(B, 2, Tk, D, seed=6)
    mask = actor_mask(Tk) if masked else None
    want = pallas_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                       key_mask=None if mask is None else jnp.asarray(mask), interpret=True)
    args = (t_(q), t_(k), t_(v), H, None if mask is None else t_(mask))
    close(efficient_attention(*args), want)
    before = fused_efficient_attention.launches
    close(ta._attend(*args), want)
    assert fused_efficient_attention.launches == before


# --- quadratic blocks -----------------------------------------------------------


def _block(tree, name, causal, jax_pallas):
    sub = tree["params"]["denoiser"]["layer_0"][name]
    cls = {"sa_block": (ta.QuadraticSelfAttention, ja.QuadraticSelfAttention),
           "int_ca_block": (ta.QuadraticInteractionAttention,
                            ja.QuadraticInteractionAttention)}[name]
    port = load_flax_tree(cls[0](D, H, E, causal=causal), sub)
    return port, cls[1](D, H, causal=causal, use_pallas=jax_pallas), sub


@pytest.mark.parametrize("jax_pallas", [False, True], ids=["jax_einsum", "jax_pallas"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", ["sa_block", "int_ca_block"])
def test_quadratic_blocks_match_flax(tree, name, causal, jax_pallas):
    """Self-attention and interaction (plain B4 on the CPU) against the flax
    blocks with the einsum path (the interaction bias there is −1e5) and
    with the Pallas flash kernel (−1e6), with emb and with hoisted AdaLN."""
    port, jblock, sub = _block(tree, name, causal, jax_pallas)
    x, emb, mask = rand(B, 2, T, D, seed=7), rand(B, 2, E, seed=8), actor_mask()
    want = jblock.apply({"params": sub}, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(mask))
    with torch.no_grad():
        close(port(t_(x), t_(emb), t_(mask)), want)
        close(port(t_(x), None, t_(mask), adaln=port.proj_out.scale_shift(t_(emb))), want)


def test_interaction_quirks_are_pinned(tree):
    """The inputs above tell the quirks apart: sharing ``norm`` for the
    partner, or taking the actor's own key mask, changes the output."""
    port, jblock, sub = _block(tree, "int_ca_block", False, False)
    x, emb, mask = rand(B, 2, T, D, seed=7), rand(B, 2, E, seed=8), actor_mask()
    want = np.asarray(jblock.apply({"params": sub}, jnp.asarray(x), jnp.asarray(emb),
                                   jnp.asarray(mask)))
    with torch.no_grad():
        own_mask = port(t_(x), t_(emb), t_(mask[:, ::-1].copy()))
        port.text_norm.load_state_dict(port.norm.state_dict())
        shared_norm = port(t_(x), t_(emb), t_(mask))
    assert np.abs(own_mask.numpy() - want).max() > 1e-3
    assert np.abs(shared_norm.numpy() - want).max() > 1e-3


def test_quadratic_cross_attention_kv_and_from_kv(tree):
    sub = tree["params"]["denoiser"]["layer_1"]["ca_block"]
    x, xf, emb = rand(B, 2, T, D, seed=9), rand(B, 2, 9, 16, seed=10), rand(B, 2, E, seed=11)
    jblock = ja.QuadraticCrossAttention(D, 16, H)
    port = load_flax_tree(ta.QuadraticCrossAttention(D, 16, H, E), sub)
    want = jblock.apply({"params": sub}, jnp.asarray(x), jnp.asarray(xf), jnp.asarray(emb))
    jk, jv = jblock.apply({"params": sub}, jnp.asarray(xf),
                          method=ja.QuadraticCrossAttention.kv)
    with torch.no_grad():
        close(port(t_(x), t_(xf), t_(emb)), want)
        k, v = port.kv(t_(xf))
        close(k, jk)
        close(v, jv)
        close(port.from_kv(t_(x), (k, v), None, adaln=port.proj_out.scale_shift(t_(emb))),
              want)


# --- denoiser and sampler --------------------------------------------------------


@pytest.mark.parametrize("jax_pallas", [False, True], ids=["jax_einsum", "jax_pallas"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_quadratic_denoiser_matches_jax(tree, causal, jax_pallas):
    """The efficient=False denoiser, directly and with the text (k, v) and
    AdaLN hoisted, against JAX's with and without the Pallas flash kernel."""
    from hig_tpu.models.denoiser import InteractionDenoiser
    from hig_tpu_torch.train.trainer import adaln_scale_shift_grid

    x, t = rand(B, 2, T, F, seed=12), np.array([17, 17])
    xf_proj, xf_out = rand(B, 2, E, seed=13), rand(B, 2, 9, 16, seed=14)
    jden = InteractionDenoiser(**{k: v for k, v in TINY_FIELDS.items()
                                  if not k.startswith(("text_ff", "text_num", "num_text"))},
                               efficient=False, causal=causal, use_pallas=jax_pallas)
    want = jden.apply({"params": tree["params"]["denoiser"]},
                      *map(jnp.asarray, (x, t, LENGTHS, xf_proj, xf_out)))
    model = port_model(ModelConfig(**{**QUAD.__dict__, "causal": causal}))
    with torch.no_grad():
        direct = model.denoise(t_(x), t_(t), t_(LENGTHS), t_(xf_proj), t_(xf_out))
        kv = model.text_kv(t_(xf_out))
        assert all(isinstance(layer_kv, tuple) and len(layer_kv) == 2 for layer_kv in kv)
        grid = adaln_scale_shift_grid(model, np.array([17]), t_(xf_proj))
        adaln = [{k: (s[0], sh[0]) for k, (s, sh) in layer.items()} for layer in grid]
        hoisted = model.denoise(t_(x), t_(t), t_(LENGTHS), t_(xf_proj), text_kv=kv,
                                adaln=adaln)
    close(direct, want)
    close(hoisted, want)


def _tokens():
    from hig_tpu_torch.models.tokenizer import tokenize

    return np.stack([np.stack([tokenize(a)[0], tokenize(b)[0]]) for a, b in CAPTIONS])


@pytest.mark.parametrize("steps", [1, 3])
def test_quadratic_ddim_sampler_matches_jax(tree, steps):
    """DDIM through ``make_sampler`` in both packages for the efficient=False
    model from the same x_T (JAX's own draw, handed to the port through
    ``noise=``); JAX runs its einsum path. Tolerance 1e-5 of the output's
    largest magnitude, as for the efficient model."""
    from hig_tpu.diffusion import gaussian as jg
    from hig_tpu.train.trainer import make_sampler as jax_make_sampler
    from hig_tpu_torch.diffusion import gaussian as tg
    from hig_tpu_torch.train.trainer import make_sampler

    rng = jax.random.key(11)
    jsample = jax_make_sampler(jax_model(), jg.make_schedule(jg.linear_betas(1000)), T=T,
                               dim_pose=F, sampler="ddim", ddim_steps=steps)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want = np.asarray(jsample(jparams, jnp.asarray(_tokens(), jnp.int32),
                              jnp.asarray(LENGTHS), rng))
    _, init_rng = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(init_rng, (B, 2, T, F), jnp.float32))
    sample = make_sampler(port_model(), tg.make_schedule(tg.linear_betas(1000)), T=T,
                          dim_pose=F, ddim_steps=steps)
    got = sample(t_(_tokens()), t_(LENGTHS), noise=t_(noise)).numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


# --- weights and config --------------------------------------------------------


def test_random_tree_has_the_jax_no_eff_init_structure():
    args = (jnp.zeros((B, 2, T, F)), jnp.zeros((B,), jnp.int32), jnp.asarray(LENGTHS),
            jnp.asarray(_tokens(), jnp.int32))
    shapes = jax.eval_shape(jax_model().init, jax.random.key(0), *args)
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree_util.tree_map(
        lambda a: a, dict(shapes), is_leaf=lambda a: hasattr(a, "shape"))).items()}
    got = {k: tuple(v.shape) for k, v in flatten(random_flax_tree(QUAD, seed=0)).items()}
    assert got == want
    assert ("params", "denoiser", "layer_0", "int_ca_block", "text_norm", "scale") in got


def test_bridge_refuses_a_tree_of_the_other_family():
    """Every leaf of the --no_eff tree lands on a parameter of the quadratic
    model (load_flax_tree checks both ways), and the efficient tree, which
    lacks the interaction text_norm, does not load into it, nor the other
    way round."""
    model = port_model()
    assert len(model.state_dict()) == len(flatten(random_flax_tree(QUAD, seed=0)))
    efficient = ModelConfig(**{**QUAD.__dict__, "efficient": True})
    with pytest.raises(ValueError, match="unset parameters"):
        load_flax_tree(InteractionModel(QUAD), random_flax_tree(efficient, seed=0))
    with pytest.raises(ValueError, match="unused leaves"):
        load_flax_tree(InteractionModel(efficient), random_flax_tree(QUAD, seed=0))


@pytest.mark.parametrize("fields", [dict(causal=True), dict(efficient=False, fused_blocks=True)],
                         ids=["causal_efficient", "fused_quadratic"])
def test_config_refuses_unported_combinations(fields):
    """The quadratic model has no fused block. Causal efficient attention is
    ported (the causal core): its blocks are built causal, and accepted."""
    if not fields.get("efficient", True):
        with pytest.raises(ValueError):
            ModelConfig(**fields)
        return
    layer = InteractionModel(ModelConfig(**fields, num_layers=1)).denoiser.layers[0]
    assert layer.sa_block.causal and layer.int_ca_block.causal


# --- serving CLI --------------------------------------------------------------


def _serve(tmp_path, *extra):
    req = tmp_path / "requests.jsonl"
    req.write_text("\n".join(json.dumps(r) for r in [
        {"caption1": CAPTIONS[0][0], "caption2": CAPTIONS[0][1], "length": 11, "id": "a"},
        {"caption1": CAPTIONS[1][0], "caption2": CAPTIONS[1][1], "length": 6},
    ]) + "\n")
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps({**TINY_FIELDS, "clip": {"width": 32, "heads": 2,
                                                            "layers": 1}}))
    return subprocess.run(
        [sys.executable, "-m", "hig_tpu_torch.serve", "--device", "cpu",
         "--requests", str(req), "--out_dir", str(tmp_path / "out"), "--random_init", "0",
         "--model_config", str(cfg_path), "--ddim_steps", "2", *extra],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_serve_cli_no_eff_writes_results(tmp_path, causal):
    res = _serve(tmp_path, "--no_eff", *(["--causal"] if causal else []))
    assert res.returncode == 0, res.stderr
    assert '"efficient": false' in res.stdout
    assert f'"causal": {str(causal).lower()}' in res.stdout
    index = json.loads((tmp_path / "out" / "index.json").read_text())
    assert [e["id"] for e in index] == ["a", "req1"]
    a, b = np.load(tmp_path / "out" / "a.npz"), np.load(tmp_path / "out" / "req1.npz")
    assert a["features"].shape == (2, 12, F) and a["joints"].shape == (2, 11, 22, 3)
    assert b["features"].shape == (2, 7, F) and b["joints"].shape == (2, 6, 22, 3)
    assert np.isfinite(a["joints"]).all() and np.isfinite(b["joints"]).all()


@pytest.mark.parametrize("extra", [["--no_eff", "--blocks", "fused"], ["--causal"]],
                         ids=["no_eff_blocks", "causal_efficient"])
def test_serve_cli_refuses_meaningless_flags(tmp_path, extra):
    """--blocks means nothing to the quadratic model. --causal on the
    efficient model is ported (the causal core) and serves."""
    res = _serve(tmp_path, *extra)
    if "--no_eff" not in extra:
        assert res.returncode == 0, res.stderr
        assert '"efficient": true' in res.stdout and '"causal": true' in res.stdout
        assert (tmp_path / "out" / "index.json").exists()
        return
    assert res.returncode != 0
    assert not (tmp_path / "out" / "index.json").exists()
