"""Whole-slice parity of the PyTorch port (hig_tpu_torch) against hig_tpu on
the CPU: the weight bridge, the denoiser (plain and fused blocks), the AdaLN
hoist, the DDIM sampler end to end, the serving CLI, and the rule that the
port imports neither JAX nor hig_tpu.

Weights come from ``random_flax_tree`` (every leaf nonzero); inputs and the
sampler's initial noise are made once and handed to both packages.
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

from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.text_encoder import ClipTextConfig as JaxClip
from hig_tpu.train.trainer import adaln_scale_shift_grid as jax_grid
from hig_tpu.train.trainer import make_sampler as jax_make_sampler
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.train.trainer import adaln_scale_shift_grid, make_sampler
from hig_tpu_torch.weights import (
    flatten,
    flax_param_shapes,
    load_flax_tree,
    random_flax_tree,
    unflatten,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FIELDS = dict(
    num_frames=16, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
    text_latent_dim=16, text_ff_size=32, text_num_heads=2, num_text_layers=1,
)
TINY = ModelConfig(**TINY_FIELDS, clip=ClipTextConfig(width=32, heads=2, layers=1))
B, T, F = 2, 12, 263
LENGTHS = np.array([12, 7])
CAPTIONS = [("A person is hugging the other person.", "A person is kicked."),
            ("Two people shake hands.", "A person is pushed by the other person.")]


def jax_model(fused_blocks=False):
    return JaxModel(**TINY_FIELDS, clip_config=JaxClip(width=32, heads=2, layers=1),
                    fused_blocks=fused_blocks)


def port_model(fused_blocks=False):
    cfg = ModelConfig(**{**TINY.__dict__, "fused_blocks": fused_blocks})
    return load_flax_tree(InteractionModel(cfg), random_flax_tree(cfg, seed=0)).eval()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(jnp.asarray, random_flax_tree(TINY, seed=0))


def tokens():
    return np.stack([np.stack([tokenize(a)[0], tokenize(b)[0]]) for a, b in CAPTIONS])


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


# --- weight bridge ------------------------------------------------------------


@pytest.mark.parametrize("fused_blocks", [False, True])
def test_random_tree_has_the_jax_init_structure(fused_blocks):
    model = jax_model(fused_blocks)
    args = (jnp.zeros((B, 2, T, F)), jnp.zeros((B,), jnp.int32), jnp.asarray(LENGTHS),
            jnp.asarray(tokens(), jnp.int32))
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree_util.tree_map(
        lambda a: a, dict(shapes), is_leaf=lambda a: hasattr(a, "shape"))).items()}
    got = {k: tuple(v.shape) for k, v in flatten(random_flax_tree(TINY, seed=0)).items()}
    assert got == want
    assert {k: tuple(v) for k, v in flatten(flax_param_shapes(TINY)).items()} == want


def test_every_leaf_nonzero_and_every_parameter_set():
    tree = random_flax_tree(TINY, seed=3)
    flat = flatten(tree)
    assert all(np.all(v != 0) for v in flat.values())
    model = load_flax_tree(InteractionModel(TINY), tree)
    values = sorted(float(v.abs().sum()) for v in flat.values() for v in [t_(v)])
    loaded = sorted(float(p.abs().sum()) for p in model.state_dict().values())
    assert len(loaded) == len(flat)
    np.testing.assert_allclose(loaded, values, rtol=1e-6)
    # spot-check the (in, out) → (out, in) transpose
    k = flat[("params", "denoiser", "layer_1", "int_ca_block", "key", "kernel")]
    np.testing.assert_array_equal(
        model.denoiser.layers[1].int_ca_block.key.weight.detach().numpy(), k.T)


@pytest.mark.parametrize("fault", ["leftover", "unset", "shape"])
def test_bridge_refuses_a_mismatched_tree(fault):
    flat = flatten(random_flax_tree(TINY, seed=0))
    key = ("params", "denoiser", "out2", "bias")
    if fault == "leftover":
        flat[("params", "denoiser", "extra", "bias")] = np.ones(3, np.float32)
    elif fault == "unset":
        del flat[key]
    else:
        flat[key] = np.ones(7, np.float32)
    with pytest.raises(ValueError):
        load_flax_tree(InteractionModel(TINY), unflatten(flat))


def test_npz_round_trip(tmp_path):
    from hig_tpu_torch.weights import load_npz

    flat = flatten(random_flax_tree(TINY, seed=1))
    path = tmp_path / "p.npz"
    np.savez(path, **{"/".join(k): v for k, v in flat.items()})
    back = flatten(load_npz(str(path)))
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


# --- denoiser and hoists --------------------------------------------------------


def denoiser_inputs():
    x = rand(B, 2, T, F, seed=4)
    t = np.array([17, 17])
    xf_proj = rand(B, 2, TINY.time_embed_dim, seed=5)
    xf_out = rand(B, 2, 9, TINY.text_latent_dim, seed=6)
    return x, t, LENGTHS, xf_proj, xf_out


@pytest.mark.parametrize("jax_fused", [False, True], ids=["jax_einsum", "jax_pallas"])
@pytest.mark.parametrize("port_fused", [False, True], ids=["projected", "fused"])
def test_denoiser_matches_jax(jparams, port_fused, jax_fused):
    """The port's denoiser (plain B1 or plain B2 on the CPU, with the text
    KᵀV and AdaLN hoisted) against JAX with fused_blocks on (the Pallas
    block in interpret mode) and off. Tolerance 2e-5."""
    x, t, lengths, xf_proj, xf_out = denoiser_inputs()
    from hig_tpu.models.denoiser import InteractionDenoiser

    jden = InteractionDenoiser(**{k: v for k, v in TINY_FIELDS.items()
                                  if not k.startswith(("text_ff", "text_num", "num_text"))},
                               fused_blocks=jax_fused)
    want = jden.apply({"params": jparams["params"]["denoiser"]},
                      *map(jnp.asarray, (x, t, lengths, xf_proj, xf_out)))
    model = port_model(port_fused)
    with torch.no_grad():
        direct = model.denoise(t_(x), t_(t), t_(lengths), t_(xf_proj), t_(xf_out))
        kv = model.text_kv(t_(xf_out))
        grid = adaln_scale_shift_grid(model, np.array([17]), t_(xf_proj))
        adaln = [{k: (s[0], sh[0]) for k, (s, sh) in layer.items()} for layer in grid]
        hoisted = model.denoise(t_(x), t_(t), t_(lengths), t_(xf_proj), text_kv=kv,
                                adaln=adaln)
    np.testing.assert_allclose(direct.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(hoisted.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_adaln_grid_matches_jax(jparams):
    ts = jg.ddim_timesteps(1000, 5)
    xf_proj = rand(B, 2, TINY.time_embed_dim, seed=7)
    stub = type("M", (), {"dtype": jnp.float32, "latent_dim": TINY.latent_dim,
                          "single_transformer": False})()
    want = jax_grid(stub, jparams, ts, jnp.asarray(xf_proj))
    with torch.no_grad():
        got = adaln_scale_shift_grid(port_model(), ts, t_(xf_proj))
    for g_layer, w_layer in zip(got, want, strict=True):
        assert g_layer.keys() == w_layer.keys()
        for k in g_layer:
            for a, b in zip(g_layer[k], w_layer[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0)


def test_encode_text_matches_jax(jparams):
    tok = tokens()
    want = jax_model().apply(jparams, jnp.asarray(tok, jnp.int32),
                             method=JaxModel.encode_text)
    with torch.no_grad():
        got = port_model().encode_text(t_(tok))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0)


# --- the sampler end to end -------------------------------------------------------


def test_schedule_and_ddim_grid_match_jax():
    betas = jg.linear_betas(1000)
    np.testing.assert_array_equal(tg.linear_betas(1000), betas)
    want, got = jg.schedule_tables_f64(betas), tg.schedule_tables_f64(betas)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for steps in (1, 2, 50, 1000):
        np.testing.assert_array_equal(tg.ddim_timesteps(1000, steps),
                                      jg.ddim_timesteps(1000, steps))


@pytest.mark.parametrize("port_fused", [False, True], ids=["projected", "fused"])
@pytest.mark.parametrize("steps", [1, 4])
def test_ddim_sampler_matches_jax(jparams, steps, port_fused):
    """DDIM through ``make_sampler`` in both packages from the same x_T (the
    JAX sampler's own draw, handed to the port through ``noise=``).

    Tolerance: 1e-5 of the output's largest magnitude. Each step's
    x' = c1·x + c2·eps scales the denoiser's f32 rounding by |c2| (157 at
    t = 999), and random weights put |x| in the thousands.
    """
    sched = jg.make_schedule(jg.linear_betas(1000))
    rng = jax.random.key(11)
    jsample = jax_make_sampler(jax_model(), sched, T=T, dim_pose=F, sampler="ddim",
                               ddim_steps=steps)
    want = np.asarray(jsample(jparams, jnp.asarray(tokens(), jnp.int32),
                              jnp.asarray(LENGTHS), rng))
    _, init_rng = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(init_rng, (B, 2, T, F), jnp.float32))
    sample = make_sampler(port_model(port_fused),
                          tg.make_schedule(tg.linear_betas(1000)), T=T, dim_pose=F,
                          ddim_steps=steps)
    got = sample(t_(tokens()), t_(LENGTHS), noise=t_(noise)).numpy()
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_ddim_loop_with_an_identity_model():
    """eps ≡ 0 reduces each DDIM step to x ← c1·x; the product of the c1
    over the grid is sqrt(ᾱ_prev(0) / ᾱ(T-1)) = 1 / sqrt(ᾱ(T-1))."""
    sched = tg.make_schedule(tg.linear_betas(1000))
    x = torch.ones(3, 4)
    out = tg.ddim_sample_loop(sched, lambda x, t: torch.zeros_like(x), x, num_steps=10)
    want = 1.0 / np.sqrt(np.float64(sched.alphas_cumprod[-1]))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)


# --- serving CLI and import rule ------------------------------------------------


def test_serve_cli_writes_results(tmp_path):
    req = tmp_path / "requests.jsonl"
    req.write_text("\n".join(json.dumps(r) for r in [
        {"caption1": CAPTIONS[0][0], "caption2": CAPTIONS[0][1], "length": 11, "id": "a"},
        {"caption1": CAPTIONS[1][0], "caption2": CAPTIONS[1][1], "length": 6},
    ]) + "\n")
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps({**TINY_FIELDS, "clip": {"width": 32, "heads": 2,
                                                            "layers": 1}}))
    out = tmp_path / "out"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for blocks in ("fused", "projected"):
        subprocess.run(
            [sys.executable, "-m", "hig_tpu_torch.serve", "--device", "cpu",
             "--requests", str(req), "--out_dir", str(out / blocks), "--random_init", "0",
             "--model_config", str(cfg_path), "--ddim_steps", "2", "--blocks", blocks],
            cwd=REPO, env=env, check=True, capture_output=True, timeout=300,
        )
        index = json.loads((out / blocks / "index.json").read_text())
        assert [e["id"] for e in index] == ["a", "req1"]
        a = np.load(out / blocks / "a.npz")
        assert a["features"].shape == (2, 12, F) and a["joints"].shape == (2, 11, 22, 3)
        b = np.load(out / blocks / "req1.npz")
        assert b["features"].shape == (2, 7, F) and b["joints"].shape == (2, 6, 22, 3)
        assert np.isfinite(a["joints"]).all() and np.isfinite(b["joints"]).all()
    np.testing.assert_allclose(np.load(out / "fused" / "a.npz")["joints"],
                               np.load(out / "projected" / "a.npz")["joints"],
                               rtol=1e-4, atol=1e-4)


def test_serve_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from hig_tpu_torch import resolve_device

    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_hig_tpu():
    code = (
        "import sys, importlib, pkgutil\n"
        "for k in list(sys.modules):\n"
        "    if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hig_tpu'):\n"
        "        del sys.modules[k]\n"
        "for k in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hig_tpu', 'matplotlib', 'h5py',\n"
        "          'pyrender'):\n"
        "    sys.modules[k] = None\n"
        "import hig_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hig_tpu_torch.__path__, 'hig_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "import profile_sessions\n"
        "print(' '.join(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 23
    assert {"hig_tpu_torch.ops.flash_attention", "hig_tpu_torch.ops.pallas_attention",
            "hig_tpu_torch.models.attention", "hig_tpu_torch.serve", "hig_tpu_torch.label",
            "hig_tpu_torch.train.labeling", "hig_tpu_torch.diffusion.timestep_samplers",
            "hig_tpu_torch.diffusion.solvers", "hig_tpu_torch.models.eval_models",
            "hig_tpu_torch.eval.metrics", "hig_tpu_torch.eval.evaluator",
            "hig_tpu_torch.eval.trainer", "hig_tpu_torch.eval.train", "hig_tpu_torch.eval.test",
            "hig_tpu_torch.evaluate", "hig_tpu_torch.utils.kinematics",
            "hig_tpu_torch.utils.skeleton", "hig_tpu_torch.utils.filters",
            "hig_tpu_torch.data.synthetic", "hig_tpu_torch.data.pose_tracks",
            "hig_tpu_torch.viz.plot", "hig_tpu_torch.make_synthetic_data",
            "hig_tpu_torch.preprocess", "hig_tpu_torch.extract_pose",
            "hig_tpu_torch.visualize", "hig_tpu_torch.diffusion.distill",
            "hig_tpu_torch.distill", "hig_tpu_torch.smpl.lbs", "hig_tpu_torch.smpl.prior",
            "hig_tpu_torch.smpl.lbfgs", "hig_tpu_torch.smpl.smplify", "hig_tpu_torch.smpl.fit",
            "hig_tpu_torch.render_smpl", "hig_tpu_torch.models.legacy_evaluators",
            "hig_tpu_torch.eval.legacy_protocol", "hig_tpu_torch.data.word_vectorizer",
            "hig_tpu_torch.parallel.distributed", "hig_tpu_torch.parallel.mesh",
            "hig_tpu_torch.parallel.pipeline", "hig_tpu_torch.parallel.layout"} <= names
