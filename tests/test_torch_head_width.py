"""Head widths 128, 16 and 32 in the PyTorch port (hig_tpu_torch) against
hig_tpu on the CPU, and the pure-Python routing of the kernels' head widths
and forms.

- The plain versions of B1, B2, B3 and B4 at head width 128 (D = 256, 2
  heads, T <= 20, 2 pairs), and at widths 16 and 32 (D = 64 with 4 and 2
  heads), against the Pallas kernels in interpret mode, float32 within
  2e-5 and bfloat16 under ``test_torch_bf16``'s gates.
- A 2-layer denoiser at width 128 (latent 256, 2 heads) and at width 16
  (latent 128, 8 heads: the model every run in ``results/`` trains) through
  the weight bridge against JAX's, fused (B1's twin) and projected (B2's).
- The routing: the head widths the CUDA kernels take and the message for
  any other; each whole form's row cap as a function of the width; the form
  B1-bf16's, B2-bf16a's and B3-bf16's routers pick at T = 197, 320, 321
  and 394 for widths 16, 32, 64 and 128.

(The ordered bfloat16 sum past 1024 terms: ``test_torch_bf16_train.py``'s
``SUM_TERMS``.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu_torch.ops import pallas_attention as pa
from hig_tpu_torch.ops.flash_attention import flash_attention_plain
from hig_tpu_torch.ops.fused_block import BlockWeights, fused_attention_block_plain
from tests.test_torch_bf16 import assert_bf16_parity, jax_run, jb, tb

D, H, B, T = 256, 2, 2, 20  # head width 128
NARROW = {16: (64, 4), 32: (64, 2)}  # head width -> (D, heads)
ATOL = 2e-5
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(tq=T, seed=30, d=D):
    rng = np.random.RandomState(seed)
    w = {n: (rng.randn(d, d) / np.sqrt(d)).astype(np.float32) for n in ("wq", "wk", "wv", "wo")}
    w.update({n: (0.1 * rng.randn(d)).astype(np.float32)
              for n in ("bq", "bk", "bv", "bo", "ln_b", "styl_b")})
    w.update({n: (1 + 0.1 * rng.randn(d)).astype(np.float32) for n in ("ln_g", "styl_g")})
    x = rng.randn(B, 2, tq, d).astype(np.float32)
    lengths = np.array([tq, max(1, tq * 2 // 3)])
    mask = np.broadcast_to((np.arange(tq) < lengths[:, None])[:, None, :],
                           (B, 2, tq)).astype(np.float32)
    scale, shift = (0.5 * rng.randn(B, 2, d).astype(np.float32) for _ in "ss")
    return w, x, mask, scale, shift


def t_(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def block_weights(w, dtype):
    lin = {n: t_(w[n].T, dtype) for n in ("wq", "wk", "wv", "wo")}  # flax (in, out) → (out, in)
    vec = {n: t_(w[n], dtype) for n in w if w[n].ndim == 1}
    return BlockWeights(vec["ln_g"], vec["ln_b"], lin["wq"], vec["bq"], lin["wk"], vec["bk"],
                        lin["wv"], vec["bv"], vec["styl_g"], vec["styl_b"], lin["wo"], vec["bo"])


def case_b1(variant, bf16, d=D, h=H):
    from hig_tpu.ops.fused_block import fused_attention_block as pallas_block

    w, x, mask, scale, shift = inputs(d=d)
    inter = variant == "interaction"
    params = {"norm": {"scale": w["ln_g"], "bias": w["ln_b"]},
              "query": {"kernel": w["wq"], "bias": w["bq"]},
              "key": {"kernel": w["wk"], "bias": w["bk"]},
              "value": {"kernel": w["wv"], "bias": w["bv"]},
              "proj_out": {"norm": {"scale": w["styl_g"], "bias": w["styl_b"]},
                           "out": {"kernel": w["wo"], "bias": w["bo"]}}}

    def pallas(dtype):
        cast = (lambda a: jnp.asarray(jb(a), dtype)) if bf16 else jnp.asarray
        p = jax.tree_util.tree_map(cast, params)
        jx, jm = cast(x), jnp.asarray(mask, dtype)
        kv, km = (jnp.flip(jx, 1), jnp.flip(jm, 1)) if inter else (jx, jm)
        return pallas_block(jx, kv, km, cast(scale), cast(shift), p, num_heads=h,
                            interpret=True)

    def port(dtype):
        cast = (lambda a: tb(a).to(dtype)) if bf16 else t_
        wt = block_weights(w, BF16 if bf16 else torch.float32)
        wt = BlockWeights(*[a.to(dtype) for a in wt])
        return fused_attention_block_plain(cast(x), t_(mask), cast(scale)[..., None, :],
                                           cast(shift)[..., None, :], wt, h, inter)

    return pallas, port


def case_b2(variant, bf16, d=D, h=H):
    from hig_tpu.ops.pallas_attention import fused_projected_attention as pallas_proj

    w, x, mask, _, _ = inputs(seed=31, d=d)
    kv, kmask = (x, mask) if variant == "self" else (np.flip(x, 1).copy(),
                                                     np.flip(mask, 1).copy())

    def pallas(dtype):
        cast = (lambda a: jnp.asarray(jb(a), dtype)) if bf16 else jnp.asarray
        return pallas_proj(cast(x), cast(kv), *(cast(w[n]) for n in
                                                ("wq", "bq", "wk", "bk", "wv", "bv")),
                           h, key_mask=jnp.asarray(kmask, dtype), interpret=True)

    def port(dtype):
        cast = (lambda a: tb(a).to(dtype)) if bf16 else t_
        bw = block_weights(w, BF16 if bf16 else torch.float32)
        return pa.fused_projected_attention_plain(
            cast(x), cast(kv), *(a.to(dtype) for a in (bw.wq, bw.bq, bw.wk, bw.bk, bw.wv,
                                                       bw.bv)), h, t_(kmask))

    return pallas, port


def qkv_inputs(tq, tk, seed, d=D):
    rng = np.random.RandomState(seed)
    _, _, mask, _, _ = inputs(tq=tk, seed=seed, d=d)
    q = rng.randn(B, 2, tq, d).astype(np.float32)
    k, v = (rng.randn(B, 2, tk, d).astype(np.float32) for _ in "kv")
    return q, k, v, mask


def case_b3(variant, bf16, d=D, h=H):
    from hig_tpu.ops.pallas_attention import fused_efficient_attention as pallas_core

    q, k, v, mask = qkv_inputs(T, 13 if variant == "tk13" else T, 32, d)

    def pallas(dtype):
        cast = (lambda a: jnp.asarray(jb(a), dtype)) if bf16 else jnp.asarray
        args = [cast(a) for a in (q, k, v)] + [jnp.asarray(mask, dtype)]
        return jax_run(lambda q_, k_, v_, m_: pallas_core(q_, k_, v_, h, key_mask=m_,
                                                          interpret=True),
                       bf16 and dtype == jnp.bfloat16, *args)

    def port(dtype):
        cast = (lambda a: tb(a).to(dtype)) if bf16 else t_
        return pa.fused_efficient_attention_plain(cast(q), cast(k), cast(v), h, t_(mask))

    return pallas, port


def case_b4(variant, bf16, d=D, h=H):
    from hig_tpu.ops.flash_attention import flash_attention as pallas_flash

    q, k, v, mask = qkv_inputs(T, T, 33, d)

    def pallas(dtype):
        cast = (lambda a: jnp.asarray(jb(a), dtype)) if bf16 else jnp.asarray
        jq, jk, jv = (cast(a) for a in (q, k, v))
        jm = jnp.asarray(mask, dtype)
        if variant == "partner":
            jk, jv, jm = jnp.flip(jk, 1), jnp.flip(jv, 1), jnp.flip(jm, 1)
        return pallas_flash(jq, jk, jv, h, key_mask=jm, causal=variant == "causal",
                            interpret=True)

    def port(dtype):
        cast = (lambda a: tb(a).to(dtype)) if bf16 else t_
        return flash_attention_plain(cast(q), cast(k), cast(v), h, t_(mask),
                                     variant == "causal", variant == "partner")

    return pallas, port


CASES = {
    "b1_interaction_f32": (case_b1, "interaction", False),
    "b1_self_bf16": (case_b1, "self", True),
    "b2_partner_f32": (case_b2, "partner", False),
    "b2_self_bf16": (case_b2, "self", True),
    "b3_tk13_f32": (case_b3, "tk13", False),
    "b3_self_bf16": (case_b3, "self", True),
    "b4_causal_f32": (case_b4, "causal", False),
    "b4_partner_bf16": (case_b4, "partner", True),
}


def twin_against_pallas(pallas, port, bf16: bool) -> None:
    with torch.no_grad():
        if not bf16:
            np.testing.assert_allclose(port(torch.float32).numpy(), np.asarray(pallas(jnp.float32)),
                                       atol=ATOL, rtol=0)
        else:
            assert_bf16_parity(port(BF16), pallas(jnp.bfloat16), pallas(jnp.float32),
                               port(torch.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_twins_match_pallas_at_head_width_128(case):
    """Each kernel's plain twin (what a CPU tensor takes) at head width 128
    against the Pallas kernel in interpret mode on the same inputs."""
    make, variant, bf16 = CASES[case]
    twin_against_pallas(*make(variant, bf16), bf16)


@pytest.mark.parametrize("hd", list(NARROW))
@pytest.mark.parametrize("case", list(CASES))
def test_twins_match_pallas_at_narrow_head_widths(case, hd):
    """The same at head widths 16 and 32 (D = 64 with 4 and 2 heads), the
    widths whose heads the kernels pack into one 64-column tile: the feature
    softmax per head and the state per head are what the packing must keep."""
    make, variant, bf16 = CASES[case]
    d, h = NARROW[hd]
    twin_against_pallas(*make(variant, bf16, d, h), bf16)


WIDTH = dict(num_layers=2, latent_dim=D, ff_size=64, num_heads=H, num_text_layers=1,
             text_latent_dim=16, text_ff_size=32, text_num_heads=2)
# results/eqrun3_allfive/generator_opt.txt's motion widths (latent 128, 8
# heads of 16), cut to 2 layers, a narrow FFN and the tests' small text tower
WIDTH_16 = dict(WIDTH, latent_dim=128, num_heads=8)


def denoiser_case(width: dict):
    """A seeded flax tree of the 2-layer model of ``width``, one denoiser
    call's inputs, and JAX's output on its einsum route (jitted)."""
    from hig_tpu import config as jcfg
    from hig_tpu.models.interaction_model import InteractionModel as JaxModel
    from hig_tpu.models.interaction_model import model_from_config
    from hig_tpu_torch.config import ExperimentConfig, model_config
    from hig_tpu_torch.weights import random_flax_tree
    from tests.test_torch_pipeline import FEATS, JAX_CLIP, PORT_CLIP

    mcfg = model_config(ExperimentConfig(**width), PORT_CLIP)
    tree = random_flax_tree(mcfg, seed=1)
    jmodel = model_from_config(jcfg.ExperimentConfig(**width), clip_config=JAX_CLIP)
    rng = np.random.RandomState(34)
    args = (rng.randn(B, 2, 12, FEATS).astype(np.float32), np.array([700, 31]),
            np.array([12, 7], np.int32), rng.randn(B, 2, mcfg.time_embed_dim).astype(np.float32),
            rng.randn(B, 2, 9, 16).astype(np.float32))
    want = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=JaxModel.denoise))(
        jax.tree_util.tree_map(jnp.asarray, tree), *map(jnp.asarray, args))
    return mcfg, tree, args, np.asarray(want)


@pytest.fixture(scope="module")
def width_128_denoiser():
    return denoiser_case(WIDTH)


@pytest.fixture(scope="module")
def width_16_denoiser():
    return denoiser_case(WIDTH_16)


def denoiser_against_jax(case, route: str) -> None:
    from hig_tpu_torch.models.interaction_model import InteractionModel
    from hig_tpu_torch.weights import load_flax_tree

    mcfg, tree, args, want = case
    cfg = dataclasses.replace(mcfg, fused_blocks=route == "fused")
    port = load_flax_tree(InteractionModel(cfg), tree["params"]).eval()
    with torch.no_grad():
        got = port.denoise(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("route", ["fused", "projected"])
def test_width_128_denoiser_matches_jax(width_128_denoiser, route):
    """A 2-layer denoiser at latent 256 with 2 heads (head width 128)
    through the weight bridge, its efficient blocks fused (B1's twin) or
    projected (B2's), against JAX's einsum route (the function both Pallas
    kernels compute; the kernels' twins are held against the Pallas kernels
    above), one denoiser call in float32."""
    denoiser_against_jax(width_128_denoiser, route)


@pytest.mark.parametrize("route", ["fused", "projected"])
def test_width_16_denoiser_matches_jax(width_16_denoiser, route):
    """The same at latent 128 with 8 heads (head width 16), the widths of
    the model every run in ``results/`` trains."""
    denoiser_against_jax(width_16_denoiser, route)


WIDTHS_NAMED = "head widths 16, 32, 64 and 128"


@pytest.mark.parametrize("heads,taken", [(8, True), (4, True), (16, True), (2, False),
                                         (6, False)])
def test_cuda_width_check(heads, taken):
    """At D = 512: heads of 64, 128 and 32 are taken; 256 and a D that the
    heads do not divide raise, naming the widths taken."""
    if taken:
        assert pa.check_cuda_width(512, heads) == 512 // heads
    else:
        with pytest.raises(ValueError, match=WIDTHS_NAMED):
            pa.check_cuda_width(512, heads)


@pytest.mark.parametrize("D_,heads,taken", [(128, 8, True), (256, 8, True), (64, 4, True),
                                            (64, 2, True), (384, 8, False), (768, 8, False),
                                            (96, 2, False), (1024, 4, False)])
def test_cuda_width_check_at_other_widths(D_, heads, taken):
    """Heads of 16 and 32 are taken (the results/ model's latent 128 with 8
    heads, latent 256 with 8); heads of 48, 96 and 256 raise, naming the
    four widths taken."""
    if taken:
        assert pa.check_cuda_width(D_, heads) == D_ // heads
    else:
        with pytest.raises(ValueError, match=WIDTHS_NAMED):
            pa.check_cuda_width(D_, heads)


@pytest.mark.parametrize("D_,heads", [(32, 2), (96, 3), (160, 5)])
def test_packed_heads_need_whole_tiles(D_, heads):
    """At widths 16 and 32 the kernels pack heads into 64-column tiles, so a
    D that is no multiple of 64 raises, naming the tile."""
    with pytest.raises(ValueError, match="64-column tiles"):
        pa.check_cuda_width(D_, heads)


@pytest.mark.parametrize("hd,cap", [(64, 320), (128, 128), (32, 320), (16, 320)])
def test_whole_form_rows_follow_the_width(hd, cap):
    """The whole forms' largest T is a function of the head width (the
    kernels' own, held equal on the card): 320 rows at 64, and at 16 and 32
    (one 64-column tile of packed heads), 128 at 128; other widths have
    none."""
    assert pa.whole_max_t(hd) == cap
    assert pa.BF16_MAX_T == pa.whole_max_t(64)
    assert pa.whole_max_t(32) == 320
    for other in (48, 256):
        with pytest.raises(ValueError, match=WIDTHS_NAMED):
            pa.whole_max_t(other)


ROUTED = {(64, 197): "whole", (64, 320): "whole", (64, 321): "stream", (64, 394): "stream",
          (128, 197): "stream", (128, 320): "stream", (128, 321): "stream",
          (128, 394): "stream",
          (16, 197): "whole", (16, 320): "whole", (16, 321): "stream", (16, 394): "stream",
          (32, 197): "whole", (32, 320): "whole", (32, 321): "stream", (32, 394): "stream"}


@pytest.mark.parametrize("hd,t", list(ROUTED))
def test_routers_pick_the_form(hd, t):
    """B1-bf16's, B2-bf16a's and B3-bf16's routers at T = 197, 320, 321
    and 394: the whole form up to its cap, the streaming form past it."""
    want = ROUTED[hd, t]
    assert pa.whole_or_stream(t, hd) == want
    assert pa.b3_bf16_form(t, t, hd) == want
    assert pa.b3_bf16_form(91, t, hd) == want  # either side past the cap streams
