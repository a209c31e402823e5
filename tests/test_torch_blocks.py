"""Module-level parity of the PyTorch port (hig_tpu_torch) against hig_tpu on
the CPU: tokenizer, conditioning blocks, the efficient attention blocks,
the plain versions of the B1/B2 kernels against the Pallas kernels in
interpret mode, the text stack and the joint decoder.

Weights come from ``random_flax_tree`` (every leaf nonzero) and inputs from
numpy, and both packages get the same arrays. Tolerance: 2e-5 absolute in
float32 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.models import attention as ja
from hig_tpu.models import embeddings as je
from hig_tpu.models import text_encoder as jt
from hig_tpu_torch.models import attention as ta
from hig_tpu_torch.models import embeddings as te
from hig_tpu_torch.models import text_encoder as tt
from hig_tpu_torch.models.interaction_model import ModelConfig
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

ATOL = 2e-5
TINY = ModelConfig(
    num_frames=16, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
    text_latent_dim=16, text_ff_size=32, text_num_heads=2, num_text_layers=1,
    clip=tt.ClipTextConfig(width=32, heads=2, layers=1),
)
JAX_CLIP = jt.ClipTextConfig(width=32, heads=2, layers=1)
D, H, E, B, T = TINY.latent_dim, TINY.num_heads, TINY.time_embed_dim, 2, 12
LENGTHS = np.array([12, 7])


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree():
    return random_flax_tree(TINY, seed=0)["params"]


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


def as_np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=atol, rtol=0)


def mask_bt():
    return (np.arange(T) < LENGTHS[:, None]).astype(np.float32)[:, None, :]  # (B, 1, T)


# --- tokenizer ---------------------------------------------------------------


def test_tokenizer_ids_identical():
    from hig_tpu.models.tokenizer import tokenize as jtok
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.models.tokenizer import tokenize as ttok

    texts = CAPS + ["", "  Two   people &amp; a high-five!  ", "x " * 100]
    np.testing.assert_array_equal(ttok(texts), jtok(texts))


def test_vocab_copy_matches():
    from hig_tpu.data import vocab as jv
    from hig_tpu_torch.data import vocab as tv

    assert tv.CAPS == jv.CAPS
    assert tv.CLASSID2CAPS == jv.CLASSID2CAPS


# --- embeddings ---------------------------------------------------------------


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 17, 500, 999])
    close(te.timestep_embedding(t_(t), dim), je.timestep_embedding(jnp.asarray(t), dim),
          atol=1e-5)


def test_time_embed_mlp(tree):
    sub = tree["denoiser"]["time_embed"]
    t = np.array([3, 999])
    want = je.TimeEmbedMLP(D, E).apply({"params": sub}, jnp.asarray(t))
    got = load_flax_tree(te.TimeEmbedMLP(D, E), sub)(t_(t))
    close(got, want)


def test_stylization_block_and_split(tree):
    sub = tree["denoiser"]["layer_0"]["ffn"]["proj_out"]
    h, emb = rand(B, 2, T, D, seed=1), rand(B, 2, E, seed=2)
    jblock = je.StylizationBlock(D)
    want = jblock.apply({"params": sub}, jnp.asarray(h), jnp.asarray(emb))
    block = load_flax_tree(te.StylizationBlock(D, E), sub)
    close(block(t_(h), t_(emb)), want)
    scale, shift = block.scale_shift(t_(emb))
    js, jsh = jblock.apply({"params": sub}, jnp.asarray(emb),
                           method=je.StylizationBlock.scale_shift)
    close(scale, js)
    close(shift, jsh)
    close(block.from_scale_shift(t_(h), scale, shift), block(t_(h), t_(emb)), atol=0)


def test_length_mask():
    lengths = np.array([0, 3, 12])
    close(te.length_mask(t_(lengths), T), je.length_mask(jnp.asarray(lengths), T), atol=0)


# --- attention blocks -------------------------------------------------------


def _block_case(tree, name, fused, seed=3):
    sub = tree["denoiser"]["layer_0"][name]
    cls = {"sa_block": (ta.EfficientSelfAttention, ja.EfficientSelfAttention),
           "int_ca_block": (ta.EfficientInteractionAttention,
                            ja.EfficientInteractionAttention)}[name]
    # eval mode: a fused block in train mode takes the B2 route
    port = load_flax_tree(cls[0](D, H, E, fused=fused), sub).eval()
    return port, cls[1](D, H), sub, rand(B, 2, T, D, seed=seed), rand(B, 2, E, seed=seed + 1)


@pytest.mark.parametrize("fused", [False, True], ids=["projected", "fused"])
@pytest.mark.parametrize("name", ["sa_block", "int_ca_block"])
def test_kernel_blocks_match_flax(tree, name, fused):
    """The self-attention and interaction blocks (plain B2 or plain B1 on the
    CPU) against the flax einsum blocks, with emb and with hoisted AdaLN."""
    port, jblock, sub, x, emb = _block_case(tree, name, fused)
    mask = mask_bt()
    want = jblock.apply({"params": sub}, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(mask))
    with torch.no_grad():
        close(port(t_(x), t_(emb), t_(mask)), want)
        adaln = port.proj_out.scale_shift(t_(emb))
        close(port(t_(x), None, t_(mask), adaln=adaln), want)


def test_cross_attention_kv_and_from_kv(tree):
    sub = tree["denoiser"]["layer_1"]["ca_block"]
    x, xf, emb = rand(B, 2, T, D, seed=5), rand(B, 2, 9, 16, seed=6), rand(B, 2, E, seed=7)
    jblock = ja.EfficientCrossAttention(D, 16, H)
    port = load_flax_tree(ta.EfficientCrossAttention(D, 16, H, E), sub)
    args = jnp.asarray(x), jnp.asarray(xf), jnp.asarray(emb)
    want = jblock.apply({"params": sub}, *args)
    jkv = jblock.apply({"params": sub}, jnp.asarray(xf), method=ja.EfficientCrossAttention.kv)
    with torch.no_grad():
        close(port(t_(x), t_(xf), t_(emb)), want)
        kv = port.kv(t_(xf))
        close(kv, jkv)
        close(port.from_kv(t_(x), kv, None, adaln=port.proj_out.scale_shift(t_(emb))), want)


def test_ffn(tree):
    sub = tree["denoiser"]["layer_1"]["ffn"]
    x, emb = rand(B, 2, T, D, seed=8), rand(B, 2, E, seed=9)
    want = ja.FFN(D, TINY.ff_size).apply({"params": sub}, jnp.asarray(x), jnp.asarray(emb))
    with torch.no_grad():
        close(load_flax_tree(ta.FFN(D, TINY.ff_size, E), sub)(t_(x), t_(emb)), want)


def test_efficient_attention_core():
    q, k, v = rand(B, 2, T, D, seed=10), rand(B, 2, T, D, seed=11), rand(B, 2, T, D, seed=12)
    mask = np.broadcast_to(mask_bt(), (B, 2, T)).copy()
    want = ja.efficient_attention(*map(jnp.asarray, (q, k, v)), H, jnp.asarray(mask))
    close(ta.efficient_attention(t_(q), t_(k), t_(v), H, t_(mask)), want)


# --- plain kernel versions against the Pallas kernels (interpret mode) ------


@pytest.mark.parametrize("interaction", [False, True], ids=["self", "interaction"])
def test_plain_fused_block_matches_pallas(tree, interaction):
    from hig_tpu.ops.fused_block import fused_attention_block as pallas_block
    from hig_tpu_torch.ops.fused_block import (
        fused_attention_block,
        fused_attention_block_plain,
    )

    name = "int_ca_block" if interaction else "sa_block"
    port, _, sub, x, _ = _block_case(tree, name, fused=True, seed=13)
    mask = np.broadcast_to(mask_bt(), (B, 2, T)).copy()
    scale, shift = rand(B, 2, D, seed=14, scale=0.5), rand(B, 2, D, seed=15, scale=0.5)
    jx, jmask = jnp.asarray(x), jnp.asarray(mask)
    kv, kmask = (jnp.flip(jx, 1), jnp.flip(jmask, 1)) if interaction else (jx, jmask)
    want = pallas_block(jx, kv, kmask, jnp.asarray(scale), jnp.asarray(shift), sub,
                        num_heads=H, interpret=True)
    args = (t_(x), t_(mask), t_(scale)[..., None, :], t_(shift)[..., None, :],
            port.block_weights(), H, interaction)
    with torch.no_grad():
        close(fused_attention_block_plain(*args), want)
        before = fused_attention_block.launches
        close(fused_attention_block(*args), want)  # CPU tensors take the plain version
    assert fused_attention_block.launches == before


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
def test_plain_projected_attention_matches_pallas(tree, same_source):
    from hig_tpu.ops.pallas_attention import fused_projected_attention as pallas_proj
    from hig_tpu_torch.ops.pallas_attention import (
        fused_projected_attention,
        fused_projected_attention_plain,
    )

    sub = tree["denoiser"]["layer_0"]["sa_block"]
    q_src = rand(B, 2, T, D, seed=16)
    kv_src = q_src if same_source else rand(B, 2, T, D, seed=17)
    mask = np.broadcast_to(mask_bt(), (B, 2, T)).copy()
    ws = [sub[n][p] for n in ("query", "key", "value") for p in ("kernel", "bias")]
    want = pallas_proj(jnp.asarray(q_src), jnp.asarray(kv_src), *map(jnp.asarray, ws),
                       H, key_mask=jnp.asarray(mask), interpret=True)
    tws = [t_(np.ascontiguousarray(w.T)) if w.ndim == 2 else t_(w) for w in ws]
    tq = t_(q_src)
    tkv = tq if same_source else t_(kv_src)
    close(fused_projected_attention_plain(tq, tkv, *tws, H, t_(mask)), want)
    before = fused_projected_attention.launches
    close(fused_projected_attention(tq, tkv, *tws, H, key_mask=t_(mask)), want)
    assert fused_projected_attention.launches == before


def test_wrappers_refuse_other_devices(tree):
    """A tensor that is neither on the CPU nor usable by the CUDA kernel
    raises; nothing falls back to the plain version."""
    from hig_tpu_torch.ops.fused_block import fused_attention_block
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention

    port, _, _, _, _ = _block_case(tree, "sa_block", fused=True)
    x = torch.zeros((B, 2, T, D), device="meta")
    w = [torch.zeros(s, device="meta") for s in ((D, D), (D,))]
    with pytest.raises(ValueError):
        fused_projected_attention(x, x, *w, *w, *w, H)
    with pytest.raises(ValueError):
        fused_attention_block(x, torch.ones((B, 2, T), device="meta"),
                              torch.zeros((B, 2, 1, D), device="meta"),
                              torch.zeros((B, 2, 1, D), device="meta"),
                              port.block_weights(), H)


# --- text stack -----------------------------------------------------------------


def _tokens():
    from hig_tpu_torch.models.tokenizer import tokenize

    return tokenize(["A person is hugging the other person.", "A person is kicked.",
                     "Two people shake hands."]).astype(np.int64)


def test_clip_tower(tree):
    sub = tree["text"]["clip"]
    tok = _tokens()
    want = jt.ClipTextTower(JAX_CLIP).apply({"params": sub}, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        close(load_flax_tree(tt.ClipTextTower(TINY.clip), sub)(t_(tok)), want)


def test_post_ln_encoder_layer(tree):
    sub = tree["text"]["text_blocks_0"]
    x = rand(3, 11, 16, seed=18)
    want = jt.PostLNEncoderLayer(16, 2, 32).apply({"params": sub}, jnp.asarray(x))
    with torch.no_grad():
        close(load_flax_tree(tt.PostLNEncoderLayer(16, 2, 32), sub)(t_(x)), want)


def test_text_encoder(tree):
    sub = tree["text"]
    tok = _tokens()
    jenc = jt.TextEncoder(clip_config=JAX_CLIP, text_latent_dim=16, text_ff_size=32,
                          text_num_heads=2, num_text_layers=1, time_embed_dim=E)
    want_proj, want_out = jenc.apply({"params": sub}, jnp.asarray(tok, jnp.int32))
    port = load_flax_tree(
        tt.TextEncoder(TINY.clip, 16, 32, 2, 1, E), sub)
    with torch.no_grad():
        proj, out = port(t_(tok))
    close(proj, want_proj)
    close(out, want_out)


# --- decoding -----------------------------------------------------------------


@pytest.mark.parametrize("init_last", [True, False])
def test_recover_from_ric2(init_last):
    from hig_tpu.utils.motion_codec import recover_from_ric2 as jrec
    from hig_tpu_torch.utils.motion_codec import recover_from_ric2 as trec

    d1, d2 = rand(3, 10, 263, seed=19, scale=0.3), rand(3, 10, 263, seed=20, scale=0.3)
    w1, w2 = jrec(jnp.asarray(d1), jnp.asarray(d2), 22, init_last=init_last)
    g1, g2 = trec(t_(d1), t_(d2), 22, init_last=init_last)
    assert tuple(g1.shape) == (3, 9, 22, 3)
    close(g1, w1, atol=1e-5)
    close(g2, w2, atol=1e-5)


def test_quaternions():
    from hig_tpu.utils import quaternions as jq
    from hig_tpu_torch.utils import quaternions as tq

    qs, v = rand(5, 4, seed=21), rand(5, 7, 3, seed=22)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    close(tq.qinv(t_(qs)), jq.qinv(jnp.asarray(qs)), atol=0)
    close(tq.qrot(t_(qs)[:, None], t_(v)), jq.qrot(jnp.asarray(qs)[:, None], jnp.asarray(v)))
