"""Parity of the port's legacy Guo-et-al protocol with hig_tpu on the CPU.

- The word vectorizer: POS tables, VIP overrides and the hash fallback's
  vectors equal to JAX's bit for bit, the GloVe files' layout, and
  ``vectorize_tokens``'s padding.
- Every legacy model against flax through the weight bridge
  (``weights.load_legacy_tree``), within 1e-5 of the largest magnitude:
  the BiGRU encoders at ragged lengths (the backward direction reversed
  within each length), the motion-length estimator, the attention layer,
  the movement convolution encoder and decoder, and one step of each VAE
  decoder (``TextDecoder`` with JAX's draw fed in); the small functions.
- ``CoEmbeddingEvaluator`` with JAX's parameter trees: the text and motion
  co-embeddings within 1e-5, and the matching score and R-precision of
  ``evaluate_matching_and_r_precision`` equal to JAX's on the same
  embeddings.

Small widths, ``torch.set_num_threads(1)``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.data import word_vectorizer as JW
from hig_tpu.eval import legacy_protocol as JP
from hig_tpu.models import legacy_evaluators as JL
from hig_tpu_torch.data import word_vectorizer as TW
from hig_tpu_torch.eval import legacy_protocol as TP
from hig_tpu_torch.models import legacy_evaluators as TL
from hig_tpu_torch.weights import load_legacy_tree

TOL = 1e-5
TOKENS = [["walk/VERB", "left/ADV"], ["a/DET", "person/NOUN", "jumps/VERB", "slowly/ADV"],
          ["ball/NOUN"], ["run/VERB"] * 8, ["two/NUM", "arm/NOUN"]]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_word_vectorizer_equals_jax(tmp_path):
    assert TW.POS_ENUMERATOR == JW.POS_ENUMERATOR and TW.VIP_DICT == JW.VIP_DICT
    for wv_j, wv_t in ((JW.WordVectorizer(), TW.WordVectorizer()),):
        for tok in ["walk/VERB", "the/DET", "left/ADP", "zzz/NOUN", "sos/OTHER", "x/PROPN"]:
            (a, b), (c, d) = wv_j[tok], wv_t[tok]
            assert np.array_equal(a, c) and np.array_equal(b, d), tok
    # the GloVe files' layout, with an out-of-vocabulary word
    np.save(tmp_path / "v_data.npy", rand(3, 300, seed=1))
    with open(tmp_path / "v_words.pkl", "wb") as f:
        pickle.dump(["walk", "unk", "chair"], f)
    with open(tmp_path / "v_idx.pkl", "wb") as f:
        pickle.dump({"walk": 0, "unk": 1, "chair": 2}, f)
    wv_j, wv_t = JW.WordVectorizer(str(tmp_path), "v"), TW.WordVectorizer(str(tmp_path), "v")
    assert len(wv_t) == len(wv_j) == 3
    for tok in ["walk/VERB", "chair/NOUN", "moon/NOUN"]:
        (a, b), (c, d) = wv_j[tok], wv_t[tok]
        assert np.array_equal(a, c) and np.array_equal(b, d), tok
    for toks in TOKENS:
        for got, want in zip(TP.vectorize_tokens(toks, 6, TW.WordVectorizer()),
                             JP.vectorize_tokens(toks, 6, JW.WordVectorizer())):
            assert np.array_equal(got, want)


def test_small_functions_match_jax():
    a, b = rand(4, 6, seed=1), rand(4, 6, seed=2)
    label = np.array([0, 1, 0, 1], np.float32)
    close(TL.contrastive_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(label)),
          JL.contrastive_loss(a, b, label))
    close(TL.positional_encoding_table(8, 50), JL.positional_encoding_table(8, 50))
    key = jax.random.key(3)
    noise = np.asarray(jax.random.normal(key, (4, 6), jnp.float32))
    close(TL.reparameterize(torch.from_numpy(a), torch.from_numpy(b * 0.1),
                            torch.from_numpy(noise)),
          JL.reparameterize(key, jnp.asarray(a), jnp.asarray(b * 0.1)))
    x, lengths = rand(3, 5, 2, seed=4), np.array([5, 3, 1])
    close(TL._flip_valid(torch.from_numpy(x), torch.from_numpy(lengths)),
          JL._flip_valid(jnp.asarray(x), jnp.asarray(lengths)))


def flax_init(module, *args, method=None):
    return module.init(jax.random.key(1), *args, method=method)


def compare(jax_module, port_module, args, port_args=None, method=None):
    params = flax_init(jax_module, *args, method=method)
    load_legacy_tree(port_module, params)
    want = jax.tree_util.tree_leaves(jax_module.apply(params, *args, method=method))
    got = port_module(*(port_args or [torch.from_numpy(np.asarray(a)) for a in args]))
    got = jax.tree_util.tree_leaves(got if isinstance(got, tuple) else (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


TEXT = (rand(3, 6, 8, seed=1), rand(3, 6, 5, seed=2), np.array([6, 3, 1]))


@pytest.mark.parametrize("model", ["text_bigru", "text_bigru_co", "motion_bigru_co",
                                   "length_estimator", "att", "conv_encoder", "conv_decoder"])
def test_legacy_models_match_flax(model):
    if model == "text_bigru":
        compare(JL.TextEncoderBiGRU(word_size=8, pos_size=5, hidden_size=7),
                TL.TextEncoderBiGRU(8, 5, 7), TEXT)
    elif model == "text_bigru_co":
        compare(JL.TextEncoderBiGRUCo(word_size=8, pos_size=5, hidden_size=7, output_size=4),
                TL.TextEncoderBiGRUCo(8, 5, 7, 4), TEXT)
    elif model == "motion_bigru_co":
        compare(JL.MotionEncoderBiGRUCo(input_size=6, hidden_size=7, output_size=4),
                TL.MotionEncoderBiGRUCo(6, 7, 4), (rand(3, 5, 6, seed=3), np.array([5, 2, 4])))
    elif model == "length_estimator":
        compare(JL.MotionLenEstimatorBiGRU(word_size=8, pos_size=5, hidden_size=7,
                                           output_size=4),
                TL.MotionLenEstimatorBiGRU(8, 5, 7, 4), TEXT)
    elif model == "att":
        compare(JL.AttLayer(value_dim=4), TL.AttLayer(6, 5, 4),
                (rand(3, 6, seed=4), rand(3, 7, 5, seed=5)))
    elif model == "conv_encoder":
        compare(JL.MovementConvEncoder(hidden_size=6, output_size=4),
                TL.MovementConvEncoder(5, 6, 4), (rand(2, 12, 5, seed=6),))
    else:
        compare(JL.MovementConvDecoder(hidden_size=6, output_size=4),
                TL.MovementConvDecoder(5, 6, 4), (rand(2, 5, 5, seed=7),))


@pytest.mark.parametrize("decoder", ["text_vae", "text"])
def test_vae_decoders_match_flax(decoder):
    latent, inputs = rand(2, 3, seed=1), rand(2, 5, seed=2)
    hidden = [rand(2, 6, seed=3 + i) for i in range(2)]
    widths = dict(text_size=3, input_size=5, output_size=4, hidden_size=6, n_layers=2)
    key = jax.random.key(5)
    if decoder == "text_vae":
        jm, tm, extra = JL.TextVAEDecoder(**widths), TL.TextVAEDecoder(3, 5, 4, 6, 2), ()
    else:
        jm, tm, extra = JL.TextDecoder(**widths), TL.TextDecoder(3, 5, 4, 6, 2), (key,)
    params = jm.init(jax.random.key(2), latent, inputs, hidden, 7, *extra,
                     method=lambda m, z, x, h, p, *e: (m.get_init_hidden(z), m(x, h, p, *e)))
    load_legacy_tree(tm, params)
    close(torch.cat(tm.get_init_hidden(torch.from_numpy(latent)), -1),
          jnp.concatenate(jm.apply(params, latent, method=jm.get_init_hidden), -1))
    want = jax.tree_util.tree_leaves(jm.apply(params, inputs, hidden, 7, *extra))
    port_hidden = [torch.from_numpy(h) for h in hidden]
    if decoder == "text":
        noise = np.asarray(jax.random.normal(key, (2, 4), jnp.float32))
        got = tm(torch.from_numpy(inputs), port_hidden, 7, noise=torch.from_numpy(noise))
    else:
        got = tm(torch.from_numpy(inputs), port_hidden, 7)
    got = jax.tree_util.tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


def test_co_embedding_pipeline_matches_jax():
    widths = dict(dim_pose=20, dim_movement_latent=8, dim_coemb_hidden=12, dim_out=6)
    je = JP.CoEmbeddingEvaluator(**widths, rng=jax.random.key(3))
    te = TP.CoEmbeddingEvaluator(**widths, device="cpu")
    te.load_params(je.movement_params, je.motion_params, je.text_params)
    wv = TW.WordVectorizer()
    n, T = 40, 16  # one batch of 32 scored, a ragged tail of 8 left out
    motions = rand(n, T, 20, seed=1)
    m_lens = np.random.RandomState(2).randint(4, T + 1, n)
    vecs = [TP.vectorize_tokens(TOKENS[i % len(TOKENS)], 6, wv) for i in range(n)]
    word_embs, pos_ohots = np.stack([v[0] for v in vecs]), np.stack([v[1] for v in vecs])
    cap_lens = np.array([v[2] for v in vecs])
    want_t, want_m = je.get_co_embeddings(motions, m_lens, word_embs, pos_ohots, cap_lens)
    got_t, got_m = te.get_co_embeddings(motions, m_lens, word_embs, pos_ohots, cap_lens)
    close(got_t, want_t)
    close(got_m, want_m)
    want_t, want_m = np.asarray(want_t), np.asarray(want_m)
    got = TP.evaluate_matching_and_r_precision(want_t, want_m)
    want = JP.evaluate_matching_and_r_precision(want_t, want_m)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert np.array_equal(got[1], want[1])
    # the reference's widths
    full = TP.CoEmbeddingEvaluator(dim_pose=263, device="cpu")
    assert full.text_enc.gru.hidden.shape == (2, 1, 1024)
    assert full.movement_enc.out_net.weight.shape == (512, 512)
    assert full.motion_enc.head.Dense_1.weight.shape == (512, 1024)
