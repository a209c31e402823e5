"""Parity of the PyTorch port's evaluation stack against hig_tpu on the CPU.

- The masked ``PostLNEncoderLayer`` (−inf on padded keys) and the unmasked
  one, within 2e-5 (``MODULE_TOL``).
- Both evaluator models through the weight bridge: logits and the pooled
  embedding within 2e-5; the bridge's shapes equal JAX's ``init`` and a
  JAX-init tree loads with ``strict=True``.
- Two Adam steps of each evaluator's training step against optax's, every
  parameter within 1e-5 of its leaf's largest magnitude.
- ``PairDataset(train_eval / eval_mode)`` and ``PairMismatchDataset``
  items and batches bitwise equal to JAX's.
- The metric functions equal JAX's; ``generate_test_set`` with a replayed
  sampler; ``evaluate_once`` and ``summarize`` on one generated set through
  JAX's embedder and the port's with the same weights and rng seed, within
  1e-4 relative (an argmax may differ only where its logit margin is below
  1e-5).
- The CLIs on the CPU at tiny widths: ``eval.train`` (both kinds),
  ``eval.test`` (both kinds) and ``evaluate --sampler ddim --ddim_steps 2``
  through to ``summary0.json``.

Tiny widths and ``torch.set_num_threads(1)``; data is seeded random
features in the reference's layout, two clips per class.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.config import add_dataset_paths as jax_add_paths
from hig_tpu.data import dataset as jd
from hig_tpu.eval import evaluator as jev
from hig_tpu.eval import metrics as jm
from hig_tpu.models import eval_models as jem
from hig_tpu.models.text_encoder import PostLNEncoderLayer as JaxPostLN
from hig_tpu.train import eval_trainer as jet
from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths
from hig_tpu_torch.data import dataset as td
from hig_tpu_torch.data.vocab import CLASSID2CAPS
from hig_tpu_torch.eval import evaluator as tev
from hig_tpu_torch.eval import metrics as tm
from hig_tpu_torch.eval.trainer import make_eval_train_step
from hig_tpu_torch.evaluate import eval_samples
from hig_tpu_torch.models.eval_models import EvalModelConfig, eval_model
from hig_tpu_torch.models.text_encoder import PostLNEncoderLayer
from hig_tpu_torch.weights import (
    flatten,
    flax_param_shapes,
    load_flax_tree,
    random_flax_tree,
    torch_state_from_flax,
)
from tests.test_torch_pipeline import MODULE_TOL, TINY, rand, t_

EVAL_TINY = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4)
B, T, D_IN = 4, 16, 259
LENGTHS = np.array([16, 9, 12, 5], np.int32)
KINDS = {"classifier": (jem.MotionEncoder, 26), "consistency": (jem.MotionConsistencyEvalModel, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def eval_models(kind, num_layers=2):
    """(JAX model, its params, the port's model) with the same random
    weights, every leaf nonzero (out1 / out2 included)."""
    cls, n = KINDS[kind]
    widths = dict(EVAL_TINY, num_layers=num_layers)
    cfg = EvalModelConfig(kind=kind, class_num=n, **widths)
    tree = random_flax_tree(cfg, seed=0)
    port = load_flax_tree(eval_model(cfg), tree["params"]).eval()
    return cls(class_num=n, **widths), jax.tree_util.tree_map(jnp.asarray, tree), port


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_post_ln_encoder_layer_matches_jax(masked):
    layer = JaxPostLN(32, 4, 64)
    tree = random_flax_tree(EvalModelConfig(**EVAL_TINY), 1)["params"]["block_0"]
    port = load_flax_tree(PostLNEncoderLayer(32, 4, 64), tree)
    x = rand(B, 2 * T, 32, seed=2)
    mask = (np.arange(2 * T) < 2 * LENGTHS[:, None]).astype(np.float32) if masked else None
    key_mask = None if mask is None else jnp.asarray(mask)
    want = jax.jit(layer.apply)({"params": jax.tree_util.tree_map(jnp.asarray, tree)},
                                jnp.asarray(x), key_mask=key_mask)
    with torch.no_grad():
        got = port(t_(x), None if mask is None else t_(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_TOL, rtol=0)
    if masked:  # padded keys take no weight: changing them changes nothing
        x2 = x.copy()
        x2[0, 2 * LENGTHS[0]:] += 5.0
        with torch.no_grad():
            again = port(t_(x2), t_(mask))
        np.testing.assert_allclose(again[0, :2 * LENGTHS[0]].numpy(),
                                   got[0, :2 * LENGTHS[0]].numpy(), atol=1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_eval_models_match_jax(kind):
    jmodel, params, port = eval_models(kind)
    x = rand(B, 2, T, D_IN, seed=3)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(LENGTHS))
    with torch.no_grad():
        got = port(t_(x), t_(LENGTHS).long())
    if kind == "classifier":
        (logits, pooled), (want_logits, want_pooled) = got, want
        assert pooled.shape == (B, 32)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=MODULE_TOL,
                                   rtol=0)
    else:
        logits, want_logits = got, want
    assert logits.shape == (B, KINDS[kind][1])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=MODULE_TOL, rtol=0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_eval_bridge_shapes_equal_jax_init(kind):
    cls, n = KINDS[kind]
    shapes = jax.eval_shape(cls(class_num=n, **EVAL_TINY).init, jax.random.key(0),
                            jnp.zeros((1, 2, 91, D_IN)), jnp.full((1,), 91, jnp.int32))
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree_util.tree_map(
        lambda a: a, dict(shapes), is_leaf=lambda a: hasattr(a, "shape"))).items()}
    cfg = EvalModelConfig(kind=kind, class_num=n, **EVAL_TINY)
    assert {k: tuple(v) for k, v in flatten(flax_param_shapes(cfg)).items()} == want
    init = jax.jit(cls(class_num=n, **EVAL_TINY).init)(
        jax.random.key(0), jnp.zeros((1, 2, 91, D_IN)), jnp.full((1,), 91, jnp.int32))
    load_flax_tree(eval_model(cfg), jax.tree_util.tree_map(np.asarray, init)["params"])
    leaves = flatten(random_flax_tree(cfg, 0)["params"])
    assert all((v != 0).any() for v in leaves.values())


@pytest.mark.parametrize("kind", list(KINDS))
def test_eval_train_steps_match_optax(kind):
    """Two Adam steps on one batch each (lr 2e-4, /5 for consistency)."""
    jmodel, params, port = eval_models(kind)
    lr = 2e-4 if kind == "classifier" else 2e-4 / 5
    tx = optax.adam(lr)
    make = jet.make_classifier_step if kind == "classifier" else jet.make_consistency_step
    jstep = make(jmodel, tx)
    state = jet.EvalTrainState(params=params, opt_state=tx.init(params),
                               step=jnp.zeros((), jnp.int32))
    port.train()
    step = make_eval_train_step(port, torch.optim.Adam(port.parameters(), lr=lr,
                                                       betas=(0.9, 0.999), eps=1e-8))
    n = KINDS[kind][1]
    for i in range(2):
        x = rand(B, 2, T, D_IN, seed=10 + i)
        labels = np.random.RandomState(i).randint(0, n, B).astype(np.int32)
        state, jmetrics = jstep(state, jnp.asarray(x), jnp.asarray(LENGTHS), jnp.asarray(labels))
        metrics = step(t_(x), t_(LENGTHS).long(), t_(labels).long())
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5
        assert float(metrics["acc"]) == float(jmetrics["acc"])
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    got = port.state_dict()
    assert got.keys() == want.keys()
    D = EVAL_TINY["latent_dim"]
    for name, w in want.items():
        g = got[name]
        if name.endswith(".in_proj.bias"):
            # the key bias's exact gradient is 0 (a softmax over the keys
            # ignores a constant added to every key); Adam scales each
            # package's rounding noise there up to a step of about lr
            key = slice(D, 2 * D)
            assert float((g[key] - w[key]).abs().max()) <= 6 * lr, name
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


# --- data ------------------------------------------------------------------------------


def write_eval_dataset(root, seed=0):
    """Two clips per class of 40 to 130 frames of seeded random features in
    the reference's layout: train_sub.txt / val_sub.txt / test_sub.txt all
    hold the 52 clips; a 0/1 label file; Mean/Std."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    names = []
    for i in range(2 * len(CLASSID2CAPS)):
        name = f"E{i:03d}"
        frames = rs.randint(40, 131)
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"),
                rs.randn(2, frames + 1, 263).astype(np.float32))
        c1, c2 = CLASSID2CAPS[i % len(CLASSID2CAPS)]
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write(f"{c1}_{c2}#none#0.0#0.0\n{c1}_{c2}#none#0.0#0.0\n")
        names.append(name)
    for split in ("train_sub.txt", "val_sub.txt", "test_sub.txt"):
        with open(os.path.join(root, split), "w") as f:
            f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump({n: int(rs.randint(2)) for n in names}, f)
    np.save(os.path.join(root, "Mean.npy"), (0.1 * rs.randn(267)).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), (1 + 0.1 * rs.rand(267)).astype(np.float32))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval") / "data")
    write_eval_dataset(root)
    return root


def configs(root):
    kw = dict(dataset_name="synthetic_mul", data_root=root)
    mean, std = np.load(os.path.join(root, "Mean.npy")), np.load(os.path.join(root, "Std.npy"))
    return jax_add_paths(JaxConfig(**kw)), add_dataset_paths(ExperimentConfig(**kw)), mean, std


@pytest.mark.parametrize("flavor", ["train_eval", "eval_mode", "mismatch"])
def test_eval_datasets_match_jax(data_root, flavor):
    jcfg, cfg, mean, std = configs(data_root)
    labels = os.path.join(data_root, "labels.json")
    if flavor == "mismatch":
        jds = jd.PairMismatchDataset(jcfg, mean, std, "train_sub.txt")
        ds = td.PairMismatchDataset(cfg, mean, std, "train_sub.txt")
    else:
        kw = {flavor: True, "label_path": labels}
        jds = jd.PairDataset(jcfg, mean, std, "test_sub.txt", **kw)
        ds = td.PairDataset(cfg, mean, std, "test_sub.txt", **kw)
    for epoch in (1, 2):
        for item in range(len(ds)):
            want, got = jds.__getitem__(item, epoch), ds.__getitem__(item, epoch)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    if flavor == "mismatch":
        assert {ds[i]["dummy_label"] for i in range(len(ds))} == {0, 1}
    else:
        assert not any(ds[i]["swapped"] for i in range(len(ds)))
    want = next(jd.epoch_batches(jds, 32, 1, shuffle=False, drop_last=False,
                                 process_index=0, process_count=1))
    got = next(td.epoch_batches(ds, 32, 1, shuffle=False, drop_last=False))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# --- metrics and the harness -----------------------------------------------------------


def test_metric_functions_equal_jax():
    a, b = rand(40, 8, seed=1), rand(40, 8, seed=2) + 0.3
    np.testing.assert_array_equal(tm.euclidean_distance_matrix(a, b),
                                  jm.euclidean_distance_matrix(a, b))
    for k in (1, 3):
        np.testing.assert_array_equal(tm.calculate_R_precision(a, b, k, sum_all=True),
                                      jm.calculate_R_precision(a, b, k, sum_all=True))
    np.testing.assert_array_equal(tm.calculate_matching_score(a, b),
                                  jm.calculate_matching_score(a, b))
    assert tm.fid_from_activations(a, b) == jm.fid_from_activations(a, b)
    assert tm.calculate_diversity(a, 30, np.random.default_rng(3)) == jm.calculate_diversity(
        a, 30, np.random.default_rng(3))
    stack = rand(5, 12, 8, seed=4)
    assert tm.calculate_multimodality(stack, 7, np.random.default_rng(5)) == \
        jm.calculate_multimodality(stack, 7, np.random.default_rng(5))
    values = rand(6, 3, seed=6)
    for x, y in zip(tm.get_metric_statistics(values, 6), jm.get_metric_statistics(values, 6)):
        np.testing.assert_array_equal(x, y)
    mu1, s1 = jm.calculate_activation_statistics(a)
    mu2, s2 = jm.calculate_activation_statistics(b)
    dev = tm.frechet_distance_device(*(torch.from_numpy(v) for v in (mu1, s1, mu2, s2)))
    assert abs(float(dev) - jm.calculate_frechet_distance(mu1, s1, mu2, s2)) <= 1e-6 * float(dev)
    with pytest.raises(ValueError, match="more than 40"):
        tm.calculate_diversity(a, 40)


def eval_set(root):
    """The 52 test clips as evaluation samples (normalized, init row first)
    with their first caption pair."""
    _, cfg, mean, std = configs(root)
    samples = eval_samples(td.PairDataset(cfg, mean, std, "test_sub.txt", eval_mode=True),
                           mean, std)
    for s in samples:
        s.update(caption1=s["texts"][0][0], caption2=s["texts"][0][1])
    return samples


def fake_samplers(T_gen):
    """A JAX sample_fn whose output is a function of the chunk's key (seeded
    numpy from the key's data), and the port's, handed that output as its
    initial noise."""
    def key_motions(rng, b):
        seed = int(np.asarray(jax.random.key_data(rng)).astype(np.uint64).sum() % (2 ** 31))
        return rand(b, 2, T_gen, 263, seed=seed)

    def jsample(params, tokens, lengths, rng):
        return key_motions(rng, tokens.shape[0])

    def tsample(cond, lengths, noise=None, **kwargs):
        return noise

    return key_motions, jsample, tsample


def test_generate_test_set_matches_jax(data_root):
    samples, T_gen = eval_set(data_root), 24
    key_motions, jsample, tsample = fake_samplers(T_gen)
    rng = jax.random.key(0)
    tokens_of = lambda s: np.asarray([s["class_id"], s["class_id"]], np.int32)  # noqa: E731
    want = jev.generate_test_set(jsample, None, samples, tokens_of, T_gen, rng, batch_size=20,
                                 mm_num_repeats=1)
    subs, r = [], rng
    for _ in range(3):
        r, sub = jax.random.split(r)
        subs.append(sub)
    got = tev.generate_test_set(tsample, samples, tokens_of, T_gen, "cpu", batch_size=20,
                                mm_num_repeats=1,
                                draws=lambda c, b: {"noise": t_(key_motions(subs[c], b))})
    for g_items, w_items in [(got.motions, want.motions)] + [
            (got.mm_groups[c], want.mm_groups[c]) for c in want.mm_groups] + [
            (got.gt_mm_groups[c], want.gt_mm_groups[c]) for c in want.gt_mm_groups]:
        assert len(g_items) == len(w_items)
        for g_it, w_it in zip(g_items, w_items):
            assert (g_it["length"], g_it["class_id"]) == (w_it["length"], w_it["class_id"])
            np.testing.assert_array_equal(g_it["motion"], np.asarray(w_it["motion"]))
    assert got.mm_groups.keys() == want.mm_groups.keys()
    assert all(len(v) == 2 for v in got.mm_groups.values())


def test_evaluate_once_and_summarize_match_jax(data_root):
    samples, T_gen = eval_set(data_root), 100
    _, _, tsample = fake_samplers(T_gen)
    gt_items = [dict(motion=s["motion"], length=s["length"], class_id=s["class_id"])
                for s in samples]
    tokens_of = lambda s: np.zeros(2, np.int32)  # noqa: E731
    gen = tev.generate_test_set(tsample, samples, tokens_of, T_gen, "cpu",
                                draws=lambda c, b: {"noise": t_(rand(b, 2, T_gen, 263, seed=c))})
    # MultiModality over 2 classes keeps the test cheap: each group is a
    # padded batch of 32 pairs through both models
    for groups in (gen.mm_groups, gen.gt_mm_groups):
        for c in list(groups)[2:]:
            del groups[c]
    jgen = jev.GeneratedSet(gen.motions, gen.mm_groups, gen.gt_mm_groups)
    (jenc, enc_params, enc), (jcons, cons_params, cons) = (eval_models("classifier", 1),
                                                            eval_models("consistency", 1))
    jembed = jev.make_embedder(jenc, enc_params, jcons, cons_params)
    embed = tev.make_embedder(enc, cons)
    reps, jreps = [], []
    for rep in range(2):
        kw = dict(mm_num_times=1)
        reps.append(tev.evaluate_once(embed, gt_items, gen, np.random.default_rng(rep), **kw))
        jreps.append(jev.evaluate_once(jembed, gt_items, jgen, np.random.default_rng(rep), **kw))
    # an argmax may differ only where the two top logits are within 1e-5
    jl, _, jc = jev._batched_embeddings(jembed, gen.motions, np.random.default_rng(9))
    tl, _, tc = tev._batched_embeddings(embed, gen.motions, np.random.default_rng(9))
    for want_logits, got_logits in ((jl, tl), (jc, tc)):
        top2 = np.sort(want_logits, axis=-1)[:, -2:]
        differ = want_logits.argmax(-1) != got_logits.argmax(-1)
        assert (top2[differ, 1] - top2[differ, 0] < 1e-5).all()
    for got, want in zip(reps, jreps):
        assert [k for k in got] == [k for k in want]
        for metric in want:
            if metric == "_confusion":
                continue
            for model in want[metric]:
                g_v, w_v = got[metric][model], want[metric][model]
                assert abs(g_v - w_v) <= 1e-4 * max(abs(w_v), 1e-3), (metric, model, g_v, w_v)
        assert got["_confusion"]["text2motion"].sum() == len(samples)
    got, want = tev.summarize(reps, 2), jev.summarize(jreps, 2)
    assert list(got) == list(want) == ["Acc", "Consistency", "FID", "Diversity", "MultiModality"]
    for metric in want:
        for model in want[metric]:
            np.testing.assert_allclose(got[metric][model], want[metric][model], rtol=1e-4,
                                       atol=1e-6)


# --- the CLIs ----------------------------------------------------------------------------


def test_eval_clis(data_root, tmp_path):
    """eval.train (both kinds, one epoch), eval.test (both kinds), then
    evaluate with a tiny caption-id generator, DDIM-2, through to
    summary0.json."""
    from hig_tpu_torch import evaluate
    from hig_tpu_torch.eval import test as eval_test
    from hig_tpu_torch.eval import train as eval_train
    from hig_tpu_torch.train.__main__ import main as train_main

    ckpts = str(tmp_path / "runs")
    common = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", data_root,
              "--checkpoints_dir", ckpts, "--batch_size", "26"]
    widths = []
    for k, v in TINY.items():
        widths += [f"--{k}", str(v)]
    for kind, name in (("classifier", "eval_model"), ("consistency", "consistency_eval_model")):
        _, _, best, history = eval_train.main(["--kind", kind, "--name", name, "--num_epochs",
                                               "2"] + common + widths)
        assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
        assert os.path.exists(os.path.join(ckpts, "synthetic_mul", name, "model",
                                           "best_eval_model.pt"))
        acc, cm = eval_test.main(["--kind", kind, "--device", "cpu", "--opt_path",
                                  os.path.join(ckpts, "synthetic_mul", name, "opt.txt")])
        assert 0.0 <= acc <= 1.0
        assert cm is None or cm.sum() == 52
    train_main(common + widths + ["--name", "gen", "--cap_id", "--num_epochs", "1",
                                  "--result_path", str(tmp_path / "result")])
    out = evaluate.main(["--opt_path", os.path.join(ckpts, "synthetic_mul", "gen", "opt.txt"),
                         "--device", "cpu", "--sampler", "ddim", "--ddim_steps", "2",
                         "--replication_times", "2"])
    save_dir = tmp_path / "result" / "gen" / "latest"
    assert out["save_dir"] == str(save_dir)
    summary = json.load(open(save_dir / "summary0.json"))
    assert list(summary) == ["Acc", "Consistency", "FID", "Diversity", "MultiModality"]
    for metric, models in summary.items():
        assert set(models) == {"ground truth", "text2motion"}
        assert all(np.isfinite(v).all() for v in models.values())
    for rep in range(2):
        assert np.load(save_dir / f"confusion_matrix0_rep{rep}.npy").sum() == 52
    # --fast_ln runs: the same checkpoint evaluated as a bfloat16 run with
    # bf16 LayerNorm statistics (the efficient blocks' norms)
    opt = os.path.join(ckpts, "synthetic_mul", "gen", "opt.txt")
    text = open(opt).read()
    assert "compute_dtype: float32\n" in text
    bf16_opt = str(tmp_path / "gen_bf16_opt.txt")
    with open(bf16_opt, "w") as f:
        f.write(text.replace("compute_dtype: float32\n", "compute_dtype: bfloat16\n"))
    out = evaluate.main(["--opt_path", bf16_opt, "--device", "cpu", "--fast_ln",
                         "--sampler", "ddim", "--ddim_steps", "2", "--file_id", "fast_ln"])
    summary = json.load(open(save_dir / "summaryfast_ln.json"))
    assert all(np.isfinite(v).all() for models in summary.values() for v in models.values())
    assert np.load(save_dir / "confusion_matrixfast_ln_rep0.npy").sum() == 52


@pytest.mark.parametrize("cli", ["eval.train", "eval.test", "evaluate"])
def test_eval_clis_refuse_cuda_without_a_card(cli, tmp_path):
    """The entry points run on cuda unless --device cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from hig_tpu_torch import evaluate
    from hig_tpu_torch.config import save_opt_txt
    from hig_tpu_torch.eval import test as eval_test
    from hig_tpu_torch.eval import train as eval_train

    opt = str(tmp_path / "opt.txt")
    save_opt_txt(ExperimentConfig(checkpoints_dir=str(tmp_path)), opt)
    argv = {"eval.train": (eval_train.main, ["--kind", "classifier", "--checkpoints_dir",
                                             str(tmp_path)]),
            "eval.test": (eval_test.main, ["--kind", "classifier", "--opt_path", opt]),
            "evaluate": (evaluate.main, ["--opt_path", opt])}[cli]
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        argv[0](argv[1])
