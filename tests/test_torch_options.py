"""The single-chip options of a JAX run that the port carries since the
causal slice, against hig_tpu on the CPU at tiny widths:

- the native batch loader (``--use_native_loader``, ``--window_size``):
  the port's own binding, built with g++ into ``hig_tpu_torch/_build/``;
  ``Trainer._native_epoch_batches`` against JAX's bit for bit (motion,
  lengths, tokens, caption ids, names) at windows 90 and 60, with
  pseudo-label swaps, over clips shorter and longer than the window; the
  same batch from 1 and 8 threads; a failed build raising with g++'s
  output; JAX's rule that a clip with several captions keeps the Python
  loader; and JAX's quirk that the Python loader windows 90 frames
  whatever ``window_size`` says, in both packages;
- ``--pretrained``: a state dict with the reference's key names through
  the port's ``convert_interaction_model`` and ``load_into``, against JAX's
  ``convert_interaction_model`` + ``merge_params`` carried through the
  weight bridge, exactly, for the full model, ``only_language``,
  ``only_motion``, ``cap_id`` and ``--no_cross_attn``; the train CLI's
  ``--pretrained`` (the load comes before ``--is_continue``, the EMA keeps
  its initialized copy, as in JAX);
- ``python -m hig_tpu_torch.add_cfg_branch``: the graft's leaves, EMA,
  fresh Adam, kept counters, copied statistics and opt.txt; its refusals;
  unguided DDIM sampling of the graft equal to the donor's bit for bit;
  then ``train --is_continue --cond_drop_prob`` from it;
- ``serve --which_epoch``.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.config import add_dataset_paths as jax_add_paths
from hig_tpu.data import dataset as jd
from hig_tpu.train import torch_port as jtp
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig, add_dataset_paths
from hig_tpu_torch.data import dataset as td
from hig_tpu_torch.data import native_loader as nl
from hig_tpu_torch.data.vocab import CLASSID2CAPS
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.ops._build import BUILD_DIR
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train import torch_port as ttp
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree, torch_state_from_flax
from tests.test_torch_pipeline import TINY
from tests.test_torch_port import TestFullModelConversion

FEATS = 263
NATIVE_BATCH = 4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_clips(root, rows, seed=0, two_captions=()):
    """Clips of ``rows`` rows of seeded random features in the reference's
    layout, one caption line each (two for the indices in
    ``two_captions``), all in train_sub.txt; seeded 0/1 pseudo-labels."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    names = []
    for i, n in enumerate(rows):
        name = f"C{i:03d}"
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"),
                rs.randn(2, n, FEATS).astype(np.float32))
        c1, c2 = CLASSID2CAPS[i % len(CLASSID2CAPS)]
        lines = [f"{c1}_{c2}#none#0.0#0.0"]
        if i in two_captions:
            c3, c4 = CLASSID2CAPS[(i + 1) % len(CLASSID2CAPS)]
            lines.append(f"{c3}_{c4}#none#0.0#0.0")
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        names.append(name)
    with open(os.path.join(root, "train_sub.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump({n: int(rs.randint(2)) for n in names}, f)
    mean = rs.randn(FEATS + 4).astype(np.float32)
    np.save(os.path.join(root, "Mean.npy"), mean)
    np.save(os.path.join(root, "Std.npy"), (1.0 + rs.rand(FEATS + 4)).astype(np.float32))


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    """14 clips of 40 to 130 rows: some shorter than a 60- or 90-frame
    window (the padded path), some longer (the random shift)."""
    root = str(tmp_path_factory.mktemp("native") / "data")
    write_clips(root, [40, 130, 61, 95, 120, 70, 91, 100, 55, 128, 85, 110, 66, 99])
    return root


def both_datasets(root, window_size, times=2, labels=True):
    kw = dict(dataset_name="synthetic_mul", data_root=root, window_size=window_size,
              batch_size=NATIVE_BATCH, use_native_loader=True)
    jcfg, cfg = jax_add_paths(JaxConfig(**kw)), add_dataset_paths(ExperimentConfig(**kw))
    mean = np.load(os.path.join(root, "Mean.npy"))
    std = np.load(os.path.join(root, "Std.npy"))
    label_path = os.path.join(root, "labels.json") if labels else None
    return (jd.PairDataset(jcfg, mean, std, "train_sub.txt", times=times,
                           label_path=label_path, seed=3),
            td.PairDataset(cfg, mean, std, "train_sub.txt", times=times,
                           label_path=label_path, seed=3), jcfg, cfg)


# --- the native loader ---------------------------------------------------------------


@pytest.mark.parametrize("window_size", [90, 60])
def test_native_batches_equal_jaxs(clip_root, window_size):
    jds, ds, jcfg, cfg = both_datasets(clip_root, window_size)
    jtrainer = types.SimpleNamespace(cfg=jcfg, _native_store=None)
    trainer = tt.Trainer(cfg, "cpu")
    assert any(ds.labels.values()) and not all(ds.labels.values())
    for epoch in (0, 1):
        want = list(jt.Trainer._native_epoch_batches(jtrainer, jds, NATIVE_BATCH, epoch, 5))
        got = list(trainer._native_epoch_batches(ds, NATIVE_BATCH, epoch, 5))
        assert len(got) == len(want) == (2 * 14) // NATIVE_BATCH
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert g["motion"].shape == (NATIVE_BATCH, 2, window_size + 1, FEATS)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
    assert os.path.dirname(nl.library_path()) == BUILD_DIR
    assert os.path.exists(nl.library_path())


def test_native_batches_do_not_depend_on_threads(clip_root):
    _, ds, _, _ = both_datasets(clip_root, 60)
    store, swaps = nl.store_from_dataset(ds)
    assert len(store) == 14 and swaps.any()
    idx = np.arange(14)[::-1] % 14
    one = store.sample_batch(idx, window=60, seed=2, epoch=4, swap_flags=swaps[idx],
                             num_threads=1)
    eight = store.sample_batch(idx, window=60, seed=2, epoch=4, swap_flags=swaps[idx],
                               num_threads=8)
    for a, b in zip(one, eight):
        np.testing.assert_array_equal(a, b)
    other = store.sample_batch(idx, window=60, seed=2, epoch=5, swap_flags=swaps[idx])
    assert not np.array_equal(one[0], other[0])  # the shifts are the epoch's


def test_native_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "SOURCE", str(bad))
    monkeypatch.setattr(nl, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        nl.build()
    assert "error" in str(e.value)
    assert not os.listdir(tmp_path / "_build")


def test_python_loader_windows_90_frames_whatever_window_size(clip_root):
    """JAX's quirk, pinned: only the native loader reads window_size."""
    jds, ds, _, cfg = both_datasets(clip_root, 60)
    want = next(jd.epoch_batches(jds, NATIVE_BATCH, 0, seed=cfg.seed))
    got = next(td.epoch_batches(ds, NATIVE_BATCH, 0, seed=cfg.seed))
    assert got["motion"].shape[2] == want["motion"].shape[2] == td.WINDOW_FRAMES + 1 == 91
    cfg.use_native_loader = False
    python = tt.Trainer(cfg, "cpu").epoch_batches_fn(ds, {}, log=lambda _: None)
    np.testing.assert_array_equal(next(python(0))["motion"], got["motion"])


def test_trainer_takes_the_native_loader_at_its_window(clip_root, tmp_path):
    """A PIT run through the native loader at window 60 (T = 61) on the
    CPU; with a clip of two caption lines the run keeps the Python loader,
    JAX's rule."""
    said = []
    _, ds, _, cfg = both_datasets(clip_root, 60, times=1, labels=False)
    for k, v in TINY.items():
        setattr(cfg, k, v)
    cfg.checkpoints_dir, cfg.num_epochs, cfg.log_every, cfg.cap_id = str(tmp_path), 1, 1, True
    trainer = tt.Trainer(cfg, "cpu")
    state = trainer.train(ds, trainer.init_state(), log=said.append)
    assert "using native C++ batch loader" in said and state.step == 14 // NATIVE_BATCH
    lines = [json.loads(x) for x in open(os.path.join(cfg.save_root, "metrics.jsonl"))]
    assert len(lines) == 3 and all(np.isfinite(x["loss_mot_rec"]) for x in lines)
    batches = trainer.epoch_batches_fn(ds, {}, log=said.append)
    assert next(batches(0))["motion"].shape == (NATIVE_BATCH, 2, 61, FEATS)

    root = str(tmp_path / "two_captions")
    write_clips(root, [70, 95, 120, 99], two_captions=(2,))
    _, multi, _, mcfg = both_datasets(root, 60)
    said.clear()
    batches = tt.Trainer(mcfg, "cpu").epoch_batches_fn(multi, {}, log=said.append)
    assert next(batches(0))["motion"].shape[2] == 91
    assert said and "Python loader" in said[0]


# --- --pretrained --------------------------------------------------------------------

REF = dict(num_frames=32, latent_dim=16, ff_size=32, num_layers=2, num_heads=4,
           text_latent_dim=8, text_ff_size=16, text_num_heads=2, num_text_layers=1,
           clip=ClipTextConfig(width=16, heads=2, layers=2))
# case → (ModelConfig fields, convert_interaction_model's options)
PRETRAINED_CASES = {
    "full": ({}, {}),
    "only_language": ({}, dict(only_language=True)),
    "only_motion": ({}, dict(only_motion=True)),
    "cap_id": (dict(cap_id=True), dict(cap_id=True)),
    "no_cross_attn": (dict(interaction=False), dict(interaction=False)),
}


def reference_sd():
    """A state dict with the reference's key names (``tests/test_torch_port.py``'s
    synthetic one) and the caption table of a caption-id model."""
    sd = TestFullModelConversion()._fake_reference_sd()
    sd["cap_embedding"] = np.random.RandomState(1).randn(43, 8).astype(np.float32)
    return sd


@pytest.mark.parametrize("case", list(PRETRAINED_CASES))
def test_pretrained_transfer_equals_jaxs(case):
    fields, opts = PRETRAINED_CASES[case]
    mcfg = ModelConfig(**REF, **fields)
    tree = random_flax_tree(mcfg, seed=0)["params"]
    sd = reference_sd()
    kw = dict(num_layers=2, num_text_layers=1, clip_layers=2, **opts)
    want = jtp.merge_params(tree, jtp.convert_interaction_model(sd, **kw))
    model = load_flax_tree(InteractionModel(mcfg), tree)
    converted = ttp.convert_interaction_model(sd, **kw)
    loaded = ttp.load_into(model, converted)
    assert loaded == sorted(torch_state_from_flax(converted))
    got, ref = model.state_dict(), torch_state_from_flax(want)
    assert got.keys() == ref.keys()
    for name, w in ref.items():
        assert torch.equal(got[name], w), name
    init = torch_state_from_flax(tree)
    kept = [n for n in got if torch.equal(got[n], init[n])]
    if case == "only_language":
        assert all(n.startswith("denoiser.") for n in kept) and kept
    elif case == "only_motion":
        assert all(n.startswith("text.") for n in kept) and kept
    else:
        assert kept == []


def test_pretrained_refuses_a_leaf_without_a_parameter():
    """A reference interaction block in a --single_transformer model has no
    parameter to land on: refused before anything is copied."""
    model = InteractionModel(ModelConfig(**REF, single_transformer=True))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    converted = ttp.convert_interaction_model(reference_sd(), num_layers=2, num_text_layers=1,
                                              clip_layers=2)
    with pytest.raises(ValueError, match="int_ca_block"):
        ttp.load_into(model, converted)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def torch_reference_file(path, cap_id_widths):
    """The reference's ``latest.tar`` layout: {"encoder": state dict}."""
    sd = reference_sd()
    sd["sequence_embedding"] = np.random.RandomState(2).randn(196, 16).astype(np.float32)
    if cap_id_widths:
        sd = {k: v for k, v in sd.items() if not k.startswith(("clip.", "textTransEncoder",
                                                                 "text_pre_proj", "text_ln"))}
    torch.save({"encoder": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return sd


def ref_args():
    out = []
    for k, v in REF.items():
        if k not in ("clip", "num_frames"):
            out += [f"--{k}", str(v)]
    return out


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("options") / "data")
    write_clips(root, [101] * 12, seed=1)
    return root


def test_train_cli_pretrained_before_is_continue(pair_root, tmp_path, capsys):
    from hig_tpu_torch.train.__main__ import main as train_main

    path = str(tmp_path / "latest.tar")
    sd = torch_reference_file(path, cap_id_widths=True)
    common = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", pair_root,
              "--checkpoints_dir", str(tmp_path / "runs"), "--batch_size", "4", "--cap_id",
              "--log_every", "1", "--ema_decay", "0.9", "--pretrained", "--pretrained_path",
              path, "--name", "warm"] + ref_args()
    _, state = train_main(common + ["--num_epochs", "0"])
    assert f"loaded pretrained weights from {path}" in capsys.readouterr().out
    params = dict(state.model.named_parameters())
    assert torch.equal(params["text.cap_embedding"], torch.from_numpy(sd["cap_embedding"]))
    assert torch.equal(params["denoiser.out.weight"], torch.from_numpy(sd["out.weight"]))
    # the EMA keeps the initialized copy, as JAX's (init_state copies before the load)
    assert not torch.equal(state.ema["denoiser.out.weight"], params["denoiser.out.weight"])

    _, trained = train_main(common + ["--num_epochs", "1"])
    assert trained.step == 3
    _, resumed = train_main(common + ["--num_epochs", "1", "--is_continue"])
    assert resumed.step == 3  # restored after the load: the run's weights, no epoch left
    assert all(torch.equal(p, dict(trained.model.named_parameters())[n])
               for n, p in resumed.model.named_parameters())


# --- add_cfg_branch and serve --which_epoch ------------------------------------------


@pytest.fixture(scope="module")
def donor(pair_root, tmp_path_factory):
    """A supervised caption-id run (2 epochs, EMA) and its checkpoints."""
    from hig_tpu_torch.train.__main__ import main as train_main

    ckpts = str(tmp_path_factory.mktemp("graft") / "runs")
    common = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", pair_root,
              "--checkpoints_dir", ckpts, "--batch_size", "4", "--cap_id", "--log_every", "1",
              "--label_path", os.path.join(pair_root, "labels.json"), "--ema_decay", "0.9"]
    train_main(common + ref_args() + ["--name", "donor", "--num_epochs", "2"])
    return ckpts, common


def serve_run(tmp_path, opt, out, *extra):
    from hig_tpu_torch import serve

    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"caption1": CLASSID2CAPS[0][0], "caption2": CLASSID2CAPS[0][1],
                                "length": 20, "id": "a"}) + "\n")
    serve.main(["--requests", str(reqs), "--opt_path", opt, "--sampler", "ddim",
                "--ddim_steps", "3", "--device", "cpu", "--out_dir", str(tmp_path / out),
                *extra])
    return np.load(tmp_path / out / "a.npz")["features"]


def test_add_cfg_branch_grafts_the_donor(donor, tmp_path):
    from hig_tpu_torch import add_cfg_branch
    from hig_tpu_torch.train.__main__ import main as train_main

    ckpts, common = donor
    run = os.path.join(ckpts, "synthetic_mul", "donor")
    cfg = add_cfg_branch.main(["--opt_path", os.path.join(run, "opt.txt"), "--name", "graft",
                               "--cond_drop_prob", "0.1"])
    before, after = ckpt.load(os.path.join(run, "model", "latest.pt")), \
        ckpt.load(os.path.join(cfg.model_dir, "latest.pt"))
    assert after["params"].keys() - before["params"].keys() == set(add_cfg_branch.NULL_PARAMS)
    for name, w in before["params"].items():
        assert torch.equal(after["params"][name], w), name
        assert torch.equal(after["ema_params"][name], before["ema_params"][name]), name
    for name in add_cfg_branch.NULL_PARAMS:
        assert not after["params"][name].any() and not after["ema_params"][name].any()
    assert after["opt_state"]["state"] == {}  # a fresh Adam
    assert [after[k] for k in ("step", "epoch", "total_it")] == [6, 2, 6] == \
        [before[k] for k in ("step", "epoch", "total_it")]
    assert "cond_drop_prob: 0.1" in open(os.path.join(cfg.save_root, "opt.txt")).read()
    assert sorted(os.listdir(cfg.meta_dir)) == ["mean.npy", "std.npy"]

    # unguided sampling of the graft is the donor's, bit for bit
    donor_out = serve_run(tmp_path, os.path.join(run, "opt.txt"), "donor")
    graft_out = serve_run(tmp_path, os.path.join(cfg.save_root, "opt.txt"), "graft",
                          "--guidance_scale", "1")
    np.testing.assert_array_equal(graft_out, donor_out)
    guided = serve_run(tmp_path, os.path.join(cfg.save_root, "opt.txt"), "guided",
                       "--guidance_scale", "2.5")
    assert np.isfinite(guided).all()

    _, state = train_main(common + ref_args() + ["--name", "graft", "--num_epochs", "3",
                                                 "--cond_drop_prob", "0.1", "--is_continue"])
    assert state.step == 9 and state.optimizer.count == 3
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_add_cfg_branch_refusals(donor, tmp_path):
    from hig_tpu_torch import add_cfg_branch
    from hig_tpu_torch.config import load_opt_txt, save_opt_txt

    ckpts, _ = donor
    opt = os.path.join(ckpts, "synthetic_mul", "donor", "opt.txt")
    cfg = load_opt_txt(opt)
    for name, change, says in (("guided", dict(cond_drop_prob=0.2), "nothing to add"),
                               ("pit", dict(label_path=None), "supervised")):
        other = str(tmp_path / name / "opt.txt")
        save_opt_txt(ExperimentConfig(**{**cfg.__dict__, **change}), other)
        with pytest.raises(SystemExit, match=says):
            add_cfg_branch.main(["--opt_path", other, "--name", "x"])
    fresh = {"a": torch.zeros(2), "null_xf_proj": torch.ones(3), "null_xf_token": torch.ones(1)}
    with pytest.raises(SystemExit, match="shape mismatch"):
        add_cfg_branch.graft({"a": torch.zeros(3)}, fresh)
    with pytest.raises(SystemExit, match="not consumed"):
        add_cfg_branch.graft({"a": torch.zeros(2), "b": torch.zeros(1)}, fresh)
    with pytest.raises(SystemExit, match="unexpected new leaves"):
        add_cfg_branch.graft({}, fresh)


def test_serve_which_epoch(donor, tmp_path):
    from hig_tpu_torch import serve

    ckpts, _ = donor
    run = os.path.join(ckpts, "synthetic_mul", "donor")
    opt = os.path.join(run, "opt.txt")
    first = serve_run(tmp_path, opt, "e000", "--which_epoch", "ckpt_e000")
    named = serve_run(tmp_path, opt, "params", "--params",
                      os.path.join(run, "model", "ckpt_e000.pt"))
    latest = serve_run(tmp_path, opt, "latest")
    np.testing.assert_array_equal(first, named)
    assert not np.array_equal(first, latest)
    with pytest.raises(SystemExit):
        serve.main(["--requests", str(tmp_path / "reqs.jsonl"), "--random_init", "0",
                    "--which_epoch", "ckpt_e000", "--device", "cpu"])
