"""The port's asset tools against hig_tpu's on the CPU.

- ``python -m hig_tpu_torch.parity_smoke`` against ``tools/parity_smoke.py``
  on one synthetic reference checkpoint (the reference's key names,
  ``torch_port.reference_state_dict``) at small widths, one layer's
  interaction block left out so that some leaves are uncovered: the same
  coverage line, and the probe's statistics (np seed 1234, t = 500) within
  float32 tolerance, the uncovered leaves at JAX's init (through the weight
  bridge). The JAX tool's CLIP tower is shrunk and its sampler stubbed (its
  sample is not compared); the port samples (DDIM), decodes and writes
  ``parity_sample.npy``, and diffs it against a reference output.
- ``python -m hig_tpu_torch.check_assets`` against ``tools/check_assets.py``
  on an empty assets directory and on stand-ins of every asset (a BPE
  vocab, CLIP ViT-B/32-shaped weights, the NTU split, annotation and
  feature files, a reference checkpoint, SMPL and the GMM prior, a GloVe
  directory): the same table, the CLIP features' norm within float32
  tolerance.

Both tools run in this process (``runpy``), the JAX tool's flags through
``sys.argv``.
"""

import functools
import gzip
import json
import os
import pickle
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.models import interaction_model as jim
from hig_tpu.models import tokenizer as jtok
from hig_tpu.models.text_encoder import ClipTextConfig as JaxClip
from hig_tpu.train import torch_port as jtp
from hig_tpu.train import trainer as jtr
from hig_tpu_torch.models.interaction_model import ModelConfig
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.smpl.lbs import save_smpl_npz, synthetic_smpl_model
from hig_tpu_torch.train import torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = dict(width=32, heads=2, layers=1)
WIDTHS = dict(num_layers=2, num_text_layers=1, latent_dim=64)
PROBE_RTOL = 1e-4  # the probe's statistics, float32 against float32


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_jax_tool(name: str, argv: list, monkeypatch) -> None:
    monkeypatch.setattr("sys.argv", [name, *argv])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(REPO, "tools", name), run_name="__main__")
    assert done.value.code in (None, 0)


def probe(text: str) -> np.ndarray:
    (line,) = [s for s in text.splitlines() if s.startswith("probe eps(t=500)")]
    return np.array([float(v) for v in re.findall(r"=(-?[\d.]+)", line.split(":", 1)[1])])


def coverage(text: str) -> str:
    (line,) = [s for s in text.splitlines() if s.startswith("conversion coverage")]
    return line


def test_parity_smoke_matches_jax(tmp_path, monkeypatch, capsys):
    from hig_tpu_torch import parity_smoke

    cfg = ModelConfig(**WIDTHS, clip=ClipTextConfig(**CLIP))
    sd = torch_port.reference_state_dict(cfg, seed=3)
    sd = {k: v for k, v in sd.items() if ".1.int_ca_block." not in k}  # uncovered leaves
    ckpt = str(tmp_path / "latest.tar")
    torch_port.save_reference_checkpoint(sd, ckpt)
    rs = np.random.RandomState(0)
    np.save(tmp_path / "mean.npy", rs.randn(267).astype(np.float32))
    np.save(tmp_path / "std.npy", (0.5 + rs.rand(267)).astype(np.float32))
    flags = ["--checkpoint", ckpt, "--mean", str(tmp_path / "mean.npy"), "--std",
             str(tmp_path / "std.npy"), "--motion_length", "20",
             *[a for k, v in WIDTHS.items() for a in (f"--{k}", str(v))]]

    # the JAX tool, its tower shrunk and its sampler stubbed
    jax_model = functools.partial(jim.InteractionModel, clip_config=JaxClip(**CLIP))
    monkeypatch.setattr(jim, "InteractionModel", jax_model)
    monkeypatch.setattr(jtp, "convert_interaction_model", functools.partial(
        jtp.convert_interaction_model, clip_layers=CLIP["layers"]))
    monkeypatch.setattr(jtr, "make_sampler", lambda model, sched, T, dim_pose, sampler: (
        lambda params, tokens, lengths, rng: np.zeros((1, 2, T, dim_pose), np.float32)))
    run_jax_tool("parity_smoke.py", flags + ["--out", str(tmp_path / "jax")], monkeypatch)
    want = capsys.readouterr().out
    T = 21
    init = jax.jit(jax_model(**WIDTHS).init)(
        jax.random.key(0), jnp.zeros((1, 2, T, 263)), jnp.zeros((1,), jnp.int32),
        jnp.full((1,), T, jnp.int32), jnp.zeros((1, 2, 77), jnp.int32))
    init = jax.tree_util.tree_map(np.array, init["params"])

    ref = np.random.RandomState(5).randn(2, T - 1, 22, 3).astype(np.float32)
    np.save(tmp_path / "ref.npy", ref)
    out = parity_smoke.main(flags + ["--out", str(tmp_path / "port"), "--sampler", "ddim",
                                     "--reference_output", str(tmp_path / "ref.npy"),
                                     "--device", "cpu"],
                            clip_config=ClipTextConfig(**CLIP), init_params=init)
    got = capsys.readouterr().out
    assert coverage(got) == coverage(want)
    n_conv, n_leaves = out["coverage"]
    assert 0 < n_conv < n_leaves
    np.testing.assert_allclose(probe(got), probe(want), rtol=PROBE_RTOL)
    joints = np.load(out["sample"])
    assert joints.shape == (2, T - 1, 22, 3) and np.isfinite(joints).all()
    (diff,) = [s for s in got.splitlines() if s.startswith("vs ")]
    err = np.linalg.norm(ref - joints, axis=-1)
    assert f"mean joint err {err.mean():.4f} m" in diff


def write_stand_ins(root) -> tuple[str, str]:
    """Stand-ins of every asset check_assets looks for: (assets dir, data root)."""
    from hig_tpu_torch.data.synthetic import generate_dataset

    assets, data = root / "assets", root / "data"
    assets.mkdir()
    with gzip.open(assets / "bpe_simple_vocab_16e6.txt.gz", "wt") as f:
        f.write("#version: 0.2\nh e\nhe l\nl o</w>\np e\nr s\n")
    # CLIP ViT-B/32's text tower at its widths
    tower = torch_port.reference_state_dict(ModelConfig(num_layers=0, num_text_layers=0,
                                                        latent_dim=64), seed=1)
    torch.save({k[len("clip."):]: torch.from_numpy(v) for k, v in tower.items()
                if k.startswith("clip.")}, assets / "ViT-B-32.pt")
    torch_port.save_reference_checkpoint(
        torch_port.reference_state_dict(ModelConfig(**WIDTHS, clip=ClipTextConfig(**CLIP))),
        str(assets / "latest.tar"))
    save_smpl_npz(synthetic_smpl_model(64), str(root / "smpl.npz"))
    with open(assets / "SMPL_NEUTRAL.pkl", "wb") as f:
        pickle.dump(dict(np.load(root / "smpl.npz")), f)
    rs = np.random.RandomState(0)
    with open(assets / "gmm_08.pkl", "wb") as f:
        pickle.dump({"means": rs.randn(8, 69), "covars": np.stack([np.eye(69)] * 8),
                     "weights": np.full(8, 1 / 8)}, f)
    (assets / "glove").mkdir()
    generate_dataset(str(data), clips_per_class=1, min_frames=20, max_frames=24, seed=0,
                     device="cpu")
    test_ids = open(data / "test_sub.txt").read().split()
    (data / "test_ann_ids.txt").write_text("\n".join(test_ids[:5]) + "\n")
    (data / "test_active_anns.json").write_text(json.dumps({i: 0 for i in test_ids[:7]}))
    return str(assets), str(data)


@pytest.mark.parametrize("case", ["empty", "stand_ins"])
def test_check_assets_matches_jax(case, tmp_path, monkeypatch, capsys):
    from hig_tpu_torch import check_assets

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("HIG_TPU_BPE_PATH", raising=False)
    if case == "empty":
        assets, data = str(tmp_path / "assets"), str(tmp_path / "data")
    else:
        assets, data = write_stand_ins(tmp_path)
        # the JAX tool reads the vocab's path when its tokenizer module is
        # first imported; this process imported it already
        monkeypatch.setattr(jtok, "_DEFAULT_ASSET_PATHS",
                            [os.path.join(assets, "bpe_simple_vocab_16e6.txt.gz")])
    flags = ["--assets_dir", assets, "--data_root", data,
             "--reference_ckpt", str(tmp_path / "missing.tar")]
    try:
        run_jax_tool("check_assets.py", flags, monkeypatch)
        want = capsys.readouterr().out
    finally:
        jtok.default_tokenizer.cache_clear()
    monkeypatch.delenv("HIG_TPU_BPE_PATH", raising=False)  # the JAX tool set it
    report = check_assets.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    norm = re.compile(r"norm=([\d.]+)")
    for a, b in zip(got.splitlines(), want.splitlines(), strict=True):
        if norm.search(b):
            np.testing.assert_allclose(float(norm.search(a).group(1)),
                                       float(norm.search(b).group(1)), rtol=1e-4)
            a, b = norm.sub("", a), norm.sub("", b)
        assert a == b.replace("tools/parity_smoke.py", "python -m hig_tpu_torch.parity_smoke")
    present = sum(path is not None for _, path, _ in report)
    assert present == (0 if case == "empty" else len(report))
    assert all("FAILED" not in status and "ERROR" not in status for _, _, status in report)
