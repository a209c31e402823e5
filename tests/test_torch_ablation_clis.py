"""The paper's ablation models through the port's entry points on the CPU at
tiny widths: ``python -m hig_tpu_torch.train`` (PIT with caption ids, then
the supervised stage), ``label`` (role discovery and pseudo-labels),
``serve`` (from the run's opt.txt, and from the CLI flags) and
``evaluate`` (DDIM-2 against evaluators trained once for the module), for
``--no_cross_attn`` and ``--single_transformer`` in float32,
``--single_transformer`` in bfloat16, and the ``--causal`` efficient model.
"""

import json
import os

import numpy as np
import pytest
import torch

from hig_tpu_torch.data.vocab import CLASSID2CAPS
from tests.test_torch_eval import write_eval_dataset
from tests.test_torch_pipeline import TINY

# variant → extra training options
VARIANTS = {
    "no_cross_attn": ["--no_cross_attn"],
    "single_transformer": ["--single_transformer"],
    "single_transformer_bf16": ["--single_transformer", "--compute_dtype", "bfloat16"],
    "causal": ["--causal"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def widths():
    out = []
    for k, v in TINY.items():
        if k != "diffusion_steps":  # labeling takes t up to 920
            out += [f"--{k}", str(v)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A data root (52 clips, every split, role annotations) and the two
    evaluator models trained on it at the tiny widths."""
    from hig_tpu_torch.eval import train as eval_train

    tmp = tmp_path_factory.mktemp("ablation_clis")
    root, ckpts = str(tmp / "data"), str(tmp / "runs")
    write_eval_dataset(root)
    names = open(os.path.join(root, "train_sub.txt")).read().split()
    with open(os.path.join(root, "test_ann_ids.txt"), "w") as f:
        f.write("\n".join(names[:26]) + "\n")
    with open(os.path.join(root, "test_active_anns.json"), "w") as f:
        json.dump({n: i % 2 for i, n in enumerate(names)}, f)
    common = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", root,
              "--checkpoints_dir", ckpts, "--batch_size", "26"]
    for kind, name in (("classifier", "eval_model"), ("consistency", "consistency_eval_model")):
        eval_train.main(["--kind", kind, "--name", name, "--num_epochs", "2"] + common + widths()
                        + ["--diffusion_steps", "100"])
    return root, ckpts, tmp


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_label_serve_evaluate(runs, variant, capsys):
    from hig_tpu_torch import evaluate, label, serve
    from hig_tpu_torch.train.__main__ import main as train_main

    root, ckpts, tmp = runs
    flags = VARIANTS[variant]
    common = ["--device", "cpu", "--dataset_name", "synthetic_mul", "--data_root", root,
              "--checkpoints_dir", ckpts, "--batch_size", "4", "--num_epochs", "1",
              "--log_every", "1", "--limit_data_num", "8", "--result_path", str(tmp / "result")]
    _, pit = train_main(common + widths() + flags + ["--name", f"{variant}_pit", "--cap_id"])
    names = {n for n, _ in pit.model.named_parameters()}
    assert pit.step == 2
    assert any(".int_ca_block." in n for n in names) == (variant == "causal")
    assert all(torch.isfinite(p).all() for p in pit.model.parameters())
    run = os.path.join(ckpts, "synthetic_mul", f"{variant}_pit")
    opt = os.path.join(run, "opt.txt")
    assert ("single_transformer: True" in open(opt).read()) == ("single" in variant)
    assert ("causal: True" in open(opt).read()) == (variant == "causal")

    label.main(["--opt_path", opt, "--label_model", "--save_label", "--batch_size", "8",
                "--device", "cpu"])
    roles = json.load(open(os.path.join(run, "pit_labels.json")))
    labels = json.load(open(os.path.join(root, "pseudo_labels.json")))
    assert len(roles) == 26 and len(labels) == 8 and set(labels.values()) <= {0, 1}

    trainer, sup = train_main(common + widths() + flags + [
        "--name", f"{variant}_sup", "--cap_id", "--label_path",
        os.path.join(root, "pseudo_labels.json")])
    assert sup.step == 2 and trainer.pit is False

    reqs = tmp / f"{variant}_reqs.jsonl"
    reqs.write_text(json.dumps({"caption1": CLASSID2CAPS[0][0], "caption2": CLASSID2CAPS[0][1],
                                "length": 20, "id": "a"}) + "\n")
    out = tmp / f"{variant}_served"
    capsys.readouterr()
    serve.main(["--requests", str(reqs), "--opt_path", trainer.cfg.save_root + "/opt.txt",
                "--sampler", "ddim", "--ddim_steps", "2", "--device", "cpu",
                "--out_dir", str(out)])
    said = capsys.readouterr().out
    assert ("never fuse" in said) == ("single" in variant)  # fused blocks by default
    served = np.load(out / "a.npz")
    assert served["joints"].shape == (2, 20, 22, 3) and np.isfinite(served["joints"]).all()

    result = evaluate.main(["--opt_path", trainer.cfg.save_root + "/opt.txt", "--device",
                            "cpu", "--sampler", "ddim", "--ddim_steps", "2", "--gen_T", "40",
                            "--mm_num_times", "1"])
    summary = json.load(open(os.path.join(result["save_dir"], "summary0.json")))
    assert list(summary) == ["Acc", "Consistency", "FID", "Diversity", "MultiModality"]
    assert all(np.isfinite(v).all() for models in summary.values() for v in models.values())


@pytest.mark.parametrize("flag", ["--no_cross_attn", "--single_transformer"])
def test_serve_cli_takes_the_ablation_flags(tmp_path, flag, capsys):
    """--no_cross_attn and --single_transformer from the CLI on seeded
    weights; with --opt_path they are refused (the run gives the model)."""
    from hig_tpu_torch import serve

    cfg = tmp_path / "m.json"
    cfg.write_text(json.dumps({k: v for k, v in TINY.items() if k != "diffusion_steps"}
                              | {"clip": {"width": 32, "heads": 2, "layers": 1}}))
    reqs = tmp_path / "r.jsonl"
    reqs.write_text(json.dumps({"caption1": "A person kicks.", "caption2": "A person falls.",
                                "length": 9, "id": "a"}) + "\n")
    serve.main(["--requests", str(reqs), "--random_init", "0", "--model_config", str(cfg),
                flag, "--ddim_steps", "2", "--device", "cpu", "--out_dir", str(tmp_path / "o")])
    said = capsys.readouterr().out
    assert ('"interaction": false' in said) == (flag == "--no_cross_attn")
    assert ('"single_transformer": true' in said) == (flag == "--single_transformer")
    assert np.isfinite(np.load(tmp_path / "o" / "a.npz")["joints"]).all()
    with pytest.raises(SystemExit):
        serve.main(["--requests", str(reqs), "--opt_path", str(tmp_path / "opt.txt"), flag,
                    "--device", "cpu"])
