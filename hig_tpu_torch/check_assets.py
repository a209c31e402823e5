"""Inventory the external assets and run the check each one unlocks
(counterpart of ``tools/check_assets.py``).

The CLIP BPE vocab, OpenAI's CLIP weights, the NTU feature files, the
reference checkpoint, SMPL_NEUTRAL.pkl, the GMM pose prior and the GloVe
vectors may be absent. This reports which are present, searching the same
places as the JAX tool (``HIG_TPU_BPE_PATH`` first for the vocab), and for
each present one runs its check through the port: the 43 captions through
the BPE tokenizer, the CLIP tower converted and run on a caption, the NTU
split files and the first clip's shape, the checkpoint's key counts, SMPL
and the GMM loaded. An absent asset is reported, never fetched.

    python -m hig_tpu_torch.check_assets [--assets_dir assets] [--data_root ...] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from os.path import exists
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device


def _find(paths):
    for p in paths:
        if p and exists(p):
            return p
    return None


def check_bpe(path: str) -> str:
    from hig_tpu_torch.data.vocab import CAPS
    from hig_tpu_torch.models import tokenizer as T

    tok = T.ClipBPETokenizer(path)
    ids = T.tokenize(CAPS, tokenizer=tok)
    n_tok = [int((row > 0).sum()) for row in ids]
    ok = all(3 <= n <= 30 for n in n_tok) and all(row[0] == T.SOT and T.EOT in row
                                                  for row in ids)
    return (f"BPE active; 43 NTU captions tokenize to {min(n_tok)}-{max(n_tok)} ids "
            f"({'ok' if ok else 'SUSPECT'})")


def check_clip(path: str, device, tokenizer=None) -> str:
    from hig_tpu_torch.models.text_encoder import ClipTextConfig, ClipTextTower
    from hig_tpu_torch.models.tokenizer import tokenize
    from hig_tpu_torch.train import torch_port as tp
    from hig_tpu_torch.weights import load_flax_tree

    sd = {f"clip.{k}": v for k, v in tp.load_torch_state_dict(path).items()}
    tower = load_flax_tree(ClipTextTower(ClipTextConfig()),
                           tp.convert_clip_text_tower(sd, layers=12)).to(device).eval()
    toks = torch.from_numpy(tokenize("a person is pushing the other person",
                                     tokenizer=tokenizer).astype(np.int64)).to(device)
    with torch.no_grad():
        out = tower(toks).cpu().numpy()
    return (f"converted 12-layer tower; features finite={bool(np.isfinite(out).all())}, "
            f"norm={float(np.linalg.norm(out)):.2f}")


def main(argv=None) -> list[tuple[str, str | None, str]]:
    """Parse ``argv``, print the inventory and return its rows (asset,
    path or None, status)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--assets_dir", type=str, default="assets")
    parser.add_argument("--data_root", type=str, default="data/NTURGBD_multi")
    parser.add_argument("--reference_ckpt", type=str,
                        default="checkpoints/ntu_mul/ntu_mul_interaction/model/latest.tar")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    A = args.assets_dir
    report: list[tuple[str, str | None, str]] = []  # (asset, path, check result)

    # ---- CLIP BPE vocabulary
    bpe = _find([os.environ.get("HIG_TPU_BPE_PATH"), pjoin(A, "bpe_simple_vocab_16e6.txt.gz")])
    report.append(("CLIP BPE vocab", bpe, check_bpe(bpe) if bpe
                   else "hash-tokenizer fallback in use"))

    # ---- CLIP ViT-B/32 weights
    clip_w = _find([pjoin(A, "ViT-B-32.pt"), pjoin(A, "clip_vit_b32.pt"),
                    os.path.expanduser("~/.cache/clip/ViT-B-32.pt")])
    if clip_w:
        try:
            from hig_tpu_torch.models.tokenizer import ClipBPETokenizer

            status = check_clip(clip_w, device, ClipBPETokenizer(bpe) if bpe else None)
        except Exception as e:  # noqa: BLE001 — report, don't crash the inventory
            status = f"conversion FAILED: {e}"
    else:
        status = "tower runs randomly initialized"
    report.append(("CLIP ViT-B/32 weights", clip_w, status))

    # ---- NTU split/annotation files
    split_files = ["train_sub.txt", "val_sub.txt", "test_sub.txt", "test_ann_ids.txt",
                   "test_active_anns.json"]
    have = [f for f in split_files if exists(pjoin(args.data_root, f))]
    splits = args.data_root if len(have) == len(split_files) else None
    if splits:
        counts = {f: len([line for line in open(pjoin(splits, f)) if line.strip()])
                  for f in split_files[:4]}
        anns = json.load(open(pjoin(splits, "test_active_anns.json")))
        ann_ids = {line.strip() for line in open(pjoin(splits, "test_ann_ids.txt"))
                   if line.strip()}
        covered = sum(k in ann_ids for k in anns)
        status = (f"train/val/test = {counts['train_sub.txt']}/{counts['val_sub.txt']}/"
                  f"{counts['test_sub.txt']} ids; {len(anns)} role annotations ({covered} on "
                  f"the {len(ann_ids)}-id annotated split)")
    else:
        status = f"INCOMPLETE: have {len(have)}/{len(split_files)} files"
    report.append(("NTU split/annotation files", splits, status))

    # ---- NTU feature files
    vec_dir = pjoin(args.data_root, "new_joint_vecs")
    ntu = args.data_root if exists(vec_dir) and os.listdir(vec_dir) else None
    if ntu:
        has_stats = exists(pjoin(ntu, "Mean.npy")) and exists(pjoin(ntu, "Std.npy"))
        status = (f"{len(os.listdir(vec_dir))} feature files, "
                  f"Mean/Std={'yes' if has_stats else 'MISSING'}")
        name = open(pjoin(ntu, "train_sub.txt")).read().split()[0]
        p = pjoin(vec_dir, f"{name}.npy")
        if exists(p):
            arr = np.load(p)
            ok = arr.ndim == 3 and arr.shape[0] == 2 and arr.shape[2] == 263
            status += f"; first clip shape {arr.shape} ({'ok' if ok else 'WRONG'})"
    else:
        status = "absent (synthetic data only)"
    report.append(("NTU mutual features", ntu, status))

    # ---- reference generator checkpoint
    ref_ckpt = _find([args.reference_ckpt, pjoin(A, "latest.tar")])
    if ref_ckpt:
        try:
            from hig_tpu_torch.train import torch_port as tp

            sd = tp.load_torch_state_dict(ref_ckpt)
            n_dec = len([k for k in sd if k.startswith("temporal_decoder_blocks.")])
            status = (f"{len(sd)} tensors, {n_dec} decoder-block entries — run "
                      f"python -m hig_tpu_torch.parity_smoke for an end-to-end diff")
        except Exception as e:  # noqa: BLE001
            status = f"load FAILED: {e}"
    else:
        status = "absent"
    report.append(("reference checkpoint (.tar)", ref_ckpt, status))

    # ---- SMPL assets
    smpl = _find([pjoin(A, "SMPL_NEUTRAL.pkl"), "smpl_models/SMPL_NEUTRAL.pkl"])
    if smpl:
        try:
            from hig_tpu_torch.smpl.lbs import load_smpl_model

            status = f"loads; {load_smpl_model(smpl).v_template.shape[0]} vertices"
        except Exception as e:  # noqa: BLE001
            status = f"load FAILED: {e}"
    else:
        status = "synthetic SMPL used in tests"
    report.append(("SMPL_NEUTRAL.pkl", smpl, status))
    gmm = _find([pjoin(A, "gmm_08.pkl"), "smpl_models/gmm_08.pkl"])
    if gmm:
        try:
            from hig_tpu_torch.smpl.prior import load_gmm_prior

            load_gmm_prior(gmm)
            status = "GMM prior loads"
        except Exception as e:  # noqa: BLE001
            status = f"load FAILED: {e}"
    else:
        status = "uniform prior fallback"
    report.append(("GMM pose prior (gmm_08.pkl)", gmm, status))

    # ---- GloVe vectors
    glove = _find([pjoin(A, "glove"), "data/glove"])
    report.append(("GloVe+POS vectors", glove,
                   "word_vectorizer uses assets" if glove else "hash fallback"))

    print(f"{'asset':34s} {'present':8s} status")
    print("-" * 100)
    missing = 0
    for name, path, status in report:
        missing += path is None
        print(f"{name:34s} {'yes' if path else 'no':8s} {status}")
        if path:
            print(f"{'':34s} {'':8s} @ {path}")
    print("-" * 100)
    print(f"{len(report) - missing}/{len(report)} assets present")
    return report


if __name__ == "__main__":
    main()
