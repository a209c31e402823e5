#!/usr/bin/env python3
"""Time this checkout's bfloat16 kernels beside the forms of an earlier
checkout, on one NVIDIA GPU.

    git archive <commit> hig_tpu_torch/csrc | tar -x -C result/parent
    python3 compare_kernels.py --parent result/parent/hig_tpu_torch/csrc

``--parent`` holds the earlier ``csrc``, from e788215 on (whose entries
take these arguments; its B2-bf16a's scratch is a float32 q|k|v, a later
one's the (3, 3 D, D) bfloat16 weight pieces, and the scratch passed holds
either). At 0f3a84c B2-bf16 held one sequence's keys whole (T <= 320);
since, it streams them at every T. At e788215: B2-bf16a as the
float32 form's two launches, a q|k|v GEMM on mma.sync that writes float32
q|k|v to device memory and the float32 core that reads it back, through
``hig_projected_attention_bf16a`` with a q|k|v scratch argument; B3-bf16 as
one 4-warp block per (head, sequence) on mma.sync, through
``hig_efficient_attention_bf16`` with the same arguments as now; B2-bf16
and B1-bf16 with the same arguments as now, over the producer and
projection loop that B2-bf16a now shares with them). The script builds
the three libraries with this checkout's nvcc flags into ``--build`` (a
gitignored directory) and times each form by ``chip_smoke.time_ms``
(CUDA-graph replay) in turns: earlier, this checkout, this checkout,
earlier. B2-bf16a self (kv_src is q_src) and partner at the serving (16
sequences, T = 91), labeling (256 × 91) and evaluation (104 × 196) shapes,
with this checkout's weight split alone; B3-bf16 with Tk = Tq at the
serving, training (128 × 91) and evaluation shapes and with 77 keys at the
serving shape; B2-bf16 self and partner and B1-bf16's q|k|v + core launch
(self and interaction) at the serving and evaluation shapes. Prints the
earlier kernels' registers, shared memory and spills (ptxas), one JSON line
per case, then the card's name and power limit. Correctness is
``chip_smoke.py``'s: this script compares times only.
"""


from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


PARENT_SOURCES = ("projected_attention", "efficient_attention", "fused_block")


def build_parent(parent: str, build: str) -> tuple:
    """nvcc the earlier sources (every library at once); returns the C
    functions (B2-bf16a, B3-bf16, B2-bf16, B1-bf16) and each kernel's ptxas
    line."""
    import chip_smoke
    from hig_tpu_torch.ops import _build

    os.makedirs(build, exist_ok=True)
    jobs = []
    for name in PARENT_SOURCES:
        out = os.path.join(build, f"libparent_{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", parent, "-o", out,
               os.path.join(parent, f"{name}.cu")]
        jobs.append((out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = [], {}
    for out, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out}:\n{text}")
        libs.append(ctypes.CDLL(out))
        ptxas.update(chip_smoke.ptxas_lines(text))
    b2a = libs[0].hig_projected_attention_bf16a
    b2a.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    b3 = libs[1].hig_efficient_attention_bf16
    b3.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    b2 = libs[0].hig_projected_attention_bf16
    b2.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    b1 = libs[2].hig_fused_block_bf16
    b1.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return b2a, b3, b2, b1, ptxas


def ptrs(tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def stream():
    return torch.cuda.current_stream().cuda_stream


def check(err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA error {err}")


def turns(parent, new) -> dict:
    """Times of ``parent`` and ``new`` in turns: earlier, new, new, earlier."""
    import chip_smoke as cs

    row = {"parent": [cs.time_ms(parent)], "new": [cs.time_ms(new) for _ in range(2)]}
    row["parent"].append(cs.time_ms(parent))
    return row


def b2a_cases(cs, device, pairs: int, tq: int, parent_b2a) -> dict:
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention, weight_pieces

    w, x, mask, _, _ = cs.block_inputs(device, pairs, tq)
    N, D = 2 * pairs, cs.D
    xn = cs.to_bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
    ws = (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)
    qkv = torch.empty((N * tq, 3 * D), device=device)
    out = torch.empty_like(xn)
    rows = {}
    with torch.no_grad():
        for name, kv, kmask in (("self", xn, mask),
                                ("partner", xn.flip(1).contiguous(), mask.flip(1).contiguous())):
            tensors = ptrs((xn, kv, *ws, kmask, qkv, out))

            def parent():
                check(parent_b2a(*tensors, N, tq, D, stream()))

            args = (xn, kv, *ws, cs.HEADS, kmask)
            rows[name] = turns(parent, lambda: fused_projected_attention(*args))
        rows["split_ms"] = cs.time_ms(lambda: weight_pieces(w.wq, w.wk, w.wv))
    return rows


def b2_cases(cs, device, pairs: int, tq: int, parent_b2) -> dict:
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention

    w, x, mask, _, _ = cs.block_inputs(device, pairs, tq)
    N, D = 2 * pairs, cs.D
    xn = cs.to_bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
    ws = [cs.to_bf16(t) for t in (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)]
    out = torch.empty_like(xn)
    rows = {}
    with torch.no_grad():
        for name, kv, kmask in (("self", xn, mask),
                                ("partner", xn.flip(1).contiguous(), mask.flip(1).contiguous())):
            tensors = ptrs((xn, kv, *ws, kmask, out))

            def parent():
                check(parent_b2(*tensors, N, tq, D, stream()))

            args = (xn, kv, *ws, cs.HEADS, kmask)
            rows[name] = turns(parent, lambda: fused_projected_attention(*args))
    return rows


def b1_cases(cs, device, pairs: int, tq: int, parent_b1) -> dict:
    """B1-bf16's q|k|v + core launch alone (``part`` 1), self and interaction."""
    from hig_tpu_torch.ops.fused_block import BlockWeights, launch_bf16

    w, x, mask, scale, shift = cs.block_inputs(device, pairs, tq)
    wb = BlockWeights(*[cs.to_bf16(t) for t in w])
    xb, sb, shb = cs.to_bf16(x), cs.to_bf16(scale), cs.to_bf16(shift)
    N, D = 2 * pairs, cs.D
    m = mask.reshape(N, tq).contiguous()
    s = sb.reshape(N, D).contiguous()
    sh = shb.reshape(N, D).contiguous()
    xz = torch.empty((N * tq, D), device=device, dtype=torch.bfloat16)
    y = torch.empty((N * tq, D), device=device)
    out = torch.empty_like(xb)
    tensors = (xb, m, s, sh, *wb, xz, y, out)
    rows = {}
    for interaction in (False, True):
        def parent(part=-1):
            check(parent_b1(*ptrs(tensors), N, tq, D, int(interaction), part, stream()))

        def new(part=-1):
            launch_bf16(tensors, N, tq, D, interaction, stream(), part)

        new()  # rows 0..2 (the row pass writes xz) before the part alone
        rows["interaction" if interaction else "self"] = turns(lambda: parent(1),
                                                               lambda: new(1))
    return rows


def b3_cases(cs, device, pairs: int, tq: int, parent_b3) -> dict:
    from hig_tpu_torch.ops.pallas_attention import fused_efficient_attention

    w, x, mask, _, _ = cs.block_inputs(device, pairs, tq)
    rows = {}
    for tk in ((tq, cs.TK_SHORT) if pairs == cs.N_PAIRS else (tq,)):
        q, k, v, heads, m = cs.b3_bf16_inputs(w, x, mask, tk)
        N, D = 2 * pairs, cs.D
        mfull = m.float().expand(pairs, 2, tk).contiguous()
        out = torch.empty_like(q)
        tensors = ptrs((q, k, v, mfull, out))

        def parent():
            check(parent_b3(*tensors, N, tq, tk, D, stream()))

        with torch.no_grad():
            rows[f"tk{tk}"] = turns(parent, lambda: fused_efficient_attention(q, k, v, heads, m))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's csrc directory")
    ap.add_argument("--build", default=os.path.join(ROOT, "result", "parent_build"),
                    help="where the earlier libraries are built")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hig_tpu_torch.ops import _build

    smi = cs.phase_device()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all()
    parent_b2a, parent_b3, parent_b2, parent_b1, ptxas = build_parent(
        os.path.abspath(args.parent), args.build)
    print(json.dumps({"parent_ptxas": ptxas}), flush=True)
    device = torch.device("cuda")
    shapes = {"projected_attention_bf16a": (b2a_cases, parent_b2a,
                                            {"serve": (cs.N_PAIRS, cs.T),
                                             "label": (2 * cs.LABEL_BATCH, cs.T),
                                             "eval": (cs.EVAL_CLIPS, cs.EVAL_T)}),
              "efficient_attention_bf16": (b3_cases, parent_b3,
                                           {"serve": (cs.N_PAIRS, cs.T),
                                            "train": (2 * cs.TRAIN_PAIRS, cs.T),
                                            "eval": (cs.EVAL_CLIPS, cs.EVAL_T)}),
              "projected_attention_bf16": (b2_cases, parent_b2,
                                           {"serve": (cs.N_PAIRS, cs.T),
                                            "eval": (cs.EVAL_CLIPS, cs.EVAL_T)}),
              "fused_block_bf16_qkv_core": (b1_cases, parent_b1,
                                            {"serve": (cs.N_PAIRS, cs.T),
                                             "eval": (cs.EVAL_CLIPS, cs.EVAL_T)})}
    for kernel, (cases, parent, at) in shapes.items():
        for shape, (pairs, tq) in at.items():
            for case, row in cases(cs, device, pairs, tq, parent).items():
                print(json.dumps({"kernel": kernel, "shape": [2 * pairs, tq], "case": case,
                                  "times_ms": row}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
