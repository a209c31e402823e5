#!/usr/bin/env python3
"""Time this checkout's bfloat16 projected-attention kernel (B2-bf16) and
the block kernel that shares its design (B1-bf16) beside the forms of an
earlier checkout, on one NVIDIA GPU.

    git archive d32f308 hig_tpu_torch/csrc | tar -x -C result/parent
    python3 compare_kernels.py --parent result/parent/hig_tpu_torch/csrc

``--parent`` holds the earlier ``csrc`` (commit d32f308: B2-bf16 as two
launches, a bfloat16 q|k|v GEMM on mma.sync that writes float32 q|k|v to
device memory and the float32 core that reads it back, through
``hig_projected_attention_bf16`` with a q|k|v scratch argument; B1-bf16 as
``hig_fused_block_bf16`` with the same arguments as now). The script builds
it with this checkout's nvcc flags into ``--build`` (a gitignored
directory) and times, at the serving shape (16 sequences, T = 91) and the
evaluation chunk's (104 sequences, T = 196), each form by
``chip_smoke.time_ms`` (CUDA-graph replay) in turns: earlier, this
checkout, this checkout, earlier. B2-bf16 self (kv_src is q_src) and
partner; B1-bf16 self and interaction, whole and its q|k|v + core launch
alone (the kernel whose producer, projection loop, column statistics and
feature softmax it now shares with B2-bf16). Prints the earlier kernels'
registers, shared memory and spills (ptxas), one JSON line per case, then
the card's name and power limit. Correctness is ``chip_smoke.py``'s: this
script compares times only.
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


def build_parent(parent: str, build: str) -> tuple:
    """nvcc the earlier sources (both libraries at once); returns the two
    C functions (B2-bf16, B1-bf16 by part) and each kernel's ptxas line."""
    from hig_tpu_torch.ops import _build

    os.makedirs(build, exist_ok=True)
    jobs = []
    for name in ("projected_attention", "fused_block"):
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
        ptxas.update(ptxas_lines(text))
    b2 = libs[0].hig_projected_attention_bf16
    b2.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    b1 = libs[1].hig_fused_block_bf16
    b1.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return b2, b1, ptxas


def ptxas_lines(text: str) -> dict:
    import chip_smoke

    return chip_smoke.ptxas_lines(text)


def ptrs(tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA error {err}")


def turns(parent, new) -> dict:
    """Times of ``parent`` and ``new`` in turns: earlier, new, new, earlier."""
    import chip_smoke as cs

    row = {"parent": [cs.time_ms(parent)], "new": [cs.time_ms(new) for _ in range(2)]}
    row["parent"].append(cs.time_ms(parent))
    return row


def b2_cases(cs, device, pairs: int, tq: int, parent_b2) -> dict:
    from hig_tpu_torch.ops.pallas_attention import fused_projected_attention

    w, x, mask, _, _ = cs.block_inputs(device, pairs, tq)
    N, D = 2 * pairs, cs.D
    xn = cs.to_bf16(torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6))
    ws = [cs.to_bf16(t) for t in (w.wq, w.bq, w.wk, w.bk, w.wv, w.bv)]
    qkv = torch.empty((N * tq, 3 * D), device=device)
    out = torch.empty_like(xn)
    rows = {}
    for name, kv, kmask in (("self", xn, mask),
                            ("partner", xn.flip(1).contiguous(), mask.flip(1).contiguous())):
        tensors = ptrs((xn, kv, *ws, kmask, qkv, out))

        def parent():
            check(parent_b2(*tensors, N, tq, D, stream()))

        args = (xn, kv, *ws, cs.HEADS, kmask)
        rows[name] = turns(parent, lambda: fused_projected_attention(*args))
    return rows


def b1_cases(cs, device, pairs: int, tq: int, parent_b1) -> dict:
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
            launch_bf16(tensors, N, tq, D, interaction, torch.cuda.current_stream().cuda_stream,
                        part)

        row = turns(parent, new)
        parent()
        row["qkv_core"] = turns(lambda: parent(1), lambda: new(1))
        rows["interaction" if interaction else "self"] = row
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
    parent_b2, parent_b1, ptxas = build_parent(os.path.abspath(args.parent), args.build)
    print(json.dumps({"parent_ptxas": ptxas}), flush=True)
    device = torch.device("cuda")
    for shape, (pairs, tq) in {"serve": (cs.N_PAIRS, cs.T),
                               "eval": (cs.EVAL_CLIPS, cs.EVAL_T)}.items():
        for kernel, cases in (("projected_attention_bf16",
                               b2_cases(cs, device, pairs, tq, parent_b2)),
                              ("fused_block_bf16", b1_cases(cs, device, pairs, tq, parent_b1))):
            for case, row in cases.items():
                print(json.dumps({"kernel": kernel, "shape": [2 * pairs, tq], "case": case,
                                  **row}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
