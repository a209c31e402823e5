#!/usr/bin/env python3
"""Time this checkout's bfloat16 kernels beside the forms of an earlier
checkout, on one NVIDIA GPU.

    git archive <commit> hig_tpu_torch/csrc | tar -x -C result/parent
    python3 compare_kernels.py --parent result/parent/hig_tpu_torch/csrc

``--parent`` holds the earlier ``csrc``, from 972c758 on, whose B2
entries take the output width Dout after D (from e788215 on with the
Dout arguments taken out of the B2 calls: their B2-bf16a's scratch is a
float32 q|k|v, a later one's the (3, 3 D, D) bfloat16 weight pieces, and
the scratch passed holds either). At 0f3a84c B2-bf16 held one sequence's keys whole (T <= 320);
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
(self and interaction) at the serving and evaluation shapes; B3-bf16's
streaming form, eager and lazy, at ``STREAM_SHAPES`` (through
``hig_efficient_attention_bf16_stream[_lazy]``, in the earlier checkout
from 7182f5d on for the lazy entry), beside this checkout's whole form
where it runs; and the ordered bfloat16 sum (``hig_bf16_sum``) at
``SUM_SHAPES``. ``--kernels`` picks some of these. Prints both checkouts'
registers, shared memory and spills (ptxas), one JSON line per case, then
the card's name and power limit. Correctness is ``chip_smoke.py``'s, but
for the streaming form and the sum, which round at the same points in the
same order as the earlier forms: each case also says whether this
checkout's output equals the earlier one's (and the whole form's, the
plain sum's) bit for bit.
"""


from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


PARENT_SOURCES = ("projected_attention", "efficient_attention", "fused_block", "bf16_sum")
# B3-bf16's streaming form: (sequences, Tq, Tk) of chip_smoke's B3_FORM_SHAPES,
# then past the 448 key rows it holds in shared memory, and Tq != Tk
STREAM_SHAPES = {"128x91": (128, 91, 91), "104x196": (104, 196, 196), "64x394": (64, 394, 394),
                 "16x640": (16, 640, 640), "16x1000": (16, 1000, 1000),
                 "16x91x394": (16, 91, 394), "16x394x77": (16, 394, 77)}
STREAM_TIMED = ("128x91", "104x196", "64x394")
# the sum: chip_smoke's three cases at the training shape (timed), then the
# padding's two ends, rows that fill no last block, 394 terms 512 apart
SUM_SHAPES = {"b3_features": ((64, 2, 91, 8, 64), -1), "b3_time": ((64, 2, 91, 8, 64), -3),
              "b4_keys": ((64, 2, 91, 91, 8), -2), "n33_rows": ((301, 33), 1),
              "n95_rows": ((301, 95), 1), "n97_strided": ((3, 97, 40), 1),
              "n64_ragged_rows": ((1001, 64), 1), "n394_strided": ((4, 394, 512), 1),
              "n1024_rows": ((9, 1024), 1)}
SUM_TIMED = ("b3_features", "b3_time", "b4_keys")


def build_parent(parent: str, build: str) -> tuple:
    """nvcc the earlier sources (every library at once); returns the C
    functions (B2-bf16a, B3-bf16, B2-bf16, B1-bf16, and by name B3-bf16's
    streaming entries and the sum) and each kernel's ptxas line."""
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
    b2a.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    b3 = libs[1].hig_efficient_attention_bf16
    b3.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    b2 = libs[0].hig_projected_attention_bf16
    b2.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    b1 = libs[2].hig_fused_block_bf16
    b1.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    more = {}
    for key, lib, entry, n_ptr, n_int in (
            ("b3_stream", libs[1], "efficient_attention_bf16_stream", 5, 4),
            ("b3_stream_lazy", libs[1], "efficient_attention_bf16_stream_lazy", 5, 4),
            ("bf16_sum", libs[3], "bf16_sum", 2, 3)):
        fn = getattr(lib, f"hig_{entry}", None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        more[key] = fn
    return b2a, b3, b2, b1, more, ptxas


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
                check(parent_b2a(*tensors, N, tq, D, D, stream()))

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
                check(parent_b2(*tensors, N, tq, D, D, stream()))

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


def b3_stream_cases(cs, device, shapes, fns) -> dict:
    """B3-bf16's streaming form, eager and lazy, at ``shapes`` against the
    earlier checkout's in turns (STREAM_TIMED only), with this checkout's
    whole form where it runs; every case says whether the outputs are
    equal bit for bit."""
    from hig_tpu_torch.ops.pallas_attention import BF16_MAX_T, efficient_attention_bf16_form

    rows = {}
    for label, (N, tq, tk) in shapes.items():
        w, x, mask, _, _ = cs.block_inputs(device, N // 2, max(tq, tk))
        q, k, v, heads, m = cs.b3_bf16_inputs(w, x, mask, tk)
        q = q[..., :tq, :].contiguous()
        mfull = m.float().expand(N // 2, 2, tk).contiguous()
        for lazy in (False, True):
            entry = fns["b3_stream_lazy" if lazy else "b3_stream"]
            if entry is None:
                continue
            out = torch.empty_like(q)

            def parent(entry=entry, out=out):
                check(entry(*ptrs((q, k, v, mfull, out)), N, tq, tk, cs.D, stream()))

            def new(form="stream", lazy=lazy):
                return efficient_attention_bf16_form(q, k, v, heads, m, form, lazy=lazy)

            parent()
            got = new()
            torch.cuda.synchronize()
            row = turns(parent, new) if label in STREAM_TIMED else {}
            row["equal_to_parent"] = bool(torch.equal(got, out))
            if max(tq, tk) <= BF16_MAX_T:
                row["equal_to_whole"] = bool(torch.equal(got, new("whole")))
                if label in STREAM_TIMED:
                    row["whole"] = [cs.time_ms(lambda: new("whole")) for _ in range(2)]
            rows[f"{label} {'lazy' if lazy else 'eager'}"] = row
    return rows


def sum_cases(cs, device, fns) -> dict:
    """The ordered bfloat16 sum at SUM_SHAPES against the earlier checkout's
    in turns (SUM_TIMED only) and, bit for bit, against it and the plain
    version."""
    from hig_tpu_torch.ops.bf16_sum import bf16_sum, bf16_sum_plain

    gen = torch.Generator().manual_seed(6)
    rows = {}
    for name, (shape, dim) in SUM_SHAPES.items():
        x = cs.to_bf16(torch.randn(shape, generator=gen) * 1e-2).float().to(device)
        d = dim % x.dim()
        ints = (math.prod(shape[:d]), shape[d], math.prod(shape[d + 1:]))
        got = bf16_sum(x, dim)
        ref = torch.empty_like(got)

        def parent(x=x, ref=ref, ints=ints):
            check(fns["bf16_sum"](*ptrs((x, ref)), *ints, stream()))

        parent()
        torch.cuda.synchronize()
        row = turns(parent, lambda: bf16_sum(x, dim)) if name in SUM_TIMED else {}
        row["equal_to_parent"] = bool(torch.equal(got, ref))
        row["equal_to_plain"] = bool(torch.equal(got, bf16_sum_plain(x, dim)))
        rows[name] = row
    return rows


KERNELS = ("projected_attention_bf16a", "efficient_attention_bf16", "projected_attention_bf16",
           "fused_block_bf16_qkv_core", "efficient_attention_bf16_stream", "bf16_sum")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's csrc directory")
    ap.add_argument("--build", default=os.path.join(ROOT, "result", "parent_build"),
                    help="where the earlier libraries are built")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS,
                    help="the kernels to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hig_tpu_torch.ops import _build

    smi = cs.phase_device()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log = _build.build_all()
    print(json.dumps({"ptxas": {lib: cs.ptxas_lines(text) for lib, text in log.items()
                                if lib != "seconds"}}), flush=True)
    parent_b2a, parent_b3, parent_b2, parent_b1, fns, ptxas = build_parent(
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
        if kernel not in args.kernels:
            continue
        for shape, (pairs, tq) in at.items():
            for case, row in cases(cs, device, pairs, tq, parent).items():
                print(json.dumps({"kernel": kernel, "shape": [2 * pairs, tq], "case": case,
                                  "times_ms": row}), flush=True)
    if "efficient_attention_bf16_stream" in args.kernels:
        for case, row in b3_stream_cases(cs, device, STREAM_SHAPES, fns).items():
            print(json.dumps({"kernel": "efficient_attention_bf16_stream", "case": case,
                              "times_ms": row}), flush=True)
    if "bf16_sum" in args.kernels:
        for case, row in sum_cases(cs, device, fns).items():
            print(json.dumps({"kernel": "bf16_sum", "case": case, "times_ms": row}),
                  flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
