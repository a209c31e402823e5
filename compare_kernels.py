#!/usr/bin/env python3
"""Time this checkout's bfloat16 block and attention kernels (B1-bf16,
B4-bf16) beside the forms of an earlier checkout, on one NVIDIA GPU.

    git archive 84d091c hig_tpu_torch/csrc | tar -x -C result/parent
    python3 compare_kernels.py --parent result/parent/hig_tpu_torch/csrc

``--parent`` holds the earlier ``csrc`` (commit 84d091c: B1-bf16 as five
launches, row pass, q|k|v GEMM, core, gate row pass and Wo GEMM, through
the ``linear_attention.cuh`` of that commit; B4-bf16 as
``hig_flash_attention_bf16`` with the same arguments as now). The script
builds it with this checkout's nvcc flags into ``--build`` (a gitignored
directory), with a launcher that runs one of the five launches at a time,
and times, at the serving shape (16 sequences, T = 91) and the evaluation
chunk's (104 sequences, T = 196), each form by ``chip_smoke.time_ms``
(CUDA-graph replay) in turns: earlier, this checkout, this checkout,
earlier. B1-bf16 is timed whole and per launch; B4-bf16 self, partner,
causal and with 91 queries over 77 keys, beside torch's
scaled_dot_product_attention on the same bfloat16 inputs. Prints the
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

# The earlier B1-bf16 launcher with a `part` argument (-1: all five launches).
PARENT_PARTS = r"""
#include "linear_attention.cuh"

extern "C" int hig_fused_block_bf16_part(
    const hig::bf16* x, const float* mask, const hig::bf16* scale, const hig::bf16* shift,
    const hig::bf16* ln_g, const hig::bf16* ln_b,
    const hig::bf16* wq, const hig::bf16* bq, const hig::bf16* wk, const hig::bf16* bk,
    const hig::bf16* wv, const hig::bf16* bv,
    const hig::bf16* styl_g, const hig::bf16* styl_b, const hig::bf16* wo,
    const hig::bf16* bo, hig::bf16* xz, float* qkv, float* y, hig::bf16* out,
    int N, int T, int D, int interaction, int part, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = N * T;
  cudaError_t err = cudaSuccess;
  if (part < 0 || part == 0) {
    err = hig::launch_row_norm<false>(x, xz, ln_g, ln_b, nullptr, nullptr, M, D, T, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 1) {
    hig::GemmArgsBf16 a{};
    a.a0 = xz; a.a1 = xz;
    a.w0 = wq; a.w1 = wk; a.w2 = wv;
    a.b0 = bq; a.b1 = bk; a.b2 = bv;
    a.out = qkv;
    a.M = M; a.K = D; a.D = D; a.ldo = 3 * D;
    err = hig::launch_gemm_bf16_qkv(a, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 2) {
    err = hig::launch_core_qkv<true>(qkv, mask, y, N, T, D, interaction, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 3) {
    err = hig::launch_row_norm<true>(static_cast<const float*>(y), xz, styl_g, styl_b, scale,
                                     shift, M, D, T, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 4) {
    hig::GemmArgsBf16 c{};
    c.a0 = xz; c.a1 = xz;
    c.w0 = wo; c.w1 = wo; c.w2 = wo;
    c.b0 = bo; c.b1 = bo; c.b2 = bo;
    c.resid = x;
    c.out = out;
    c.M = M; c.K = D; c.D = D; c.ldo = D;
    err = hig::launch_gemm_bf16_out(c, stream);
  }
  return err;
}
"""
PARENT_B1_LAUNCHES = ("row_pass", "qkv_gemm", "core", "gate_row_pass", "wo_gemm")


def build_parent(parent: str, build: str) -> tuple:
    """nvcc the earlier sources (both libraries at once); returns the two
    C functions (B1-bf16 by part, B4-bf16) and each kernel's ptxas line."""
    from hig_tpu_torch.ops import _build

    os.makedirs(build, exist_ok=True)
    parts = os.path.join(build, "fused_block_parts.cu")
    with open(parts, "w") as f:
        f.write(PARENT_PARTS)
    jobs = []
    for name, src in (("b1", parts), ("b4", os.path.join(parent, "flash_attention.cu"))):
        out = os.path.join(build, f"libparent_{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", parent, "-o", out, src]
        jobs.append((out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = [], {}
    for out, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out}:\n{text}")
        libs.append(ctypes.CDLL(out))
        ptxas.update(ptxas_lines(text))
    b1 = libs[0].hig_fused_block_bf16_part
    b1.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    b4 = libs[1].hig_flash_attention_bf16
    b4.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return b1, b4, ptxas


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


def b1_case(cs, device, pairs: int, tq: int, interaction: bool, parent_b1) -> dict:
    from hig_tpu_torch.ops.fused_block import BlockWeights, fused_attention_block
    from hig_tpu_torch.ops.fused_block import launch_bf16

    w, x, mask, scale, shift = cs.block_inputs(device, pairs, tq)
    wb = BlockWeights(*[cs.to_bf16(t) for t in w])
    xb, sb, shb = cs.to_bf16(x), cs.to_bf16(scale), cs.to_bf16(shift)
    N, D = 2 * pairs, cs.D
    m = mask.reshape(N, tq).contiguous()
    s = sb.reshape(N, D).contiguous()
    sh = shb.reshape(N, D).contiguous()
    xz = torch.empty((N * tq, D), device=device, dtype=torch.bfloat16)
    qkv = torch.empty((N * tq, 3 * D), device=device)
    y = torch.empty((N * tq, D), device=device)
    out = torch.empty_like(xb)
    parent_tensors = ptrs((xb, m, s, sh, *wb, xz, qkv, y, out))
    tensors = (xb, m, s, sh, *wb, xz, y, out)

    def parent(part=-1):
        check(parent_b1(*parent_tensors, N, tq, D, int(interaction), part, stream()))

    def new(part=-1):
        launch_bf16(tensors, N, tq, D, interaction, torch.cuda.current_stream().cuda_stream,
                    part)

    args = (xb, mask, sb, shb, wb, cs.HEADS, interaction)
    row = {"parent": [cs.time_ms(parent)], "new": []}
    row["new"] += [cs.time_ms(lambda: fused_attention_block(*args)) for _ in range(2)]
    row["parent"].append(cs.time_ms(parent))
    parent()
    row["parent_launch_ms"] = {name: cs.time_ms(lambda: parent(part))
                               for part, name in enumerate(PARENT_B1_LAUNCHES)}
    new()
    row["launch_ms"] = {name: cs.time_ms(lambda: new(part))
                        for part, name in enumerate(cs.B1_BF16_LAUNCHES)}
    return row


def b4_cases(cs, device, pairs: int, tq: int, parent_b4) -> dict:
    from hig_tpu_torch.ops.flash_attention import flash_attention

    F = torch.nn.functional
    w, x, mask, _, _ = cs.block_inputs(device, pairs, tq)
    xb = cs.to_bf16(x)
    wqkv = cs.to_bf16(torch.cat([w.wq, w.wk, w.wv]))
    bqkv = cs.to_bf16(torch.cat([w.bq, w.bk, w.bv]))
    q, k, v = (F.linear(xb, wqkv) + bqkv).chunk(3, dim=-1)
    pk, pv = (F.linear(xb, wqkv[cs.D:]) + bqkv[cs.D:]).chunk(2, dim=-1)
    tk = cs.TK_SHORT
    cases = {"self": (q, k, v, mask, False, False), "partner": (q, pk, pv, mask, False, True),
             "causal": (q, k, v, mask, True, False),
             f"tq{tq}_tk{tk}": (q.contiguous(), k[..., :tk, :].contiguous(),
                               v[..., :tk, :].contiguous(), mask[..., :tk].contiguous(),
                               False, False)}
    N, D, H = 2 * pairs, cs.D, cs.HEADS
    rows = {}
    for name, (qq, kk, vv, m, causal, partner) in cases.items():
        Tk = kk.shape[-2]
        out = torch.empty_like(qq)
        mk = m.reshape(N, Tk).contiguous()

        def parent():
            check(parent_b4(*ptrs((qq, kk, vv, mk, out)), N, H, tq, Tk, qq.stride(-2),
                            kk.stride(-2), D, int(partner), int(causal), stream()))

        def heads(t):
            return t.reshape(N, t.shape[-2], H, D // H).transpose(1, 2)

        sk, sv, sm = (kk.flip(1), vv.flip(1), m.flip(1)) if partner else (kk, vv, m)
        bias = ((1.0 - sm.reshape(N, 1, 1, Tk)) * -1e6).expand(N, 1, tq, Tk)
        if causal:
            bias = bias + (torch.arange(Tk, device=device)[None, :]
                           > torch.arange(tq, device=device)[:, None]) * -1e6
        sdpa = (heads(qq), heads(sk), heads(sv), cs.to_bf16(bias).contiguous())
        args = (qq, kk, vv, H, m, causal, partner)
        row = {"parent": [cs.time_ms(parent)],
               "new": [cs.time_ms(lambda: flash_attention(*args)) for _ in range(2)]}
        row["parent"].append(cs.time_ms(parent))
        row["sdpa"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
            *sdpa[:3], attn_mask=sdpa[3]))
        rows[name] = row
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
    parent_b1, parent_b4, ptxas = build_parent(os.path.abspath(args.parent), args.build)
    print(json.dumps({"parent_ptxas": ptxas}), flush=True)
    device = torch.device("cuda")
    for shape, (pairs, tq) in {"serve": (cs.N_PAIRS, cs.T),
                               "eval": (cs.EVAL_CLIPS, cs.EVAL_T)}.items():
        for interaction in (False, True):
            row = b1_case(cs, device, pairs, tq, interaction, parent_b1)
            print(json.dumps({"kernel": "fused_block_bf16", "shape": [2 * pairs, tq],
                              "case": "interaction" if interaction else "self", **row}),
                  flush=True)
        for case, row in b4_cases(cs, device, pairs, tq, parent_b4).items():
            print(json.dumps({"kernel": "flash_attention_bf16", "shape": [2 * pairs, tq],
                              "case": case, **row}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
