"""The ordered bfloat16 sum of the bfloat16 backwards.

XLA differentiates a bfloat16 softmax op chain with a sum of bfloat16
values that it does not upcast: each add is rounded to bfloat16, in the
order of its CPU backend's tree-reduction rewriter, the backend the JAX
references run on. :func:`~hig_tpu_torch.models.embeddings.softmax_vjp`
takes that sum in B3-bf16's and B4-bf16's backwards and in every bfloat16
softmax of the model. A float32 sum rounded once sits 0.3-0.7 of the
bfloat16 effect from XLA's gradients, so the port keeps the order.

:func:`bf16_sum` launches ``csrc/bf16_sum.cu`` on a CUDA tensor (one
launch, ``launches``: a thread per output and window of 32 terms, the
window's loads issued before its chain of rounded adds, a contiguous axis
staged through shared memory first) and takes :func:`bf16_sum_plain` on a
CPU one.
"""

from __future__ import annotations

import math

import torch

from hig_tpu_torch.ops import _build
from hig_tpu_torch.utils.graphs import counted

WINDOW = 32  # XLA's reduce window for long reductions
MAX_TERMS = WINDOW * WINDOW  # the kernel's two levels of windows


def bf16_sum_plain(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` (kept, of size 1) of bfloat16 values (float32
    ``x`` holding them), rounded to bfloat16 after every add: up to 32 terms
    are added in turn; a longer axis is zero-padded to a multiple of 32, the
    zeros split between its two ends (the smaller half first), summed per
    window of 32 in turn, and the windows' sums summed the same way."""
    x = x.movedim(dim, 0).to(torch.bfloat16)
    while x.shape[0] > 1:
        n = x.shape[0]
        if n <= WINDOW:
            windows = x[:, None]
        else:
            pad = -n % WINDOW
            zeros = x.new_zeros((pad, *x.shape[1:]))
            x = torch.cat([zeros[:pad // 2], x, zeros[pad // 2:]])
            windows = x.reshape(-1, WINDOW, *x.shape[1:]).transpose(0, 1)
        acc = windows[0]
        for term in windows[1:]:
            acc = acc + term  # a float32 add, rounded to bfloat16
        x = acc
    return x.float().movedim(0, dim)


def bf16_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`bf16_sum_plain`'s sum of float32 ``x`` over ``dim``, through the
    kernel on a CUDA tensor (at most MAX_TERMS terms; other dtypes raise)."""
    if x.device.type == "cpu":
        return bf16_sum_plain(x, dim)
    if x.dtype != torch.float32:
        raise ValueError(f"the bfloat16 sum takes float32 holding bfloat16 values, got {x.dtype}")
    dim %= x.dim()
    n = x.shape[dim]
    if n > MAX_TERMS:
        raise ValueError(f"the bfloat16 sum kernel takes at most {MAX_TERMS} terms, got {n}")
    x = x.contiguous()
    out = x.new_empty((*x.shape[:dim], 1, *x.shape[dim + 1:]))
    _build.launch("bf16_sum", (x, out),
                  (math.prod(x.shape[:dim]), n, math.prod(x.shape[dim + 1:])),
                  torch.cuda.current_stream(x.device).cuda_stream)
    bf16_sum.launches += 1
    return out


counted(bf16_sum, "launches")
