"""The ordered bfloat16 sum of the bfloat16 backwards.

XLA differentiates a bfloat16 softmax op chain with a sum of bfloat16
values that it does not upcast: each add is rounded to bfloat16, in the
order of its CPU backend's tree-reduction rewriter, the backend the JAX
references run on. :func:`~hig_tpu_torch.models.embeddings.softmax_vjp`
takes that sum in B3-bf16's and B4-bf16's backwards and in every bfloat16
softmax of the model. A float32 sum rounded once sits 0.3-0.7 of the
bfloat16 effect from XLA's gradients, so the port keeps the order.

:func:`bf16_sum` launches ``csrc/bf16_sum.cu`` on a CUDA tensor (each
launch counted in ``launches``: up to 32 × 32 terms one launch, a thread
per output and window of 32 terms, the window's loads issued before its
chain of rounded adds, a contiguous axis staged through shared memory
first; past that one launch more for each further level of windows, into
a scratch) and takes :func:`bf16_sum_plain` on a CPU one. It takes any
number of terms, as the plain version does.
"""

from __future__ import annotations

import math

import torch

from hig_tpu_torch.ops import _build
from hig_tpu_torch.utils.graphs import counted

WINDOW = 32  # XLA's reduce window for long reductions
ONE_LAUNCH_TERMS = WINDOW * WINDOW  # the terms one launch sums (two levels of windows)


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


def scratch_levels(n: int) -> list[int]:
    """The window sums a output of each level past :data:`ONE_LAUNCH_TERMS`
    terms, which the kernel writes to its scratch, one launch each before
    the last launch."""
    levels = []
    while n > ONE_LAUNCH_TERMS:
        n = -(-n // WINDOW)
        levels.append(n)
    return levels


def bf16_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`bf16_sum_plain`'s sum of float32 ``x`` over ``dim``, through the
    kernel on a CUDA tensor (any number of terms; other dtypes raise)."""
    if x.device.type == "cpu":
        return bf16_sum_plain(x, dim)
    if x.dtype != torch.float32:
        raise ValueError(f"the bfloat16 sum takes float32 holding bfloat16 values, got {x.dtype}")
    dim %= x.dim()
    n = x.shape[dim]
    x = x.contiguous()
    out = x.new_empty((*x.shape[:dim], 1, *x.shape[dim + 1:]))
    outer, inner = math.prod(x.shape[:dim]), math.prod(x.shape[dim + 1:])
    levels = scratch_levels(n)  # none up to ONE_LAUNCH_TERMS: the kernel leaves it unread
    scratch = x.new_empty(outer * inner * sum(levels)) if levels else out
    _build.launch("bf16_sum", (x, out, scratch), (outer, n, inner),
                  torch.cuda.current_stream(x.device).cuda_stream)
    bf16_sum.launches += 1 + len(levels)
    return out


counted(bf16_sum, "launches")
