"""One CUDA graph per call shape: capture once, replay after (the
counterpart of ``jax.jit`` over the JAX sampler and train step, one
compiled program per shape that runs with no host work per step).

:class:`GraphedCall` captures ``body(**inputs)`` into one
``torch.cuda.CUDAGraph`` and replays it:

- inputs are static buffers, cloned at capture from the first call's
  tensors; a call copies its tensors into them, replays, and returns a
  clone of the static output (a tensor, or a tuple of tensors);
- ``warmup(**inputs)`` runs once, eagerly, on the capture stream before
  the capture, so that what a capture refuses happens outside it: the
  kernel libraries are built and loaded, cuBLAS makes its handle and its
  workspace for that stream, each kernel sets its shared-memory attribute.
  Its result is kept (``warmup_output``): the train step's warm-up is the
  shape's first step itself, which the capture then follows;
- the graphs of one owner share one memory pool
  (``torch.cuda.graph_pool_handle()``): they never run at once;
- with ``generator`` (a CUDA generator the owner keeps for its graphs) the
  graph registers that generator's state, and each replay starts from the
  caller's generator state and hands the advanced state back, so the
  caller's generator ends where the eager body would have left it: Philox
  at the same (seed, offset) draws the same numbers in a graph as outside;
- the kernel wrappers' launch counters (:func:`counted`) count Python
  calls, and a replay runs no Python. A capture launches nothing, so the
  counts its wrappers made are taken back and recorded, and each replay
  credits them again. The warm-up's launches are real and stay counted
  (``warmup_launches``).

A capture that fails raises; nothing falls back to the eager body.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

_COUNTERS: list[tuple[object, str]] = []


def counted(owner, *attrs: str) -> None:
    """Register ``owner.<attr>`` for each of ``attrs`` as a launch counter,
    set to 0: the wrapper adds one each time it launches its kernel."""
    for attr in attrs:
        setattr(owner, attr, 0)
        _COUNTERS.append((owner, attr))


def launch_counts() -> dict[str, int]:
    """Every registered counter, by "<wrapper>.<attr>"."""
    return {f"{owner.__name__}.{attr}": getattr(owner, attr) for owner, attr in _COUNTERS}


def _set_counts(counts: dict[str, int]) -> None:
    for owner, attr in _COUNTERS:
        setattr(owner, attr, counts[f"{owner.__name__}.{attr}"])


def _count_delta(after: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _credit(delta: dict[str, int]) -> None:
    for owner, attr in _COUNTERS:
        n = delta.get(f"{owner.__name__}.{attr}", 0)
        if n:
            setattr(owner, attr, getattr(owner, attr) + n)


def _clone(out):
    return out.clone() if torch.is_tensor(out) else tuple(t.clone() for t in out)


class GraphedCall:
    """``body(**inputs) -> Tensor or tuple of Tensors`` captured once; see
    the module doc.

    After the capture: ``warmup_output``, ``capture_s`` (warm-up
    excluded), ``warmup_s``, ``pool_bytes`` (what the capture added to the
    device memory reserved, read from just after ``torch.cuda.graph``
    empties the cache on entering: the segments the pool took; a later
    graph on the same pool reuses the blocks it can), ``launches`` (the
    counts one replay credits) and ``warmup_launches``.
    """

    def __init__(self, body: Callable[..., object], inputs: dict[str, torch.Tensor],
                 pool, stream: torch.cuda.Stream, warmup: Callable[..., object],
                 generator: torch.Generator | None = None):
        self.inputs = {name: t.clone() for name, t in inputs.items()}
        self.generator = generator
        stream.wait_stream(torch.cuda.current_stream())
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            self.warmup_output = warmup(**self.inputs)
        torch.cuda.synchronize()
        self.warmup_s = time.perf_counter() - t0
        self.warmup_launches = _count_delta(launch_counts(), before)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                # read here: entering, torch.cuda.graph empties the cache
                reserved = torch.cuda.memory_reserved()
                self.output = body(**self.inputs)
        finally:
            captured = launch_counts()
            _set_counts(before)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.launches = _count_delta(captured, before)

    def summary(self) -> dict:
        """What the capture took and what a replay credits."""
        return {"warmup_s": self.warmup_s, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes, "launches": self.launches,
                "warmup_launches": self.warmup_launches}

    def __call__(self, generator: torch.Generator | None = None,
                 **inputs: torch.Tensor):
        """Replay on ``inputs`` (the capture's names and shapes); with a
        registered generator, draw from ``generator``'s state and advance it."""
        for name, t in inputs.items():
            self.inputs[name].copy_(t)
        if generator is not None:
            self.generator.set_state(generator.get_state())
        self.graph.replay()
        if generator is not None:
            generator.set_state(self.generator.get_state())
        _credit(self.launches)
        return _clone(self.output)
