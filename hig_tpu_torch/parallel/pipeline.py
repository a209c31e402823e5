"""GPipe pipeline parallelism of the denoiser's layer stack (counterpart of
``hig_tpu/parallel/pipeline.py``).

The model axis's S ranks are S stages of L/S contiguous layers each. A
data rank's batch is split into M microbatches that stream through the
stages over M + S − 1 ticks: at tick t stage s runs its layers on
microbatch t − s and sends the result to stage s + 1 (``send``/``recv`` of
the model column's ranks). The last stage's outputs are broadcast over the
model column, as JAX's ``psum`` of the masked output replicates them, so
the replicated output heads and the loss follow on every rank.

Unlike JAX's SPMD program, where every device runs every tick and a stage
in the bubble recomputes a stale, discarded microbatch, explicit processes
idle in the bubble: a stage computes only the microbatches it holds. Each
layer sees the same inputs as in the sequential stack, so the output is
the sequential stack's.

The backward (:class:`_Pipeline`) runs the ticks in reverse: the last
stage takes its microbatches' output gradients, each stage differentiates
its graphs with ``torch.autograd.backward(outputs, grads)`` and sends the
input gradients to the stage before. Parameter gradients land in the
stage's own layers; the gradients of the embedded input (stage 0), the
conditioning and the text features are this stage's share, which the
trainer sums over the model column (``parallel/layout.py``). Each stage's
layers run in the model's mode: in train mode B2, as the unsplit model.

PP composes with DP: a microbatch stays data-sharded (each data rank
pipelines its own rows), and it raises where JAX raises (L % S, B % M,
mB % d, with B the global batch).
"""

from __future__ import annotations

import torch

from hig_tpu_torch.parallel import distributed as dist


class Pipeline:
    """The GPipe schedule of a denoiser's layers over ``group`` (the model
    axis: stage s is the group's rank s) in ``n_micro`` microbatches, for a
    data axis of ``data`` ranks. Set as ``InteractionDenoiser.pipeline``."""

    def __init__(self, group: dist.Group, n_micro: int, data: int = 1):
        self.group, self.n_micro, self.data = group, n_micro, data

    def check(self, num_layers: int, local_batch: int) -> None:
        S, M, d = self.group.size, self.n_micro, self.data
        B = local_batch * d
        if num_layers % S:
            raise ValueError(f"{num_layers} layers not divisible into {S} stages")
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} microbatches")
        if (B // M) % d:
            raise ValueError(
                f"microbatch size {B // M} (batch {B} / {M} microbatches) must be "
                f"divisible by the data axis ({d}) — PP composes with DP by "
                "keeping each microbatch data-sharded")

    def __call__(self, layers, h, xf_out, emb, src_mask):
        """The layer stack on the embedded input h (B, 2, T, D) with the
        text features xf_out (B, 2, L, Dt), the conditioning emb (B, 2, E)
        and src_mask (B, 1, T): every rank of the model column returns the
        stack's output (B, 2, T, D)."""
        self.check(len(layers), h.shape[0])
        needs = torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, xf_out, emb))
        return _Pipeline.apply(self, layers, needs, h, xf_out, emb, src_mask)

    def stage_layers(self, layers):
        per = len(layers) // self.group.size
        s = self.group.index()
        return list(layers)[s * per:(s + 1) * per]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, engine, layers, needs, h, xf_out, emb, src_mask):
        group, M = engine.group, engine.n_micro
        S, s = group.size, group.index()
        stage = engine.stage_layers(layers)
        mB = h.shape[0] // M
        leaves = [t.detach().requires_grad_(needs and t.requires_grad)
                  for t in (h, xf_out, emb)]
        h_l, xf_l, emb_l = leaves
        graphs, outs = {}, [None] * M
        with torch.set_grad_enabled(needs):
            for t in range(M + S - 1):
                m = t - s
                if not 0 <= m < M:
                    continue  # the bubble: this stage idles
                part = slice(m * mB, (m + 1) * mB)
                if s == 0:
                    x_in = h_l[part]
                else:
                    x_in = dist.recv(h[part], group.ranks[s - 1]).requires_grad_(needs)
                y = x_in
                for layer in stage:
                    y = layer(y, xf_l[part], emb_l[part], src_mask[part])
                graphs[m] = (x_in, y)
                if s < S - 1:
                    dist.send(y.detach(), group.ranks[s + 1])
                else:
                    outs[m] = y.detach()
        out = torch.cat(outs) if s == S - 1 else torch.zeros_like(h)
        out = dist.broadcast(out, group.ranks[S - 1], group)
        ctx.engine, ctx.graphs, ctx.leaves, ctx.mB = engine, graphs, leaves, mB
        return out

    @staticmethod
    def backward(ctx, grad_out):
        engine, graphs, mB = ctx.engine, ctx.graphs, ctx.mB
        group, M = engine.group, engine.n_micro
        S, s = group.size, group.index()
        for t in reversed(range(M + S - 1)):
            m = t - s
            if not 0 <= m < M:
                continue
            x_in, y = graphs.pop(m)
            part = slice(m * mB, (m + 1) * mB)
            if s == S - 1:
                g = grad_out[part]
            else:
                g = dist.recv(y, group.ranks[s + 1])
            torch.autograd.backward(y, g)
            if s > 0:
                dist.send(x_in.grad, group.ranks[s - 1])
        grads = [leaf.grad if leaf.requires_grad else None for leaf in ctx.leaves]
        if grads[0] is None and ctx.needs_input_grad[3]:
            grads[0] = torch.zeros_like(ctx.leaves[0])  # stages past 0 take no input
        return (None, None, None, *grads, None)
