"""How a training run's ranks hold the train state and combine their work:
the port's counterpart of JAX's ``place_state`` / ``state_shardings`` and of
the collectives its partitioner inserts into the train step
(``hig_tpu/train/trainer.py:694-731``).

Modes, by the config and the mesh (``parallel/mesh.py``), as JAX picks
them (a model axis of one rank is plain data parallelism):

- ``dp``: every rank holds the whole state; the data axis splits the batch.
- ``fsdp``: parameters, Adam's moments and the EMA rest as ``_leaf_spec``
  shards over the model axis. A step all-gathers the whole weights into
  the model, runs forward and backward, reduce-scatters the gradients over
  the model axis and updates the shards. The batch is split over every
  rank (data × model), as ZeRO's data parallelism splits it. A
  whole-model gather per step; gathering layer by layer is later work.
- ``tp``: the blocks' weights as the tensor-parallel rule places them
  (``mesh.place_tp``); Adam's moments and the EMA mirror their shapes.
  The ranks of a data row see the same rows.
- ``pp``: the layer stack under the GPipe schedule over the model axis
  (``parallel/pipeline.py``); every rank keeps the whole state (a stage
  computes only its own layers; the others' gradients reach it in the
  model-axis sum below). The ranks of a data row see the same rows.

The loss of a step is the global batch's: each rank's loss is its rows'
share, normalized by the global batch's mask (the trainer sums each
microbatch's mask over :attr:`TrainLayout.batch_group` first), so the sum
over that group is the one-rank loss, and each rank's gradients are its
share of the one-rank gradients. :meth:`TrainLayout.reduce_grads` then
sums them: over the model axis where the ranks hold partial sums (FSDP: a
reduce-scatter for sharded leaves and an all-reduce for the others; TP:
the column-sharded modules' whole biases, of which each rank fed its
slice; PP: everything but the output heads, which every rank computes
whole from the broadcast output), then over the data axis. The clip's norm
(:meth:`TrainLayout.grad_norm`) is the global one: the sharded leaves'
squared sums all-reduced over the model axis, the whole ones counted once.

Checkpoints are the one-rank format: :meth:`TrainLayout.full_payload`
gathers the shards (every rank takes part, the primary writes), and
:meth:`TrainLayout.local_payload` cuts a full checkpoint back into this
rank's shards on restore. Whole weights from elsewhere (``--pretrained``'s
converted checkpoint) take the same cut: :meth:`TrainLayout.model_local`
into the model, then :meth:`TrainLayout.restore_shards`.
:meth:`TrainLayout.full_params` gathers the model's whole weights (a
distillation stage's student, handed to the next stage as its teacher).

:meth:`TrainLayout.data_parallel` is the layout of an entry point whose
JAX counterpart replicates its state whatever the config asks
(``tools/train_single.py``): DP over the mesh.
"""

from __future__ import annotations

import torch

from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.parallel import mesh as pmesh
from hig_tpu_torch.parallel.pipeline import Pipeline

HEADS = ("denoiser.out.", "denoiser.out2.")  # computed whole on every stage under PP


class TrainLayout:
    """The layout of one run's train state over ``mesh`` (module doc)."""

    def __init__(self, cfg, mesh: pmesh.Mesh, model_cfg):
        self.cfg, self.mesh, self.model_cfg = cfg, mesh, model_cfg
        S = mesh.shape[pmesh.MODEL_AXIS]
        self.mode = "dp"
        if S > 1 and cfg is not None:
            self.mode = "fsdp" if cfg.fsdp else "tp" if cfg.tp else \
                "pp" if cfg.pp_micro > 0 else "dp"
        # the ranks that split the batch: every rank under FSDP, else the
        # data axis (a data row's model ranks see the same rows)
        self.batch_group = mesh.world_group if self.mode == "fsdp" else mesh.data_group
        rule = {"fsdp": "fsdp", "tp": "tp"}.get(self.mode)
        self.dims = pmesh.shard_dims(model_cfg, S, rule) if rule else {}
        self.shards: dict[str, torch.Tensor] = {}  # FSDP: name → this rank's shard

    @classmethod
    def one_rank(cls) -> "TrainLayout":
        """The layout of a one-process run: every collective the identity."""
        return cls(None, pmesh.make_mesh(world=1, rank=0), None)

    @classmethod
    def data_parallel(cls, mesh: pmesh.Mesh) -> "TrainLayout":
        """Every rank holds the whole state and the data axis splits the
        batch (the ranks of a data row see the same rows): JAX's replicated
        placement (``pmesh.replicated``) on ``mesh``."""
        return cls(None, mesh, None)

    @property
    def ranks(self) -> int:
        return self.mesh.world_group.size

    @property
    def batch_index(self) -> int:
        return self.batch_group.index()

    @property
    def batch_count(self) -> int:
        return self.batch_group.size

    def dim(self, name: str) -> int | None:
        return self.dims.get(name)

    # ---- placement ----------------------------------------------------

    def place_model(self, model) -> None:
        """Before the optimizer is made: TP shards the blocks' weights, PP
        sets the schedule on the denoiser."""
        if self.mode == "tp":
            pmesh.place_tp(model, self.model_cfg, self.mesh.model_group)
        elif self.mode == "pp":
            model.denoiser.pipeline = Pipeline(self.mesh.model_group, self.cfg.pp_micro,
                                               self.mesh.shape[pmesh.DATA_AXIS])

    def place_state(self, state, trainable: list[str]) -> None:
        """After the optimizer is made: FSDP moves the optimizer (and the
        EMA) onto shards of the trainable parameters."""
        self.trainable = trainable
        if self.mode != "fsdp":
            return
        group = self.mesh.model_group
        named = dict(state.model.named_parameters())
        opt = state.optimizer
        for i, name in enumerate(trainable):
            dim = self.dims[name]
            if dim is None:
                continue
            shard = pmesh.shard(named[name], dim, group.index(), group.size).requires_grad_()
            self.shards[name] = shard
            opt.params[i] = shard
            opt.exp_avg[i] = torch.zeros_like(shard)
            opt.exp_avg_sq[i] = torch.zeros_like(shard)
        if state.ema is not None:
            for name in self.shards:
                state.ema[name] = pmesh.shard(state.ema[name], self.dims[name], group.index(),
                                              group.size)

    def masters(self, state) -> list:
        """The tensors the EMA averages, in its order: the shards where FSDP
        keeps them, else the model's parameters."""
        return [self.shards.get(name, p) for name, p in state.model.named_parameters()]

    @torch.no_grad()
    def gather_params(self, state) -> None:
        """FSDP: the whole weights into the model from the shards (one
        all-gather)."""
        if not self.shards:
            return
        named = dict(state.model.named_parameters())
        names = list(self.shards)
        whole = dist.all_gather_many([self.shards[n] for n in names],
                                     [self.dims[n] for n in names], self.mesh.model_group)
        for name, w in zip(names, whole):
            named[name].copy_(w)

    # ---- the step -----------------------------------------------------

    @torch.no_grad()
    def reduce_grads(self, state) -> None:
        """Sum the ranks' gradient shares (module doc); under FSDP the
        shards' gradients are set from the reduce-scatter."""
        model_group, data_group = self.mesh.model_group, self.mesh.data_group
        named = {n: p for n, p in state.model.named_parameters() if p.grad is not None}
        if self.mode == "fsdp":
            sharded = [n for n in named if n in self.shards]
            grads = dist.reduce_scatter_many([named[n].grad for n in sharded],
                                             [self.dims[n] for n in sharded], model_group)
            dist.all_reduce_many(grads, data_group)
            for name, grad in zip(sharded, grads):
                self.shards[name].grad = grad
            dist.all_reduce_many([p.grad for n, p in named.items() if n not in self.shards],
                                 self.mesh.world_group)
            return
        if self.mode == "tp":
            partial = [p.grad for n, p in named.items()
                       if n.endswith(".bias") and self.dims.get(n[:-5] + ".weight") == 0]
            dist.all_reduce_many(partial, model_group)
        elif self.mode == "pp":
            dist.all_reduce_many([p.grad for n, p in named.items() if not n.startswith(HEADS)],
                                 model_group)
        dist.all_reduce_many([p.grad for p in named.values()], self.batch_group)

    def grads(self, state) -> list:
        """The optimizer's gradients (the shards' under FSDP), a zero one
        for a tensor without."""
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in state.optimizer.params]

    def grad_norm(self, grads: list) -> torch.Tensor:
        """The global norm of the gradients of the optimizer's tensors
        ``grads`` (module doc); without sharded leaves the one-rank norm
        (the trainer's ``global_norm``)."""
        if not self.dims:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        sharded = [g for g, name in zip(grads, self.trainable) if self.dim(name) is not None]
        whole = [g for g, name in zip(grads, self.trainable) if self.dim(name) is None]
        sq = torch.zeros((), device=grads[0].device)
        if sharded:
            sq = dist.all_reduce(torch.stack(torch._foreach_norm(sharded)).square().sum(),
                                 self.mesh.model_group)
        if whole:
            sq = sq + torch.stack(torch._foreach_norm(whole)).square().sum()
        return sq.sqrt()

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks that split the batch."""
        return dist.all_reduce(t, self.batch_group)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of ``t`` (each rank holds its slice)."""
        return dist.all_gather(t, 0, self.batch_group)

    # ---- checkpoints --------------------------------------------------

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.dim(name)
        if dim is None or (self.mode == "fsdp" and name not in self.shards):
            return t
        return dist.all_gather(t, dim, self.mesh.model_group)

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.dim(name)
        if dim is None or (self.mode == "fsdp" and name not in self.shards):
            return t
        group = self.mesh.model_group
        return pmesh.shard(t, dim, group.index(), group.size)

    def model_local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole parameter ``name`` = ``t`` as this rank's model holds
        it: its shard under TP, else whole (FSDP's model holds the whole
        weights, its optimizer the shards: :meth:`restore_shards` after)."""
        return self._local(name, t) if self.mode == "tp" else t

    def full_params(self, state) -> dict:
        """The model's whole parameters, in the one-rank layout (every rank
        calls it): FSDP's model refreshed from the shards, TP's shards
        gathered."""
        self.gather_params(state)
        params = state.model.state_dict()
        if self.mode != "tp":
            return params
        return {k: self._full(k, v) for k, v in params.items()}

    def full_payload(self, payload: dict) -> dict:
        """A checkpoint payload of this rank's tensors, gathered into the
        one-rank format (every rank calls it)."""
        if self.mode not in ("fsdp", "tp"):
            return payload
        out = dict(payload)
        if self.mode == "tp":
            out["params"] = {k: self._full(k, v) for k, v in payload["params"].items()}
        out["opt_state"] = self._opt(payload["opt_state"], self._full)
        if payload.get("ema_params") is not None:
            out["ema_params"] = {k: self._full(k, v) for k, v in payload["ema_params"].items()}
        return out

    def local_payload(self, payload: dict) -> dict:
        """A one-rank checkpoint payload cut into this rank's tensors."""
        if self.mode not in ("fsdp", "tp"):
            return payload
        out = dict(payload)
        if self.mode == "tp":
            out["params"] = {k: self._local(k, v) for k, v in payload["params"].items()}
        out["opt_state"] = self._opt(payload["opt_state"], self._local)
        if payload.get("ema_params") is not None:
            out["ema_params"] = {k: self._local(k, v) for k, v in payload["ema_params"].items()}
        return out

    def _opt(self, opt_state: dict, fn) -> dict:
        state = {i: {**entry, "exp_avg": fn(self.trainable[i], entry["exp_avg"]),
                     "exp_avg_sq": fn(self.trainable[i], entry["exp_avg_sq"])}
                 for i, entry in opt_state["state"].items()}
        return {**opt_state, "state": state}

    def restore_shards(self, state) -> None:
        """FSDP after a restore (or a load) into the model's whole
        parameters: the shards cut from them."""
        named = dict(state.model.named_parameters())
        group = self.mesh.model_group
        with torch.no_grad():
            for name, shard in self.shards.items():
                shard.copy_(pmesh.shard(named[name], self.dims[name], group.index(),
                                        group.size))
