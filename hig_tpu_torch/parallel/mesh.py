"""The (data, model) grid of ranks and its sharding rules (counterpart of
``hig_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``Mesh`` and lets the SPMD partitioner insert
the collectives; the port lays its ranks out the same way and runs them
itself (``parallel/distributed.py``). :func:`make_mesh` puts global rank r
at (r // model, r % model), process-major as JAX's ``jax.devices()`` order,
and makes one process group per data row (its ranks along the model axis:
``model_group``) and per model column (along the data axis:
``data_group``). ``dcn_data`` (JAX's hybrid-mesh field, read from its
opt.txt) is checked to divide the data axis and changes nothing else:
with one rank per process the process-major order already gives each of
the ``dcn_data`` granules (hosts) a contiguous block of data rows, so the
loss is the flat grid's, as in JAX's hybrid-mesh case.

The rules, keyed on JAX's leaf names and shapes through the name map of
``weights.flax_leaves`` so that the port's shard of a parameter is JAX's
shard of the same leaf:

- FSDP (:func:`_leaf_spec`): the largest dimension divisible by the model
  size (the first of equal ones, in JAX's layout), else replicated; Adam's
  moments and the EMA mirror it;
- sequence parallelism (:func:`place_sequence`, :func:`sequence_shard`):
  the time axis of the motion over the model axis, the linear attention's
  time reductions as partial ones plus an all-reduce;
- tensor parallelism (:func:`_tp_leaf_spec`, ``mesh.py:134-160`` of JAX):
  the 2-D kernels of modules named query, key, value and linear1
  column-sharded (output features), linear2's row-sharded (input
  features), everything else replicated. Biases stay whole, as in JAX;
  a rank uses its slice of a column-sharded module's bias.

A flax kernel (in, out) is a torch weight (out, in): a spec's dimension is
transposed on the way (:func:`torch_dim`).

:class:`TensorParallel` is what a block holds when it runs tensor-parallel:
its rank's heads and columns, and the three collectives of the Megatron
pattern as autograd functions (:meth:`~TensorParallel.enter`,
:meth:`~TensorParallel.gather`, :meth:`~TensorParallel.reduce`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from hig_tpu_torch.config import MeshConfig
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.weights import flax_leaves

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    """The rank grid ``devices`` (data, model) and this rank's place in it."""

    devices: np.ndarray
    rank: int
    data_group: dist.Group   # this rank's model column: the ranks along the data axis
    model_group: dist.Group  # this rank's data row: the ranks along the model axis
    world_group: dist.Group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self.devices == self.rank)[0][0])

    @property
    def model_index(self) -> int:
        return int(np.argwhere(self.devices == self.rank)[0][1])


def make_mesh(cfg: MeshConfig | None = None, world: int | None = None,
              rank: int | None = None) -> Mesh:
    """The (data, model) grid of the run's ranks (module doc). ``data`` of -1
    or 0 takes every rank the model axis leaves. Raises as JAX's does when
    data × model is not the world, or the data axis does not divide into
    ``dcn_data`` granules. Every process calls it (it makes the groups)."""
    cfg = cfg or MeshConfig()
    world = dist.process_count() if world is None else world
    rank = dist.process_index() if rank is None else rank
    model = max(1, cfg.model)
    data = cfg.data if cfg.data not in (-1, 0) else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    dcn = max(1, cfg.dcn_data)
    if dcn > 1 and data % dcn:
        raise ValueError(f"data axis {data} not divisible by dcn_data {dcn}")
    # process-major, which is host-major: granule g holds data rows
    # [g·data/dcn, (g+1)·data/dcn)
    devices = np.arange(world).reshape(data, model)
    rows = [dist.new_group(devices[d]) for d in range(data)]
    cols = [dist.new_group(devices[:, m]) for m in range(model)]
    here = np.argwhere(devices == rank)[0]
    world_group = dist.new_group(range(world)) if world > 1 else dist.Group((rank,))
    return Mesh(devices, rank, cols[here[1]], rows[here[0]], world_group)


def shard_batch(x, index: int, count: int):
    """Rank ``index`` of ``count``'s contiguous slice of the leading
    (batch) axis of ``x`` (an array or tensor, or a dict of them): the
    port's form of JAX's process-local ``shard_batch``."""
    if isinstance(x, dict):
        return {k: shard_batch(v, index, count) for k, v in x.items()}
    if x.shape[0] % count:
        raise ValueError(f"global batch {x.shape[0]} not divisible by {count} processes")
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------


def _leaf_spec(shape, model_size: int) -> tuple:
    """JAX's FSDP PartitionSpec of a leaf of ``shape`` (as a tuple): the
    largest dimension divisible by the model axis; scalars and indivisible
    leaves replicate (``()``)."""
    if len(shape) == 0 or model_size <= 1:
        return ()
    dims = [d for d in range(len(shape)) if shape[d] % model_size == 0 and shape[d] >= model_size]
    if not dims:
        return ()
    best = max(dims, key=lambda d: shape[d])
    spec = [None] * len(shape)
    spec[best] = MODEL_AXIS
    return tuple(spec)


_TP_COLUMN = ("query", "key", "value", "linear1")
_TP_ROW = ("linear2",)


def _tp_leaf_spec(names, shape, model_size: int) -> tuple:
    """JAX's tensor-parallel PartitionSpec of the leaf at flax path ``names``."""
    if model_size <= 1 or len(shape) != 2 or len(names) < 2 or names[-1] != "kernel":
        return ()
    module = names[-2]
    if module in _TP_COLUMN and shape[1] % model_size == 0 and shape[1] >= model_size:
        return (None, MODEL_AXIS)
    if module in _TP_ROW and shape[0] % model_size == 0 and shape[0] >= model_size:
        return (MODEL_AXIS, None)
    return ()


def fsdp_specs(cfg, model_size: int) -> dict[str, tuple]:
    """Each parameter name of ``cfg``'s model → its FSDP spec in JAX's
    layout (the spec of the JAX leaf it carries)."""
    return {name: _leaf_spec(shape, model_size)
            for name, (_, shape) in flax_leaves(cfg).items()}


def tp_specs(cfg, model_size: int) -> dict[str, tuple]:
    """Each parameter name of ``cfg``'s model → its tensor-parallel spec in
    JAX's layout."""
    return {name: _tp_leaf_spec(path, shape, model_size)
            for name, (path, shape) in flax_leaves(cfg).items()}


def torch_dim(spec: tuple, name: str) -> int | None:
    """The dimension of the port's parameter ``name`` that a JAX ``spec``
    shards (a 2-D weight is the transposed kernel), or None."""
    if MODEL_AXIS not in spec:
        return None
    d = spec.index(MODEL_AXIS)
    return 1 - d if name.endswith(".weight") and len(spec) == 2 else d


def shard_dims(cfg, model_size: int, rule: str) -> dict[str, int | None]:
    """Each parameter name → the torch dimension its ``rule`` ("fsdp" or
    "tp") shards, or None."""
    specs = (fsdp_specs if rule == "fsdp" else tp_specs)(cfg, model_size)
    return {name: torch_dim(spec, name) for name, spec in specs.items()}


def shard(t: torch.Tensor, dim: int | None, index: int, count: int) -> torch.Tensor:
    """Chunk ``index`` of ``count`` of ``t`` on ``dim`` (a copy), or ``t``
    whole for None."""
    if dim is None:
        return t
    return t.detach().chunk(count, dim)[index].clone()


# --------------------------------------------------------------------------
# tensor parallelism in the blocks
# --------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return dist.all_reduce(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather on the last axis; the backward keeps this rank's columns
    of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return dist.all_gather(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        i = ctx.group.index()
        return grad[..., i * ctx.width:(i + 1) * ctx.width].contiguous(), None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) of partial products; the backward passes the
    (replicated) gradient to every rank's part."""

    @staticmethod
    def forward(ctx, x, group):
        return dist.all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A block's tensor-parallel rank: ``size`` ranks of ``group`` split its
    heads and the columns of its query/key/value/linear1 weights (rows of
    linear2), and this rank holds part ``index``."""

    group: dist.Group

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index()

    def heads(self, num_heads: int) -> int:
        return num_heads // self.size

    def cols(self, bias: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a column-sharded module's (whole) bias."""
        n = bias.shape[-1] // self.size
        return bias[..., self.index * n:(self.index + 1) * n]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering column-parallel products."""
        return _Enter.apply(x, self.group) if torch.is_grad_enabled() else x

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's heads' output, gathered on the feature axis."""
        return _Gather.apply(y, self.group)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial products (after row-parallel ones)."""
        return _Reduce.apply(y, self.group)


def place_sequence(model: nn.Module, group: dist.Group) -> None:
    """Sequence parallelism (JAX's ``sequence_sharding``), in place: the
    denoiser takes and returns this rank's contiguous slice of the time
    axis (:func:`sequence_shard`), and its efficient self-attention and
    interaction blocks reduce over time across ``group``. The efficient,
    non-causal interaction stack only (JAX's SP denoiser); forward only."""
    den = model.denoiser
    blocks = [m for m in den.modules() if hasattr(m, "sp")]
    if den.single_transformer or not blocks or any(m.causal for m in blocks):
        raise ValueError("sequence parallelism takes the efficient, non-causal "
                         "interaction stack")
    den.sequence = group
    for m in blocks:
        m.sp = group


def sequence_shard(x, group: dist.Group):
    """This rank's contiguous slice of the time axis (2) of (B, actors, T,
    ...) motion: JAX's ``sequence_sharding`` of P(None, None, model)."""
    T, S = x.shape[2], group.size
    if T % S:
        raise ValueError(f"time axis {T} not divisible over {S} ranks")
    i = group.index()
    return x[:, :, i * T // S:(i + 1) * T // S]


def tp_modules(model: nn.Module) -> list:
    """The modules that run tensor-parallel: every block with a ``tp``
    attribute (the attention blocks, the FFNs and the text suffix's
    post-LN layers)."""
    return [m for m in model.modules() if hasattr(m, "tp")]


def place_tp(model: nn.Module, cfg, group: dist.Group) -> dict[str, int | None]:
    """Tensor-parallel placement, in place: each weight the rule shards is
    replaced by this rank's shard (a new Parameter of the shard's shape),
    and every block that has a ``tp`` attribute runs on ``group``. Returns
    the sharded dimension of every parameter. Raises when a block's heads
    or a sharded width do not divide over the group."""
    S = group.size
    dims = shard_dims(cfg, S, "tp")
    for m in tp_modules(model):
        heads = getattr(m, "num_heads", None) or getattr(m, "heads", None)
        if heads is not None and hasattr(m, "query") and heads % S:
            raise ValueError(f"tensor parallelism over {S} ranks needs the heads ({heads}) "
                             f"to divide by {S}")
    for m_name, m in model.named_modules():
        for leaf in ("query", "key", "value", "linear1", "linear2"):
            sub = getattr(m, leaf, None)
            if isinstance(sub, nn.Linear) and hasattr(m, "tp"):
                name = f"{m_name}.{leaf}.weight" if m_name else f"{leaf}.weight"
                if dims.get(name) is None:
                    raise ValueError(f"tensor parallelism over {S} ranks: {name} "
                                     f"{tuple(sub.weight.shape)} does not divide")
    index = group.index()
    for name, p in list(model.named_parameters()):
        dim = dims[name]
        if dim is None:
            continue
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        setattr(module, leaf, nn.Parameter(shard(p, dim, index, S),
                                           requires_grad=p.requires_grad))
    tp = TensorParallel(group) if S > 1 else None
    for m in tp_modules(model):
        m.tp = tp
    return dims
