"""Multi-process runtime over ``torch.distributed`` (counterpart of
``hig_tpu/parallel/distributed.py``).

JAX runs one process per host and every jitted computation as one SPMD
program over the global mesh. The port runs one process per rank (one per
card, or ranks sharing a card) and moves data with explicit collectives,
all of which are here: :func:`all_reduce`, :func:`all_gather` and
:func:`reduce_scatter` on a dimension (and their ``_many`` forms, one
collective over several tensors), :func:`broadcast`, :func:`send` and
:func:`recv`.

Setup. :func:`initialize` takes the coordinator's ``host:port``, the
process count and this process's index, or reads ``HIG_COORDINATOR``,
``HIG_NUM_PROCESSES`` and ``HIG_PROCESS_ID`` as JAX's does. Over several
hosts a rank's place on its host comes from ``torchrun``'s
``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` (:func:`local_layout`; without
them every process is on one host). The backend is explicit
(:func:`pick_backend`): NCCL when each rank of a host has a card of its
own (local rank r on ``cuda:r``), gloo on the CPU, and gloo when ranks
share a card (more ranks on a host than cards), which only a one-card
check does: NCCL refuses two ranks on one device.

Gloo on CUDA tensors. Gloo runs its collectives on host memory, so where
the backend is gloo and a tensor lies on the card, :func:`_host` copies it
to the host, the collective runs there, and the result is copied back to
the tensor's device. That is the only place any data leaves the card, and
it moves only what the collective moves: compute never drops to the CPU.
Gloo has no reduce-scatter on every torch version, so there
:func:`reduce_scatter` is an all-reduce and a slice.

A :class:`Group` names a set of ranks (a row or column of the mesh); a
group of one rank makes every collective the identity, so one-process runs
go through the same code without a process group.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

_STATE: dict = {}  # backend and device of this process, once initialized


def pick_backend(device_type: str, ranks_per_host: int, cards: int) -> str:
    """"nccl" when ranks run on CUDA and each rank of a host has a card of
    its own, else "gloo" (the CPU, or ranks sharing a card)."""
    if device_type == "cuda" and cards >= ranks_per_host:
        return "nccl"
    return "gloo"


def local_layout(num_processes: int, process_id: int, env=os.environ) -> tuple[int, int]:
    """(ranks on this host, this rank's index among them): ``torchrun``'s
    ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` where set, else every process
    on one host."""
    per_host = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    return per_host, int(env.get("LOCAL_RANK", process_id % per_host))


def rank_device(device_type: str, backend: str, local_rank: int, cards: int) -> torch.device:
    """The device a rank computes on: its own card under NCCL, a shared card
    (``local_rank`` modulo the cards) under gloo on CUDA, else the CPU. A
    CUDA rank never falls back to the CPU: no card raises."""
    if device_type != "cuda":
        return torch.device("cpu")
    if cards < 1:
        raise RuntimeError("a CUDA rank needs a card; no GPU is visible "
                           "(pass --device cpu for the CPU)")
    return torch.device("cuda", local_rank if backend == "nccl" else local_rank % cards)


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> torch.device:
    """Idempotent ``init_process_group`` with the ``HIG_*`` fallbacks
    (module doc); returns this rank's device. Without a coordinator and
    with at most one process it is a one-process run: no process group, and
    ``device`` is returned as given."""
    if _STATE:
        return _STATE["device"]
    coordinator = coordinator or os.environ.get("HIG_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("HIG_NUM_PROCESSES", 1))
    if process_id is None:
        process_id = int(os.environ.get("HIG_PROCESS_ID", 0))
    if num_processes <= 1 and coordinator is None:
        return torch.device(device)
    device_type = torch.device(device).type
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator host:port "
                         "(HIG_COORDINATOR)")
    ranks_per_host, local_rank = local_layout(num_processes, process_id)
    backend = pick_backend(device_type, ranks_per_host, cards)
    here = rank_device(device_type, backend, local_rank, cards)
    if here.type == "cuda":
        torch.cuda.set_device(here)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _STATE.update(backend=backend, device=here)
    return here


def shutdown() -> None:
    """Destroy the process group (if any) and forget the setup."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()
    _GROUPS.clear()


def backend() -> str | None:
    return _STATE.get("backend")


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns logs, metrics and checkpoints (rank 0)."""
    return process_index() == 0


def require_one_process(entry: str) -> None:
    """Raise when ``entry`` is started as one of several ranks (a process
    group of more than one, or ``HIG_NUM_PROCESSES`` > 1): it runs on one
    rank only, and must not run silently on each."""
    count = process_count() if dist.is_available() and dist.is_initialized() else \
        int(os.environ.get("HIG_NUM_PROCESSES", 1))
    if count > 1:
        raise RuntimeError(f"{entry} runs on one rank; its multi-rank form is not ported "
                           f"(ROADMAP, Queue A): start it as one process, not {count}")


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Group:
    """A set of global ranks and its process group (None for one rank)."""

    ranks: tuple
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def index(self, rank: int | None = None) -> int:
        """The position of ``rank`` (default: this process) in the group."""
        return self.ranks.index(process_index() if rank is None else rank)


def new_group(ranks) -> Group:
    """A :class:`Group` of ``ranks``, made once per process group and set of
    ranks and reused after. Every process must call it for every group, in
    the same order (``torch.distributed.new_group``'s rule)."""
    ranks = tuple(int(r) for r in ranks)
    key = (id(dist.group.WORLD), ranks)
    if key not in _GROUPS:
        _GROUPS[key] = Group(ranks, dist.new_group(list(ranks)) if len(ranks) > 1 else None)
    return _GROUPS[key]


_GROUPS: dict = {}  # the groups made, by (the world's process group, ranks)


def _staged(t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` runs on a host copy (gloo on a CUDA
    tensor, the module doc)."""
    return _STATE.get("backend") == "gloo" and t.is_cuda


def _empty(t: torch.Tensor) -> torch.Tensor:
    """An uninitialized tensor shaped as ``t`` where a collective on ``t``
    runs: a page-locked host buffer when staged, else on ``t``'s device."""
    if _staged(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the collective runs: a host copy when staged, else
    ``t`` itself, contiguous."""
    if _staged(t):
        return _empty(t).copy_(t.detach())
    return t.detach().contiguous()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") of ``t`` over the group's
    ranks, a new tensor on ``t``'s device (``t`` itself for one rank)."""
    if group.size == 1:
        return t
    buf = _host(t).clone()
    dist.all_reduce(buf, op=_OPS[op], group=group.pg)
    return buf.to(t.device)


def all_reduce_many(tensors: list, group: Group) -> None:
    """Sum each of ``tensors`` over ``group`` in place, in one collective
    over their concatenation."""
    if group.size == 1 or not tensors:
        return
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_gather(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in the group's rank order."""
    if group.size == 1:
        return t
    parts = [_empty(t) for _ in range(group.size)]
    dist.all_gather(parts, _host(t), group=group.pg)
    return torch.cat([p.to(t.device) for p in parts], dim)


def all_gather_many(tensors: list, dims: list, group: Group) -> list:
    """:func:`all_gather` of each of ``tensors`` on its dimension, in one
    collective over their concatenation."""
    if group.size == 1:
        return list(tensors)
    flat = all_gather(torch.cat([t.reshape(-1) for t in tensors]), 0, group)
    sizes = [t.numel() for t in tensors]
    per_rank = flat.chunk(group.size)
    pieces = [part.split(sizes) for part in per_rank]
    return [torch.cat([p[i].view_as(t) for p in pieces], d)
            for i, (t, d) in enumerate(zip(tensors, dims))]


def reduce_scatter_many(tensors: list, dims: list, group: Group) -> list:
    """:func:`reduce_scatter` of each of ``tensors`` on its dimension, in
    one collective: each rank's chunks laid out together."""
    if group.size == 1:
        return list(tensors)
    chunks = [t.chunk(group.size, d) for t, d in zip(tensors, dims)]
    flat = torch.cat([c[r].reshape(-1) for r in range(group.size) for c in chunks])
    mine = reduce_scatter(flat, 0, group)
    shapes = [c[0].shape for c in chunks]
    return [m.view(shape) for m, shape in zip(mine.split([math.prod(s) for s in shapes]),
                                              shapes)]


def reduce_scatter(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's chunk (on ``dim``, in group order) of the sum of ``t``
    over the group; under gloo an all-reduce and a slice."""
    if group.size == 1:
        return t
    if _STATE.get("backend") == "nccl":
        chunks = list(t.detach().chunk(group.size, dim))
        out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
        src = torch.cat([c.contiguous().flatten() for c in chunks])
        flat = torch.empty(out.numel(), device=t.device, dtype=t.dtype)
        dist.reduce_scatter_tensor(flat, src, group=group.pg)
        return flat.view_as(out)
    return all_reduce(t, group).chunk(group.size, dim)[group.index()].contiguous()


def broadcast(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of the group (each rank
    passes a tensor of the same shape and dtype)."""
    if group.size == 1:
        return t
    buf = _host(t).clone()
    dist.broadcast(buf, src, group=group.pg)
    return buf.to(t.device)


def send(t: torch.Tensor, dst: int) -> None:
    """Send ``t`` to global rank ``dst`` (blocking)."""
    dist.send(_host(t), dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor shaped as ``like`` received from global rank ``src``, on
    ``like``'s device."""
    buf = _empty(like)
    dist.recv(buf, src)
    return buf.to(like.device)
