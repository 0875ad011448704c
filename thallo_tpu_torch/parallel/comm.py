"""The port's one door to ``torch.distributed``: the collectives of a
sharded step, each a thin wrapper that appends (kind, bytes of its
per-rank result) to the active recorder.

JAX gets its collectives from XLA's SPMD partitioner and counts them in
the compiled step's HLO (``thallo_tpu/parallel/mesh.py:233-272``); the
port issues each one itself, so the record of one step (``recording``)
is its counterpart of that count.  The kinds are JAX's names:
``all_gather``, ``reduce_scatter``, ``all_reduce``.  Collectives made
while a plan is being sharded (``agree``, ``broadcast_object``) are
set-up, not part of a step, and record nothing.

Every call here is collective: each rank of the group must make the same
calls in the same order.  A group of None is the default process group.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

_record: Optional[List[Tuple[str, int]]] = None


@contextlib.contextmanager
def recording():
    """Record the collectives made inside the block: yields the list of
    (kind, bytes of the per-rank result) it fills."""
    global _record
    prev, _record = _record, []
    try:
        yield _record
    finally:
        _record = prev


def _note(kind: str, t: torch.Tensor) -> None:
    if _record is not None:
        _record.append((kind, t.numel() * t.element_size()))


@contextlib.contextmanager
def _quiet():
    """all_gather_into_tensor and reduce_scatter_tensor exist in every
    torch the port runs on; newer ones warn that they are deprecated (for
    names that older ones lack), which says nothing here."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def world_size(group=None) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks, in place (a batch of scalars, or a small
    replicated image); returns t."""
    dist.all_reduce(t, group=group)
    _note("all_reduce", t)
    return t


def all_gather(shard: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' shards concatenated along dim 0, in rank order."""
    shard = shard.contiguous()
    out = shard.new_empty((world_size(group) * shard.shape[0],) + tuple(shard.shape[1:]))
    with _quiet():
        dist.all_gather_into_tensor(out, shard, group=group)
    _note("all_gather", out)
    return out


def reduce_scatter(full: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of `full`, split along dim 0: this rank's
    block."""
    full = full.contiguous()
    n = world_size(group)
    out = full.new_empty((full.shape[0] // n,) + tuple(full.shape[1:]))
    with _quiet():
        dist.reduce_scatter_tensor(out, full, group=group)
    _note("reduce_scatter", out)
    return out


def agree(values, device, group=None) -> bool:
    """Whether every rank holds the same list of small integers (set-up
    only: a check that the ranks took the same decisions)."""
    t = torch.tensor(list(values), dtype=torch.int64, device=device)
    lo, hi = t.clone(), t.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(lo, hi))


def all_min(values, device, group=None) -> List[int]:
    """The elementwise minimum over the ranks of a list of small integers
    (set-up only)."""
    t = torch.tensor(list(values), dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t.tolist()


def broadcast_object(obj, src: int = 0, device=None, group=None):
    """A picklable object from rank `src` to every rank (set-up only:
    a checkpoint read on the coordinator)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group, device=device)
    return box[0]
