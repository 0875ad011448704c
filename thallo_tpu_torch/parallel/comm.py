"""The port's one door to ``torch.distributed``: the collectives of a
sharded step, each a thin wrapper that appends (kind, bytes of its
per-rank result) to the active recorder.

JAX gets its collectives from XLA's SPMD partitioner and counts them in
the compiled step's HLO (``thallo_tpu/parallel/mesh.py:233-272``); the
port issues each one itself, so the record of one step (``recording``)
is its counterpart of that count.  The kinds are JAX's names:
``all_gather``, ``reduce_scatter``, ``all_reduce``, and
``collective_permute`` for a halo exchange with the neighbour ranks of a
mesh axis (``halo_exchange`` and its transpose ``halo_reduce``, by
``batch_isend_irecv``).  Collectives made
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


def _self_copy(group=None) -> bool:
    """Whether an exchange with this process's own rank (a mesh axis of
    one rank: the block's torus wrap) is a local copy: on gloo, which has
    no pair to its own rank, and inside a CUDA graph capture, where NCCL's
    send to its own rank hung on an H100 (PERF.md); NCCL runs it eagerly."""
    return "nccl" not in str(dist.get_backend(group)) or \
        torch.cuda.is_current_stream_capturing()


def _swap(send_up, send_down, lower, upper, group=None):
    """send_up to the upper neighbour and send_down to the lower one; returns
    (what the lower neighbour sent up, what the upper one sent down).  Two
    batches, one a direction, so that two ranks that are each other's lower
    and upper neighbour match their sends in order."""
    me = dist.get_rank()
    if lower == me and upper == me and _self_copy(group):
        return send_up, send_down, False
    from_lower, from_upper = torch.empty_like(send_up), torch.empty_like(send_down)
    for ops in ([dist.P2POp(dist.isend, send_up, upper, group),
                 dist.P2POp(dist.irecv, from_lower, lower, group)],
                [dist.P2POp(dist.isend, send_down, lower, group),
                 dist.P2POp(dist.irecv, from_upper, upper, group)]):
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return from_lower, from_upper, True


def halo_exchange(block: torch.Tensor, dim: int, h: int, lower: int, upper: int,
                  group=None) -> torch.Tensor:
    """The block extended by h slabs of each torus neighbour along `dim`:
    [the lower neighbour's last h | block | the upper neighbour's first h]
    (lower, upper: their global ranks; this rank's own on an axis of one
    rank).  Recorded as one collective_permute of the two slabs received
    (none for a local copy)."""
    if h == 0:
        return block
    n = block.shape[dim]
    first = block.narrow(dim, 0, h).contiguous()
    last = block.narrow(dim, n - h, h).contiguous()
    from_lower, from_upper, moved = _swap(last, first, lower, upper, group)
    if moved and _record is not None:
        _record.append(("collective_permute", 2 * first.numel() * first.element_size()))
    return torch.cat([from_lower, block, from_upper], dim)


def halo_reduce(ext: torch.Tensor, dim: int, h: int, lower: int, upper: int,
                group=None) -> torch.Tensor:
    """Transpose of halo_exchange: the block of an extended tensor [h | B |
    h] along `dim`, with the halos' partial sums sent back to their owners
    and the neighbours' added in (the upper neighbour's lower halo into the
    block's last h slabs, the lower one's upper halo into its first h).
    Recorded as one collective_permute of the two slabs received."""
    if h == 0:
        return ext
    n = ext.shape[dim] - 2 * h
    lo_halo = ext.narrow(dim, 0, h).contiguous()
    hi_halo = ext.narrow(dim, n + h, h).contiguous()
    from_lower, from_upper, moved = _swap(hi_halo, lo_halo, lower, upper, group)
    if moved and _record is not None:
        _record.append(("collective_permute", 2 * lo_halo.numel() * lo_halo.element_size()))
    out = ext.narrow(dim, h, n).clone()
    out.narrow(dim, 0, h).add_(from_lower)
    out.narrow(dim, n - h, h).add_(from_upper)
    return out
