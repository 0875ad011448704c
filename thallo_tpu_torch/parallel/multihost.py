"""Joining the ranks of a multi-process job (counterpart of
``thallo_tpu/parallel/multihost.py``).

JAX's ``jax.distributed.initialize`` becomes
``torch.distributed.init_process_group``: every process runs the same
program, and a mesh over the whole world (``global_mesh``) shards a plan
across processes and hosts exactly as within one.  Nothing on a machine
tells a process of its cluster: the coordinator's address, the number of
processes and each one's id are given.  The backend suits the plan's
device: ``"nccl"`` for plans on the card (one card a process), ``"gloo"``
for plans on the CPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device: str = "cuda"):
    """Join the job at tcp://coordinator_address (host:port) as process
    process_id of num_processes, over NCCL for plans on the card (this
    process then works on card process_id % the cards it sees) or Gloo for
    plans on the CPU."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; pass "
                               "device='cpu' to join over gloo")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def is_coordinator() -> bool:
    """Rank 0 (or the one process of a job that never joined)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(axis_names=("x",), shape=None):
    """A mesh over every rank of the job."""
    from .mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n_devices=n, axis_names=axis_names, shape=shape)


def checkpoint_per_host(plan, path_fmt: str):
    """The solver state written once, from rank 0, to
    path_fmt.format(process=0).  Every rank calls it: a sharded plan's
    unknowns are gathered to rank 0 first."""
    path = path_fmt.format(process=0)
    if plan.mesh is not None:
        plan.save_state(path)  # a collective: rank 0 writes
    elif is_coordinator():
        plan.save_state(path)
