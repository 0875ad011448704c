"""Destination-tiled segment sum from a host plan.

Replaces ``thallo_tpu/ops/segsum.py::pallas_segment_sum`` (and its host
``SegSumPlan``/``build_plan``, copied here).  At init the destination
ids of the M data rows are sorted on the host and the destination space
is cut into tiles of ``tile_n`` segments; tile t's rows are a contiguous
run of the sorted order, padded to a common width TE:

  gather_idx [T, TE]     data row of lane (t, e); M (one past the end)
                         on padded lanes
  rel        [T, TE]     destination of the lane within its tile
  mask       [T, TE, 1]  1 on real lanes, 0 on padded ones

  out[t*tile_n + rel[t, e], c] += data[gather_idx[t, e], c] * mask[t, e]

for ``data [M, C]`` -> ``out [num_segments, C]``.  Padded lanes
contribute exactly 0, whatever the data holds.

On the card (``csrc/segsum.cu``): the TPU kernel builds a [TE, tile_n]
one-hot per tile in VMEM and contracts it on the MXU; here a tile's
lanes are split into chunks of ``CHUNK`` lanes, one thread block per
(tile, chunk), so that a plan with few, long tiles (a small image's
T = 8 tiles of ~125k lanes) still spreads over every SM.  A block sums
its lanes into a [tile_n, C] accumulator in shared memory (shared-memory
atomics) and then adds each nonzero accumulator entry into the output
with one global atomic.  The bound is the bytes: the plan (12 bytes a
lane) and the gathered rows; sums are plain f32 whose order varies with
the atomics.  ``data`` may be a strided view (the port's channel-major
[C, M] buffers transposed), which the kernel reads through its strides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _cuda

CHUNK = 2048  # plan lanes per thread block (csrc/segsum.cu)


@dataclasses.dataclass
class SegSumPlan:
    gather_idx: torch.Tensor  # [T, TE] int32 into the data rows (M = pad row)
    rel: torch.Tensor  # [T, TE] int32 within-tile destination (0..tile_n-1)
    mask: torch.Tensor  # [T, TE, 1] float32 {0, 1}
    tile_n: int = 128
    num_segments: int = 0


def build_plan(ids, num_segments: int, tile_n: int = 128, max_waste: float = 8.0,
               device=None) -> Optional[SegSumPlan]:
    """Host-side static plan for `ids` (destination per row), the same
    arrays as thallo_tpu's build_plan; None when the padding would exceed
    `max_waste` times the rows (a degenerate distribution)."""
    ids = np.asarray(ids)
    M = ids.shape[0]
    if M == 0:
        return None
    order = np.argsort(ids, kind="stable").astype(np.int32)
    sorted_ids = ids[order]
    T = -(-num_segments // tile_n)
    T = -(-T // 8) * 8  # tile count padded to a multiple of 8, as in thallo_tpu
    tile_of = sorted_ids // tile_n
    counts = np.bincount(tile_of, minlength=T)
    te = int(counts.max())
    TE = max(8, -(-te // 8) * 8)
    if TE * T > max_waste * M + 8 * T:
        return None  # too much padding: degenerate distribution
    gather_idx = np.full((T, TE), M, np.int32)
    rel = np.zeros((T, TE), np.int32)
    mask = np.zeros((T, TE, 1), np.float32)
    starts = np.cumsum(counts) - counts
    pos = np.arange(M) - starts[tile_of]
    gather_idx[tile_of, pos] = order
    rel[tile_of, pos] = sorted_ids - tile_of * tile_n
    mask[tile_of, pos] = 1.0
    return SegSumPlan(
        gather_idx=torch.from_numpy(gather_idx).to(device),
        rel=torch.from_numpy(rel).to(device),
        mask=torch.from_numpy(mask).to(device),
        tile_n=tile_n,
        num_segments=num_segments,
    )


def segment_sum_reference(data, plan: SegSumPlan):
    """Plain torch version (f32): the CPU path and the card-side oracle."""
    M, C = data.shape
    T, TE = plan.gather_idx.shape
    padded = torch.cat([data.to(torch.float32),
                        torch.zeros((1, C), dtype=torch.float32, device=data.device)])
    g = padded.index_select(0, plan.gather_idx.reshape(-1).long()) * plan.mask.reshape(-1, 1)
    tiles = torch.arange(T, device=data.device)[:, None] * plan.tile_n
    dest = (tiles + plan.rel).reshape(-1).long()
    out = torch.zeros((T * plan.tile_n, C), dtype=torch.float32, device=data.device)
    return out.index_add_(0, dest, g)[:plan.num_segments]


def segment_sum(data, plan: SegSumPlan):
    """data [M, C] f32 (any strides) -> [num_segments, C] f32, summed per
    the plan.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if data.device.type == "cpu":
        return segment_sum_reference(data, plan)
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {data.device}")
    M, C = data.shape
    T, TE = plan.gather_idx.shape
    dev = data.device
    if data.dtype != torch.float32:
        raise ValueError(f"data: expected torch.float32, got {data.dtype}")
    if min(data.stride()) < 0:
        raise ValueError("data: negative strides are not supported")
    _cuda.require(plan.gather_idx, "gather_idx", (T, TE), torch.int32, dev)
    _cuda.require(plan.rel, "rel", (T, TE), torch.int32, dev)
    _cuda.require(plan.mask, "mask", (T, TE, 1), torch.float32, dev)
    if plan.tile_n * C * 4 > _cuda.MAX_DYNAMIC_SMEM:
        raise ValueError(f"segment_sum: tile_n*C = {plan.tile_n * C} floats exceed "
                         f"the {_cuda.MAX_DYNAMIC_SMEM}-byte accumulator")
    out = torch.zeros((plan.num_segments, C), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_segment_sum(
        data.data_ptr(), data.stride(0), data.stride(1), plan.gather_idx.data_ptr(),
        plan.rel.data_ptr(), plan.mask.data_ptr(), out.data_ptr(), M, C, T, TE,
        plan.tile_n, plan.num_segments, CHUNK, _cuda.stream(data))
    _cuda.check(code, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
