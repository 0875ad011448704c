"""Segment sum from a host plan sorted by destination.

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
contribute exactly 0, whatever the data holds.  These arrays equal
thallo_tpu's and drive the plain version.

On the card (``csrc/segsum.cu``) the TPU kernel's [TE, tile_n] one-hot
contraction has no counterpart.  The kernel is bound by bytes, and what
the plan guarantees is that the lanes are sorted by destination, so a
destination's lanes are one contiguous run.  ``build_plan`` keeps that
order in a compact form beside the tiled arrays:

  order      [L]      data row of each real lane, by destination (stable)
  seg_start  [S + 1]  CSR offsets: segment s owns lanes
                      order[seg_start[s]:seg_start[s + 1]]

4 bytes a lane instead of 12, no mask, no padded lanes, no empty tiles.
Each run is summed in lane order, without atomics and without a shared
accumulator, so every output row is written exactly once (``out`` is
``torch.empty``; an empty segment writes its own 0) and the result is the
same from run to run.  How runs map onto threads is chosen once, from the
run lengths, in ``choose_modes``:

  "thread"  one thread per (run, channel): short runs (a point seen by a
            few cameras)
  "warp"    one warp per run, the lanes striding over it, a shuffle tree
            at the end: long runs (a camera seen by ~1000 points)

and a run longer than ``piece`` lanes is first cut into pieces of at most
that many: level 1 sums each piece into a ``[pieces, C]`` scratch, level
2 sums each segment's pieces (``seg_piece`` [S + 1], CSR over pieces)
with the same two kernels, so one camera that owns half of a skewed
scene's observations is spread over the card.  A plan built ``in_order``
takes one level of "thread" whatever its runs: each run is summed by one
thread from 0 in ascending data row, the order in which the CPU's
``index_add_`` (and this module's plain version) adds, so card and CPU
give the same bits.  ``data`` may be a strided
view (the port's channel-major [C, M] buffers transposed); the kernel
reads through the strides and specialises the unit row stride.

Long runs gathered from channel-major data are the one case the sorted
order serves badly: a camera's rows lie ~M/S apart, so every 4-byte value
costs a 32-byte sector.  For a plan of few segments and long runs
(``staged_eligible``) ``build_plan`` also keeps the lanes sorted by
(chunk of ``STAGED_ROWS`` data rows, destination):

  local       [L]         row of each lane within its chunk
  cell_start  [K*S + 1]   CSR offsets of cell (chunk k, segment s) = k*S + s

and, for the ring kernel (``csrc/segsum.cu``, the staged route on data
with unit row stride), G = min(K, ``STAGED_BLOCKS``) blocks, each owning
a contiguous range of chunks:

  block_chunk [G + 1]     block g owns chunks [block_chunk[g], block_chunk[g + 1])

A block streams its chunks through a ring of shared-memory stages
(cp.async: the copy of the next chunks overlaps the sums of this one),
keeps each (segment, channel) sum of its whole range in registers, adding
the lanes in (chunk, lane) order, writes its [S, C] sums as one slab of a
``[G, S, C]`` scratch, and a second kernel adds each segment's G rows in
a fixed order.  The same
guarantees: no atomic, every output written once, a fixed order.  The
first staged body, ``segment_sum_per_chunk[_f64]``, reads the same form one
block per chunk (the whole tile loaded, then summed) into a ``[S, K, C]``
scratch (``seg_chunks`` [S + 1] = s*K), kept beside the ring kernel
(which measured faster in f32 and f64 on the H100) but on no route.
``BODY_LAUNCHES`` counts each body's launches: "runs", "ring",
"per_chunk", "fixed_order".

A plan built ``fixed_order`` (``lower.fixed_order_plan``: the small-image
scatters) also keeps its runs cut into blocks, each a contiguous range of
about ``ORDER_LANES`` sorted lanes, a run wholly in the block where it
starts:

  block_run  [G + 1]  block b owns runs [block_run[b], block_run[b + 1])
  block_lane [G + 1]  and so lanes [block_lane[b], block_lane[b + 1])

and ``segment_sum_fixed_order`` (``csrc/segsum.cu``
``run_sum_staged_order_kernel``) sums it in one launch: a block copies its
lanes' values into shared memory (every load before any sum), then each
run is added from there, in order (``in_order``: one thread a run from 0
in ascending data row, the CPU's order and bits) or as a tree (sorted
runs: the block's warps split over at most ``ORDER_THREADS`` / 32 runs, a
fixed order).  ``segment_sum`` sends such a plan there.  The first body
of these plans is ``segment_sum`` on the plan ``build_plan`` makes without
the form (in order up to runs of 32, else sorted runs).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda

THREAD, WARP = 0, 1  # csrc/segsum.cu kernel ids
# a plan whose non-empty runs average at most this many lanes is summed
# one thread per (run, channel), its runs cut at THREAD_PIECE lanes
SHORT_RUN = 8
THREAD_PIECE = 32
# a plan of long runs is cut so that about this many warps share the
# lanes (H100, 1M rows into 1024 segments: 4096 was fastest of 1024-32768,
# scripts/torch_redesign_sweep.py --sweep)
TARGET_PIECES = 4096
# level 2 takes one thread per (segment, channel) up to this many pieces
# in a segment, one warp per segment beyond
THREAD_MAX_PIECES = 32
# the staged kernels (channel-major data through shared memory): data rows
# per chunk (the ring kernel's stage: 9 channels of 1024 rows, the cell
# offsets and the lanes take 45 KB in f32, three stages a block, and 82 KB
# in f64, two stages), the ring kernel's blocks (one an H100 SM: its ring
# takes most of the SM's shared memory), and the plans the staged route
# serves: at most STAGED_MAX_SEGMENTS segments (the cell table holds K*S
# offsets; a ring thread sums at most 4 segments) averaging at least
# STAGED_MIN_RUN rows, none owning more than 1/STAGED_MAX_SHARE of all
# rows (a thread sums a cell alone).  The first staged body's chunk was
# 2048 rows (H100 sweep over 1024-4096, scripts/torch_redesign_sweep.py
# --sweep: 9 channels, the lanes and the cells in 86 KB, two blocks an SM)
STAGED_ROWS = 1024
PER_CHUNK_ROWS = 2048
STAGED_BLOCKS = 132
STAGED_MAX_SEGMENTS = 2048
STAGED_MIN_RUN = 64
STAGED_MAX_SHARE = 16
BODY_LAUNCHES = collections.Counter()  # "runs", "ring", "per_chunk", "fixed_order"
# the fixed-order kernel (csrc/segsum.cu kOrderThreads, kOrderMaxTile):
# threads a block, the most lanes it stages at once, and the lanes a block
# owns (about: a run is never cut); an in-order block sums at most
# ORDER_THREADS runs (a thread each), a tree block ORDER_THREADS / 32
ORDER_THREADS = 256
ORDER_TILE = 1024
ORDER_LANES = 256


@dataclasses.dataclass
class SegSumPlan:
    gather_idx: torch.Tensor  # [T, TE] int32 into the data rows (M = pad row)
    rel: torch.Tensor  # [T, TE] int32 within-tile destination (0..tile_n-1)
    mask: torch.Tensor  # [T, TE, 1] float32 {0, 1}
    tile_n: int = 128
    num_segments: int = 0
    # the compact form (module docstring); build_plan fills it, a plan
    # made by hand gets it on first use (compact())
    order: Optional[torch.Tensor] = None  # [L] int32
    seg_start: Optional[torch.Tensor] = None  # [S + 1] int32
    modes: Tuple[int, ...] = ()  # (level 1,) or (level 1, level 2): THREAD | WARP
    piece_start: Optional[torch.Tensor] = None  # [P + 1] int32 lanes, two levels only
    seg_piece: Optional[torch.Tensor] = None  # [S + 1] int32 pieces, two levels only
    max_row: int = -1  # largest data row the plan reads
    # the staged form (module docstring), for plans staged_eligible accepts
    local: Optional[torch.Tensor] = None  # [L] int32
    cell_start: Optional[torch.Tensor] = None  # [K*S + 1] int32
    seg_chunks: Optional[torch.Tensor] = None  # [S + 1] int32: s*K
    n_chunks: int = 0  # K
    staged_rows: int = 0  # T: data rows a chunk
    block_chunk: Optional[torch.Tensor] = None  # [G + 1] int32: the ring blocks' chunks
    n_blocks: int = 0  # G
    block_span: int = 0  # the most chunks a block owns
    # the fixed-order form (module docstring), for plans built fixed_order
    block_run: Optional[torch.Tensor] = None  # [G + 1] int32: runs a block
    block_lane: Optional[torch.Tensor] = None  # [G + 1] int32: its lanes
    order_tile: int = 0  # lanes staged at once: the widest block, at most ORDER_TILE

    def validate(self) -> None:
        """Shapes, types and devices of the plan's tensors, checked once
        (at build, or when the compact form is derived), not per call."""
        T, TE = self.gather_idx.shape
        dev = self.gather_idx.device
        _cuda.require(self.gather_idx, "gather_idx", (T, TE), torch.int32, dev)
        _cuda.require(self.rel, "rel", (T, TE), torch.int32, dev)
        _cuda.require(self.mask, "mask", (T, TE, 1), torch.float32, dev)
        if self.order is None:
            return
        S, L = self.num_segments, self.order.shape[0]
        _cuda.require(self.order, "order", (L,), torch.int32, dev)
        _cuda.require(self.seg_start, "seg_start", (S + 1,), torch.int32, dev)
        if len(self.modes) not in (1, 2) or any(m not in (THREAD, WARP) for m in self.modes):
            raise ValueError(f"modes: expected 1 or 2 of THREAD/WARP, got {self.modes}")
        if (len(self.modes) == 2) != (self.piece_start is not None):
            raise ValueError("piece_start/seg_piece go with a two-level plan only")
        if self.piece_start is not None:
            P = self.piece_start.shape[0] - 1
            _cuda.require(self.piece_start, "piece_start", (P + 1,), torch.int32, dev)
            _cuda.require(self.seg_piece, "seg_piece", (S + 1,), torch.int32, dev)
        if self.local is not None:
            _cuda.require(self.local, "local", (L,), torch.int32, dev)
            _cuda.require(self.cell_start, "cell_start", (self.n_chunks * S + 1,),
                          torch.int32, dev)
            _cuda.require(self.seg_chunks, "seg_chunks", (S + 1,), torch.int32, dev)
            _cuda.require(self.block_chunk, "block_chunk", (self.n_blocks + 1,), torch.int32,
                          dev)
        if self.block_run is not None:
            G = self.block_run.shape[0] - 1
            _cuda.require(self.block_run, "block_run", (G + 1,), torch.int32, dev)
            _cuda.require(self.block_lane, "block_lane", (G + 1,), torch.int32, dev)
            if self.piece_start is not None or not 1 <= self.order_tile <= ORDER_TILE:
                raise ValueError("the fixed-order form: one level, 1 <= order_tile <= "
                                 f"{ORDER_TILE}")

    def compact(self) -> "SegSumPlan":
        """This plan with its compact form; derived here, once, for a plan
        that was not made by build_plan: a stable sort of the unmasked
        lanes by destination t*tile_n + rel."""
        if self.order is None:
            g = self.gather_idx.cpu().numpy()
            m = self.mask.cpu().numpy().reshape(g.shape)
            if not np.isin(m, (0.0, 1.0)).all():
                raise ValueError("mask: expected 0 on padded lanes and 1 on real ones")
            dest = (np.arange(g.shape[0], dtype=np.int64)[:, None] * self.tile_n
                    + self.rel.cpu().numpy())
            real = (m != 0) & (dest < self.num_segments)
            if real.any() and (g[real].min() < 0 or dest[real].min() < 0):
                raise ValueError("gather_idx/rel: negative entry on a real lane")
            dest, rows = dest[real], g[real]
            by_dest = np.argsort(dest, kind="stable")
            _fill_compact(self, rows[by_dest], dest[by_dest], self.gather_idx.device)
        return self


def choose_modes(counts, n_lanes: int):
    """(modes, piece) for run lengths `counts` [S] summing to n_lanes:
    the kernel of each level (module docstring) and the longest piece of
    a run; one level when no run exceeds it."""
    counts = np.asarray(counts)
    if n_lanes == 0:
        return (THREAD,), THREAD_PIECE
    if n_lanes <= SHORT_RUN * int(np.count_nonzero(counts)):
        first, piece = THREAD, THREAD_PIECE
    else:
        share = -(-n_lanes // TARGET_PIECES)
        first, piece = WARP, max(32, -(-share // 32) * 32)  # whole warp rounds
    if int(counts.max()) <= piece:
        return (first,), piece
    most = -(-int(counts.max()) // piece)
    return (first, THREAD if most <= THREAD_MAX_PIECES else WARP), piece


def staged_eligible(counts, n_lanes: int) -> bool:
    """Whether a plan with run lengths `counts` also gets the staged form:
    few segments, long runs, no run that dwarfs the others."""
    S = len(counts)
    return (0 < S <= STAGED_MAX_SEGMENTS and n_lanes >= STAGED_MIN_RUN * S
            and int(np.max(counts)) * STAGED_MAX_SHARE <= n_lanes)


def _fill_staged(plan: SegSumPlan, rows, dests, device, T: int) -> None:
    """The lanes once more, sorted by (chunk of T data rows, destination),
    as chunk-local rows and CSR offsets over the cells; the ring blocks'
    contiguous chunk ranges (an even split of the K chunks)."""
    S = plan.num_segments
    K = plan.max_row // T + 1
    if K * S >= 2 ** 31:
        return
    chunk = rows // T
    if np.bincount(chunk).max() > T:
        return  # a hand-made plan reading a row through several lanes
    cell = chunk.astype(np.int64) * S + dests
    by_cell = np.argsort(cell, kind="stable")
    plan.local = _i32(rows[by_cell] % T, device)
    plan.cell_start = _i32(
        np.concatenate([[0], np.cumsum(np.bincount(cell, minlength=K * S))]), device)
    plan.seg_chunks = _i32(np.arange(S + 1, dtype=np.int64) * K, device)
    plan.n_chunks, plan.staged_rows = K, T
    G = min(K, STAGED_BLOCKS)
    block_chunk = np.arange(G + 1, dtype=np.int64) * K // G
    plan.block_chunk = _i32(block_chunk, device)
    plan.n_blocks, plan.block_span = G, int(np.diff(block_chunk).max())


def order_blocks(counts, in_order: bool):
    """block_run [G + 1] of the fixed-order form for run lengths `counts`:
    runs taken in order into a block while it holds at most ORDER_LANES
    lanes and ORDER_THREADS runs (ORDER_THREADS / 32 as a tree); a run
    longer than ORDER_LANES is a block of its own."""
    max_runs = ORDER_THREADS if in_order else ORDER_THREADS // 32
    cuts, lanes, runs = [0], 0, 0
    for s, n in enumerate(np.asarray(counts).tolist()):
        if runs and (runs == max_runs or lanes + n > ORDER_LANES):
            cuts.append(s)
            lanes = runs = 0
        lanes += n
        runs += 1
    if runs:
        cuts.append(len(counts))
    return np.asarray(cuts, np.int64)


def _fill_compact(plan: SegSumPlan, rows, dests, device, in_order=False,
                  staged_rows: Optional[int] = None, fixed_order=False) -> None:
    """Set plan's compact form from the real lanes' data rows and
    destinations (both sorted by destination, all below num_segments);
    in_order: one level of the thread kernel, no staged form; staged_rows:
    the staged form's chunk (default STAGED_ROWS); fixed_order: one level
    (THREAD in order, else WARP), the fixed-order form, no staged form."""
    S = plan.num_segments
    if len(rows) >= 2 ** 31:
        raise ValueError(f"segment sum: {len(rows)} lanes exceed int32 offsets")
    counts = np.bincount(dests, minlength=S)[:S] if S else np.zeros(0, np.int64)
    seg_start = np.concatenate([[0], np.cumsum(counts)])
    if fixed_order:
        plan.modes, piece = ((THREAD,) if in_order else (WARP,)), 0
    else:
        plan.modes, piece = ((THREAD,), 0) if in_order else choose_modes(counts, len(rows))
    plan.piece_start = plan.seg_piece = None
    if len(plan.modes) == 2:
        n_pieces = -(-counts // piece)  # an empty segment has none
        plan.seg_piece = _i32(np.concatenate([[0], np.cumsum(n_pieces)]), device)
        # piece k of segment s starts k*piece lanes into the segment's run
        seg_of = np.repeat(np.arange(S), n_pieces)
        k = np.arange(n_pieces.sum()) - np.repeat(np.cumsum(n_pieces) - n_pieces, n_pieces)
        starts = seg_start[seg_of] + k * piece
        plan.piece_start = _i32(np.concatenate([starts, [len(rows)]]), device)
    plan.order = _i32(rows, device)
    plan.seg_start = _i32(seg_start, device)
    plan.max_row = int(rows.max()) if len(rows) else -1
    plan.local = plan.cell_start = plan.seg_chunks = plan.block_chunk = None
    plan.n_chunks = plan.staged_rows = plan.n_blocks = plan.block_span = 0
    plan.block_run = plan.block_lane = None
    plan.order_tile = 0
    if fixed_order:
        block_run = order_blocks(counts, in_order)
        block_lane = seg_start[block_run]
        plan.block_run, plan.block_lane = _i32(block_run, device), _i32(block_lane, device)
        widest = int(np.diff(block_lane).max()) if len(block_lane) > 1 else 0
        plan.order_tile = max(1, min(ORDER_TILE, widest))
    elif not in_order and staged_eligible(counts, len(rows)):
        _fill_staged(plan, np.asarray(rows), np.asarray(dests), device,
                     staged_rows or STAGED_ROWS)
    plan.validate()


def _i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def build_plan(ids, num_segments: int, tile_n: int = 128, max_waste: float = 8.0,
               device=None, in_order: bool = False,
               staged_rows: Optional[int] = None,
               fixed_order: bool = False) -> Optional[SegSumPlan]:
    """Host-side static plan for `ids` (destination per row), the same
    arrays as thallo_tpu's build_plan plus the compact form of the same
    sorted order; None when the padding would exceed `max_waste` times the
    rows (a degenerate distribution).  in_order: the card sums each run
    with one thread, in ascending data row, as the CPU's index_add_ adds
    (and the plain version here): the same bits on both, for the short
    runs lower.fixed_order_plan sends here.  staged_rows: the staged
    form's chunk (default STAGED_ROWS; PER_CHUNK_ROWS: the first staged
    body's own).  fixed_order: the fixed-order form (module docstring),
    summed in order where in_order, else as sorted runs in one level, by
    segment_sum_fixed_order."""
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
    plan = SegSumPlan(
        gather_idx=torch.from_numpy(gather_idx).to(device),
        rel=torch.from_numpy(rel).to(device),
        mask=torch.from_numpy(mask).to(device),
        tile_n=tile_n,
        num_segments=num_segments,
    )
    kept = sorted_ids < num_segments  # the tiles' tail past num_segments is cut
    _fill_compact(plan, order[kept], sorted_ids[kept], plan.gather_idx.device, in_order,
                  staged_rows, fixed_order)
    return plan


def segment_sum_reference(data, plan: SegSumPlan):
    """Plain torch version, in data's dtype (f32, or f64 under
    double_precision): the CPU path and the card-side oracle."""
    M, C = data.shape
    T, TE = plan.gather_idx.shape
    padded = torch.cat([data, torch.zeros((1, C), dtype=data.dtype, device=data.device)])
    g = padded.index_select(0, plan.gather_idx.reshape(-1).long()) * plan.mask.reshape(-1, 1).to(
        data.dtype)
    tiles = torch.arange(T, device=data.device)[:, None] * plan.tile_n
    dest = (tiles + plan.rel).reshape(-1).long()
    out = torch.zeros((T * plan.tile_n, C), dtype=data.dtype, device=data.device)
    return out.index_add_(0, dest, g)[:plan.num_segments]


def _run_sums(rows, start):
    """out[r] = sum of rows[start[r]:start[r + 1]], for rows [L, C]."""
    n_runs = start.shape[0] - 1
    runs = (start[1:] - start[:-1]).long()
    dest = torch.repeat_interleave(torch.arange(n_runs, device=rows.device), runs)
    out = torch.zeros((n_runs, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, dest, rows)


def segment_sum_staged_reference(data, plan: SegSumPlan):
    """Plain torch version driven by the staged form alone, in the ring
    kernel's order: segment_sum_ring_partials, then each segment's G
    rows."""
    return segment_sum_ring_partials(data, plan).sum(0)


def segment_sum_ring_partials(data, plan: SegSumPlan):
    """The ring kernel's [G, S, C] scratch from the staged form: each
    (block, segment) sum adds its lanes from 0 in (chunk, lane) order
    (index_add_ on the CPU adds in index order)."""
    plan = plan.compact()
    K, S, G = plan.n_chunks, plan.num_segments, plan.n_blocks
    dev = data.device
    cells = (plan.cell_start[1:] - plan.cell_start[:-1]).long()
    cell = torch.repeat_interleave(torch.arange(K * S, device=dev), cells)
    chunk, seg = cell // S, cell % S
    block = torch.bucketize(chunk, plan.block_chunk[1:].long(), right=True)
    g = data.index_select(0, chunk * plan.staged_rows + plan.local.long())
    partial = torch.zeros((G * S, data.shape[1]), dtype=data.dtype, device=dev)
    return partial.index_add_(0, block * S + seg, g).view(G, S, -1)


def segment_sum_compact_reference(data, plan: SegSumPlan):
    """Plain torch version driven by the compact form alone, level by
    level as the kernel reads it: rows gathered by `order`, summed over
    the pieces and then over each segment's pieces, or over the segments'
    runs at once."""
    plan = plan.compact()
    g = data.index_select(0, plan.order.long())
    if plan.piece_start is None:
        return _run_sums(g, plan.seg_start)
    return _run_sums(_run_sums(g, plan.piece_start), plan.seg_piece)


def segment_sum(data, plan: SegSumPlan):
    """data [M, C] f32 (any non-negative strides) -> [num_segments, C] f32,
    summed per the plan.  CPU tensors take the plain version; CUDA tensors
    launch the kernel: for a plan with the fixed-order form
    segment_sum_fixed_order's, for one with the staged form and data of
    unit row stride the ring kernel, else the sorted runs (a call's two
    levels count as one launch); f64 data goes to segment_sum_f64."""
    if data.device.type == "cpu":
        return segment_sum_reference(data, plan)
    if plan.block_run is not None:
        return segment_sum_fixed_order(data, plan)
    if data.dtype == torch.float64:
        return segment_sum_f64(data, plan)
    return _launch(segment_sum, data, plan, torch.float32)


def segment_sum_f64(data, plan: SegSumPlan):
    """segment_sum in f64 (data f64 -> [num_segments, C] f64): the f64
    instantiations of the same kernels.  CPU tensors take the plain
    version."""
    if data.device.type == "cpu":
        return segment_sum_reference(data, plan)
    if plan.block_run is not None:
        return segment_sum_fixed_order_f64(data, plan)
    return _launch(segment_sum_f64, data, plan, torch.float64)


def segment_sum_fixed_order(data, plan: SegSumPlan):
    """data [M, C] f32 (any non-negative strides) -> [num_segments, C], by
    the fixed-order kernel on a plan built fixed_order (module docstring):
    one launch, in order (the CPU's bits) or as sorted runs.  CPU tensors
    take the plain version; CUDA tensors launch the kernel; f64 data goes
    to segment_sum_fixed_order_f64."""
    if data.device.type != "cpu" and data.dtype == torch.float64:
        return segment_sum_fixed_order_f64(data, plan)
    return _fixed_order(segment_sum_fixed_order, data, plan, torch.float32)


def segment_sum_fixed_order_f64(data, plan: SegSumPlan):
    """segment_sum_fixed_order in f64 (data f64 -> [num_segments, C] f64):
    the kernel's f64 instantiation.  CPU tensors take the plain version."""
    return _fixed_order(segment_sum_fixed_order_f64, data, plan, torch.float64)


def _fixed_order(fn, data, plan, dtype):
    if data.device.type == "cpu":
        return segment_sum_reference(data, plan)
    plan = plan.compact()
    if plan.block_run is None:
        raise ValueError(f"{fn.__name__}: the plan has no fixed-order form "
                         "(build_plan(..., fixed_order=True))")
    return _launch(fn, data, plan, dtype, "fixed_order")


def segment_sum_per_chunk(data, plan: SegSumPlan):
    """The first staged body (one block per chunk, a scratch row per
    (segment, chunk)) on a plan with the staged form and f32 data of unit
    row stride: kept beside the ring kernel that replaced it on the staged
    route.  CPU tensors take the plain version; f64 data goes to
    segment_sum_per_chunk_f64."""
    if data.device.type != "cpu" and data.dtype == torch.float64:
        return segment_sum_per_chunk_f64(data, plan)
    return _per_chunk(segment_sum_per_chunk, data, plan, torch.float32)


def segment_sum_per_chunk_f64(data, plan: SegSumPlan):
    """segment_sum_per_chunk in f64.  CPU tensors take the plain version."""
    return _per_chunk(segment_sum_per_chunk_f64, data, plan, torch.float64)


def _per_chunk(fn, data, plan, dtype):
    if data.device.type == "cpu":
        return segment_sum_reference(data, plan)
    plan = plan.compact()
    if plan.local is None or data.stride(0) != 1 or data.shape[0] < 2:
        raise ValueError(f"{fn.__name__}: needs a staged plan and data of unit row stride")
    return _launch(fn, data, plan, dtype, "per_chunk")


def _launch(fn, data, plan, dtype, body="ring"):
    if data.device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {data.device}")
    plan = plan.compact()
    M, C = data.shape
    S = plan.num_segments
    if dtype not in (torch.float32, torch.float64) or data.dtype != dtype:
        raise ValueError(f"data: expected {dtype}, got {data.dtype}")
    f64 = dtype == torch.float64
    if data.device != plan.order.device:
        raise ValueError(f"data: expected a tensor on {plan.order.device}, got {data.device}")
    if min(data.stride()) < 0:
        raise ValueError("data: negative strides are not supported")
    if plan.max_row >= M:
        raise ValueError(f"data: the plan reads row {plan.max_row} of {M}")
    out = torch.empty((S, C), dtype=dtype, device=data.device)
    lib = _cuda.lib()
    if body == "fixed_order":
        if S * C >= 2 ** 31:
            raise ValueError(f"segment_sum: {S} x {C} outputs exceed int32 offsets")
        if not (S and C):
            return out  # nothing to sum: no launch
        G = plan.block_run.shape[0] - 1
        fixed = lib.thallo_segment_sum_staged_order_f64 if f64 else \
            lib.thallo_segment_sum_staged_order
        code = fixed(
            data.data_ptr(), data.stride(0), data.stride(1), plan.order.data_ptr(),
            plan.seg_start.data_ptr(), plan.block_run.data_ptr(), plan.block_lane.data_ptr(),
            out.data_ptr(), C, G, plan.order_tile, int(plan.modes[0] == WARP),
            _cuda.stream(data))
        _cuda.check(code, fn.__name__)
        fn.launches += 1
        BODY_LAUNCHES[body] += 1
        return out
    if plan.local is not None and data.stride(0) == 1 and M > 1:
        K, G, T = plan.n_chunks, plan.n_blocks, plan.staged_rows
        rows = K if body == "per_chunk" else G
        if S * rows * C >= 2 ** 31:
            raise ValueError(f"segment_sum: {S} x {rows} x {C} partial sums exceed int32 "
                             "offsets")
        if body == "ring":
            scratch = torch.empty((G, S, C), dtype=dtype, device=data.device)
            ring = lib.thallo_segment_sum_ring_f64 if f64 else lib.thallo_segment_sum_ring
            code = ring(
                data.data_ptr(), data.stride(1), plan.local.data_ptr(),
                plan.cell_start.data_ptr(), plan.block_chunk.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), M, C, S, K, G, T, plan.block_span, _cuda.stream(data))
        else:
            scratch = torch.empty((S, K, C), dtype=dtype, device=data.device)
            staged = lib.thallo_segment_sum_staged_f64 if f64 else lib.thallo_segment_sum_staged
            code = staged(
                data.data_ptr(), data.stride(1), plan.local.data_ptr(),
                plan.cell_start.data_ptr(), plan.seg_chunks.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), M, C, S, K, T, _cuda.stream(data))
        _cuda.check(code, f"{fn.__name__} ({body})")
        fn.launches += 1
        BODY_LAUNCHES[body] += 1
        return out
    two = plan.piece_start is not None
    P = plan.piece_start.shape[0] - 1 if two else 0
    if max(S, P) * C >= 2 ** 31:
        raise ValueError(f"segment_sum: {max(S, P)} x {C} outputs exceed int32 offsets")
    scratch = torch.empty((P, C), dtype=dtype, device=data.device) if two else None
    runs = lib.thallo_segment_sum_f64 if f64 else lib.thallo_segment_sum
    code = runs(
        data.data_ptr(), data.stride(0), data.stride(1), plan.order.data_ptr(),
        plan.seg_start.data_ptr(), plan.piece_start.data_ptr() if two else None,
        plan.seg_piece.data_ptr() if two else None,
        scratch.data_ptr() if two else None, out.data_ptr(), C, S, P,
        plan.modes[0], plan.modes[-1], _cuda.stream(data))
    _cuda.check(code, fn.__name__)
    fn.launches += 1
    BODY_LAUNCHES["runs"] += 1
    return out


segment_sum.launches = 0
segment_sum_f64.launches = 0
segment_sum_fixed_order.launches = 0
segment_sum_fixed_order_f64.launches = 0
segment_sum_per_chunk.launches = 0
segment_sum_per_chunk_f64.launches = 0
