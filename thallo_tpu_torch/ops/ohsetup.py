"""Segment sums by a per-row id into a small image: the camera-side
(one-hot row mode) setup products, and the plain aggregation.

``oh_setup_products`` replaces ``thallo_tpu/ops/ohsetup.py::
oh_setup_products`` (Pallas body ``_products_kernel``).  For residuals ``rT [rc, R]``, stacked
channel-major Jacobian slots ``Jall [K, R]`` (slot rows
``off + c*C + ch``) and ids ``[R]``, each recipe entry yields a slab:

  ("jtr", off, C)               jtr[ch]      = sum_c J[c, ch] * r[c]
  ("d2", off, C)                d2[ch]       = sum_c J[c, ch]^2
  ("pair", offa, Ca, offb, Cb)  pair[a*Cb+b] = sum_c Ja[c, a] * Jb[c, b]

and the slabs, stacked in recipe order into F rows, are summed over the
observations of each id into ``[F, N]``.  Ids outside [0, N) drop.

On the card (``csrc/oh_setup.cu``) the sum by id happens in shared
memory.  ``recipe_channels`` turns the recipe into channels, each a
product sum_c X[a0 + c*sa] * X[b0 + c*sb] over the stacked inputs X =
[rT; Jall] with an output row and a mirror row: a pair entry whose two
operands are the same slot (``offa == offb``, ``Ca == Cb``: BA's
camera-camera block) is symmetric, so only its a <= b entries are
channels and each b > a entry is the mirror of one (63 channels for BA's
99 rows).  The route is the range kernel (``products_ranges_plan``,
``products_route``): the N cameras are cut into as few ranges as leave a
block's [span, stride] accumulator of every channel room beside its
warps' stages (BA 1M: 4 ranges of 256 cameras in f64, 2 of 512 in f32),
and a fixed grid of blocks per range strides over tiles of 32
observations, a warp per tile: it stages the inputs of the observations
of its block's range, groups equal ids, and then, a lane per channel
pair, sums each distinct id's observations in registers and adds once to
the accumulator.  Each block flushes its range's columns into a slab,
and a second kernel sums the slabs in a fixed order and writes the mirror
rows.  The bound is the input read, 80 MB at BA-1M (160 MB in f64); the
time left is the shared additions, each a compare-and-swap loop on the
H100.  Where the range plan would cut more ranges than the range kernel
was measured to win at (N beyond ~36 000 cameras in f32 and ~12 300 in
f64 for BA's camera slot), ``oh_setup_products`` goes to
``oh_setup_products_atomics``, the first body: one thread per observation,
a global atomic per slab value (F*R adds, 99 M at BA-1M, onto F*N
addresses).  ``oh_setup_products_chunked`` is the route before the range
kernel: blocks over chunks of at most 32 channels whose [N, chunk]
accumulator fits ``PRODUCTS_SMEM``, each walking every tile
(``products_plan``, ``oh_setup_products_planned``); it stays the route
where it needs at most two chunks and R is small (``products_route``: the
small models).  The TPU
kernel's in-VMEM one-hot and 3-term bf16 split are not carried over:
every sum is a plain f32 sum whose order varies with the shared atomics.

``oh_setup_aggregate`` replaces ``thallo_tpu/ops/ohsetup.py::
oh_setup_aggregate`` (Pallas body ``_kernel``): channel-major parts
``[F, R]`` summed by ``ids [R]`` into ``[F, N]``; ids outside [0, N)
drop.  The matrix-free schedules (PRECOMPUTE_J, APPLY_SEPARATELY) scatter
a small image's per-observation values with it (lower.py), in setup and
on every PCG iteration.  The bound is the read of parts and ids,
(F + 1)*R*4 bytes.  On the card (``csrc/oh_aggregate.cu``) a fixed grid
of blocks strides over quads of 4 rows, a thread per quad with 16-byte
loads; lanes of a warp with equal ids sum their values by shuffles
(``add_cols``, the fused pair's warp merge) before one shared addition
per channel into the block's ``[rows, N]`` accumulator, of up to
``AGG_SMEM`` bytes (``aggregate_plan``: channels that do not fit at once
run as further chunks, grid y); each block adds its accumulator into
the output once, one global atomic per nonzero entry.  Where not one
batch of channel rows fits (N beyond ~6 300), ``oh_setup_aggregate``
goes to ``oh_setup_aggregate_atomics``, the first body: blocks over runs of rows, 4-byte loads, a shared atomic
per row and channel, and a global atomic per nonzero accumulator entry
(N up to ``_cuda.MAX_DYNAMIC_SMEM`` / 4).

**f64** (the solver's ``double_precision``): ``oh_setup_products`` and
``oh_setup_products_atomics`` hand f64 operands to ``oh_setup_products_f64``
and ``oh_setup_products_atomics_f64``, and ``oh_setup_aggregate`` to
``oh_setup_aggregate_f64``: the f64 instantiations (every stage,
accumulator and sum f64).  Their plans count 8 bytes a value: the range
kernel runs ``PRODUCTS_RANGE_THREADS_F64`` threads (BA's camera slot: 4
ranges of 256 cameras at N = 1024); ``oh_setup_products_chunked_f64`` (the
f64 route before it) 4 chunks of 16 channels.  The aggregation's
first body has no f64 instantiation: an N without an f64 plan raises
NotImplementedError (``_cuda.F64_TODO``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda

_KIND = {"jtr": 0, "d2": 1, "pair": 2}
# the shared-memory products kernel: threads per block, shared memory a
# block may take, and blocks per SM over all chunks (H100 sweep,
# scripts/torch_redesign_sweep.py --sweep: one block of 1024 threads per
# SM, two chunks of 32 channels, 0.21 ms, against 0.34-0.96 ms for 128-512
# threads).  Not kept, measured on the same card (H100 80GB HBM3, 700 W):
# a flush by one global atomic per nonzero entry (0.2507 ms uniform and
# 0.2133 skewed against 0.2085 and 0.1790 for the slabs), and the two
# chunks spread over a 2-block thread block cluster's shared memory, each
# tile staged once (0.2916 and 0.2095 against 0.2549 and 0.2128 on grid y,
# in a build whose grid-y kernel had been recompiled to 32 registers)
PRODUCTS_THREADS = 1024
PRODUCTS_SMEM = 224 * 1024
PRODUCTS_BLOCKS_PER_SM = 1
PRODUCTS_MAX_CHUNK = 32  # a lane per channel of the chunk
# the f64 instantiation: half the threads, so that the [rc + K, 33] f64
# stages of its warps leave room for the accumulator's channel rows (not
# swept; 1024 threads leave BA's camera slot chunks of 7 channels)
PRODUCTS_THREADS_F64 = 512
# The route's constants, from one scan on the H100
# (scripts/torch_redesign_sweep.py --only oh_f64 --sweep; BA's recipe, random
# ids; PERF.md, Findings).  The range kernel: threads a block in f32
# and in f64 (1024 / 512, the most the shared memory holds beside the
# stages, ahead of 256-512 / 256-384) and channels a chunk (two a lane:
# csrc/oh_setup.cu kRangeChunk).
PRODUCTS_RANGE_THREADS = 1024
PRODUCTS_RANGE_THREADS_F64 = 512
RANGE_CHUNK = 64
# The most camera ranges a range plan cuts, each range's blocks walking
# every tile: the most at which the range kernel was timed ahead of the
# first body at R 1 000 000 (f32: 63 ranges, N 36 000, 0.81 against 1.11
# ms; f64: 43 ranges, N 12 288, 0.99 against 1.18 ms, and behind it at 63,
# 1.23 against 1.19).  Beyond, the first body.
PRODUCTS_MAX_RANGES = 63
PRODUCTS_MAX_RANGES_F64 = 43
# The channel-chunk kernel walks every tile once a chunk: it stays the route
# only where it needs at most PRODUCTS_CHUNKED_MAX_CHUNKS chunks and R is
# below PRODUCTS_RANGE_MIN_R[_F64], where the range kernel's 132 blocks'
# zeroing and flush outweigh its walk.  Measured on both sides: 2 chunks
# (N 64) ahead at R 65 536 in f32 (0.0172 against 0.0203 ms) and 32 768 in
# f64 (0.0158 against 0.0185), behind at 131 072 (0.0281 against 0.0216)
# and 65 536 (0.0255 against 0.0194); f64's 4 chunks at N 1024 behind the
# range kernel at every R from 5 590 (0.0223 against 0.0197).
PRODUCTS_CHUNKED_MAX_CHUNKS = 2
PRODUCTS_RANGE_MIN_R = 1 << 17
PRODUCTS_RANGE_MIN_R_F64 = 1 << 16
_STAGE_LD = 33  # csrc/oh_setup.cu kStageLd


def recipe_width(recipe) -> int:
    return sum(e[2] if e[0] in ("jtr", "d2") else e[2] * e[4] for e in recipe)


def setup_slabs(rT, Jall, recipe):
    """The recipe's slabs, stacked channel-major: [F, R] (per observation,
    before any sum by id, in the inputs' dtype)."""
    rc, R = rT.shape
    out = []
    for ent in recipe:
        if ent[0] in ("jtr", "d2"):
            _, off, C = ent
            J = Jall[off:off + rc * C].reshape(rc, C, R)
            out.append((J * rT[:, None]).sum(0) if ent[0] == "jtr" else (J * J).sum(0))
        else:
            _, offa, Ca, offb, Cb = ent
            Ja = Jall[offa:offa + rc * Ca].reshape(rc, Ca, 1, R)
            Jb = Jall[offb:offb + rc * Cb].reshape(rc, 1, Cb, R)
            out.append((Ja * Jb).sum(0).reshape(Ca * Cb, R))
    return torch.cat(out)


def oh_setup_products_reference(rT, Jall, ids, *, N, recipe):
    """Plain torch version, in rT's dtype (f32 or f64): slabs [F, R], then
    index_add_ by id."""
    x = setup_slabs(rT, Jall.to(rT.dtype), recipe)
    ok = (ids >= 0) & (ids < N)
    out = torch.zeros((x.shape[0], N), dtype=rT.dtype, device=rT.device)
    return out.index_add_(1, ids[ok].long(), x[:, ok])


class ProductsPlan(NamedTuple):
    """The channels of a recipe for the shared-memory products kernel:
    chan[k] = (a0, sa, b0, sb), rows of the stacked [rT; Jall] whose
    products summed over c < rc give channel k; dest[k] = (its output
    row, the mirror row that gets the same value or -1); F output rows;
    chunk channels per block, n_chunks chunks, the odd row stride of the
    [N, stride] accumulator; block_smem bytes."""
    chan: Tuple[Tuple[int, int, int, int], ...]
    dest: Tuple[Tuple[int, int], ...]
    F: int
    chunk: int
    n_chunks: int
    stride: int
    block_smem: int


def _smem_bytes(chunk, N, rc, K, threads, itemsize=4):
    """Shared memory of a products block (csrc/oh_setup.cu launch_products):
    the [N, chunk | 1] accumulator and a [rc + K, 33] stage per warp, at
    itemsize bytes a value."""
    return (N * (chunk | 1) + threads // 32 * (rc + K) * _STAGE_LD) * itemsize


@functools.lru_cache(maxsize=64)
def products_plan(recipe, rc: int, K: int, N: int, threads: int,
                  smem: int, itemsize: int = 4) -> Optional[ProductsPlan]:
    """The recipe's channels, mirrors and chunks for a block of `threads`
    observations within `smem` bytes of shared memory (itemsize bytes a
    value: 4, or 8 for the f64 instantiation); None where not even one
    channel row fits (those shapes take oh_setup_products_atomics in f32).
    Pure Python and cached per static recipe."""
    chan, dest, F = recipe_channels(recipe, rc)
    chunk = min(len(chan), PRODUCTS_MAX_CHUNK)
    while chunk >= 1 and _smem_bytes(chunk, N, rc, K, threads, itemsize) > smem:
        chunk -= 1
    if chunk < 1:
        return None
    n_chunks = -(-len(chan) // chunk)
    chunk = -(-len(chan) // n_chunks)  # the same work in every chunk
    return ProductsPlan(chan, dest, F, chunk, n_chunks, chunk | 1,
                        _smem_bytes(chunk, N, rc, K, threads, itemsize))


@functools.lru_cache(maxsize=64)
def recipe_channels(recipe, rc: int):
    """(chan, dest, F): the recipe's channels as products of rows of the
    stacked [rT; Jall], chan[k] = (a0, sa, b0, sb), with dest[k] = (output
    row, mirror row or -1) (a symmetric pair keeps its a <= b entries),
    and the F output rows."""
    chan, dest, F = [], [], 0
    for ent in recipe:
        if ent[0] in ("jtr", "d2"):
            _, off, C = ent
            for ch in range(C):
                a0 = rc + off + ch
                chan.append((a0, C, 0, 1) if ent[0] == "jtr" else (a0, C, a0, C))
                dest.append((F + ch, -1))
            F += C
            continue
        _, offa, Ca, offb, Cb = ent
        sym = offa == offb and Ca == Cb
        for a in range(Ca):
            for b in range(a if sym else 0, Cb):
                chan.append((rc + offa + a, Ca, rc + offb + b, Cb))
                dest.append((F + a * Cb + b, F + b * Ca + a if sym and b != a else -1))
        F += Ca * Cb
    return tuple(chan), tuple(dest), F


class RangesPlan(NamedTuple):
    """The range products kernel's plan: the recipe's channels
    (chan, dest, F as ProductsPlan's), cut into n_chunks chunks of up to
    RANGE_CHUNK (two a lane); the N cameras into n_ranges ranges of span,
    each range's [span, stride] accumulator (stride odd) beside a [rc + K,
    33] stage a warp within the shared memory; block_smem bytes."""
    chan: Tuple[Tuple[int, int, int, int], ...]
    dest: Tuple[Tuple[int, int], ...]
    F: int
    n_chunks: int
    stride: int
    span: int
    n_ranges: int
    block_smem: int


@functools.lru_cache(maxsize=64)
def products_ranges_plan(recipe, rc: int, K: int, N: int, threads: int, smem: int,
                         itemsize: int = 8) -> Optional[RangesPlan]:
    """The camera ranges of the range kernel for blocks of `threads`
    threads within `smem` bytes (itemsize bytes a value): as few ranges as
    leave each range's accumulator room beside the warps' stages, at most
    PRODUCTS_MAX_RANGES (PRODUCTS_MAX_RANGES_F64 at itemsize 8); None
    beyond (those shapes take the first body).
    Pure Python and cached per static recipe."""
    chan, dest, F = recipe_channels(recipe, rc)
    n_chunks = -(-len(chan) // RANGE_CHUNK)
    stride = min(len(chan), RANGE_CHUNK) | 1
    room = smem // itemsize - threads // 32 * (rc + K) * _STAGE_LD
    span_max = room // stride
    if span_max < 1:
        return None
    n_ranges = -(-N // span_max)
    if n_ranges > (PRODUCTS_MAX_RANGES_F64 if itemsize == 8 else PRODUCTS_MAX_RANGES):
        return None
    span = -(-N // n_ranges)
    block_smem = (span * stride + threads // 32 * (rc + K) * _STAGE_LD) * itemsize
    return RangesPlan(chan, dest, F, n_chunks, stride, span, n_ranges, block_smem)


def products_ranges_grid(plan: RangesPlan, R: int, threads: int, sms: int) -> int:
    """Blocks per range and chunk: one block an SM shared by the ranges and
    chunks, no more than the observation tiles."""
    blocks = _cuda.blocks_per_sm(plan.block_smem, 1) * sms
    return max(1, min(blocks // (plan.n_ranges * plan.n_chunks), -(-R // threads)))


def oh_setup_products_ranges_planned(rT, Jall, ids, *, N, recipe, smem=PRODUCTS_SMEM):
    """The sum the range kernel computes, from its plan alone, in plain
    torch (in rT's dtype, planned at its threads and itemsize): each range's and
    chunk's channels summed over the observations of the range's ids into
    a [span, stride] accumulator, written to their output rows and mirror
    rows; rows no range writes stay NaN."""
    rc, R = rT.shape
    dt, dev = rT.dtype, rT.device
    threads = PRODUCTS_RANGE_THREADS_F64 if dt == torch.float64 else PRODUCTS_RANGE_THREADS
    plan = products_ranges_plan(tuple(recipe), rc, Jall.shape[0], N, threads, smem,
                                rT.element_size())
    X = torch.cat([rT, Jall.to(dt)])
    c = torch.arange(rc, device=dev)
    out = torch.full((plan.F, N), float("nan"), dtype=dt, device=dev)
    for q in range(plan.n_ranges):
        lo = q * plan.span
        nb = max(0, min(plan.span, N - lo))
        ok = (ids >= lo) & (ids < lo + nb)
        idx = ids[ok].long() - lo
        for k in range(plan.n_chunks):
            rows = range(k * RANGE_CHUNK, min(len(plan.chan), (k + 1) * RANGE_CHUNK))
            a = torch.stack([a0 + sa * c for a0, sa, _, _ in (plan.chan[j] for j in rows)])
            b = torch.stack([b0 + sb * c for _, _, b0, sb in (plan.chan[j] for j in rows)])
            v = (X[a][:, :, ok] * X[b][:, :, ok]).sum(1)  # [chunk, R_ok]
            acc = torch.zeros((plan.span, len(rows)), dtype=dt, device=dev)
            acc.index_add_(0, idx, v.T)
            for i, j in enumerate(rows):
                f, mirror = plan.dest[j]
                out[f, lo:lo + nb] = acc[:nb, i]
                if mirror >= 0:
                    out[mirror, lo:lo + nb] = acc[:nb, i]
    return out


def products_grid(plan: ProductsPlan, R: int, threads: int, sms: int) -> int:
    """Blocks per chunk: PRODUCTS_BLOCKS_PER_SM blocks per SM (fewer where
    the shared memory leaves no room) shared by the chunks, no more than
    the observation tiles."""
    blocks = _cuda.blocks_per_sm(plan.block_smem, PRODUCTS_BLOCKS_PER_SM) * sms
    return max(1, min(blocks // plan.n_chunks, -(-R // threads)))


def oh_setup_products_planned(rT, Jall, ids, *, N, recipe, threads=PRODUCTS_THREADS,
                              smem=PRODUCTS_SMEM):
    """The sum the shared-memory kernel computes, from its plan alone, in
    plain torch (in rT's dtype, planned at its itemsize): each chunk's
    channels summed by id into a [chunk, N] accumulator, written to their
    output rows and mirror rows."""
    rc, R = rT.shape
    dt = rT.dtype
    plan = products_plan(tuple(recipe), rc, Jall.shape[0], N, threads, smem, rT.element_size())
    X = torch.cat([rT, Jall.to(dt)])
    ok = (ids >= 0) & (ids < N)
    idx = ids[ok].long()
    out = torch.full((plan.F, N), float("nan"), dtype=dt, device=rT.device)
    c = torch.arange(rc, device=rT.device)
    for k in range(plan.n_chunks):
        rows = range(k * plan.chunk, min(len(plan.chan), (k + 1) * plan.chunk))
        a = torch.stack([a0 + sa * c for a0, sa, _, _ in (plan.chan[j] for j in rows)])
        b = torch.stack([b0 + sb * c for _, _, b0, sb in (plan.chan[j] for j in rows)])
        v = (X[a][:, :, ok] * X[b][:, :, ok]).sum(1)  # [chunk, R_ok]
        acc = torch.zeros((len(rows), N), dtype=dt, device=rT.device)
        acc.index_add_(1, idx, v)
        for i, j in enumerate(rows):
            f, mirror = plan.dest[j]
            out[f] = acc[i]
            if mirror >= 0:
                out[mirror] = acc[i]
    return out


def _recipe_rows(recipe, rc, K):
    """The recipe as the first body's rows (kind, offa, Ca, offb, Cb, f0)
    and F; raises on an entry that reads past K."""
    rows, F = [], 0
    for ent in recipe:
        kind = _KIND[ent[0]]
        if kind == 2:
            _, offa, Ca, offb, Cb = ent
            rows.append((kind, offa, Ca, offb, Cb, F))
            F += Ca * Cb
        else:
            _, off, C = ent
            rows.append((kind, off, C, 0, 0, F))
            F += C
        if max(rows[-1][1] + rc * rows[-1][2],
               rows[-1][3] + rc * rows[-1][4]) > K:
            raise ValueError(f"oh_setup_products: recipe entry {ent} reads past K={K}")
    return tuple(rows), F


def _checked(what, rT, Jall, ids, dt=torch.float32):
    if rT.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {rT.device}")
    rc, R = rT.shape
    K = Jall.shape[0]
    _cuda.require(rT, "rT", (rc, R), dt, rT.device)
    _cuda.require(Jall, "Jall", (K, R), dt, rT.device)
    _cuda.require(ids, "ids", (R,), torch.int32, rT.device)
    return rc, R, K


def oh_setup_products(rT, Jall, ids, *, N, recipe):
    """rT [rc, R] f32, Jall [K, R] f32, ids [R] int32, recipe: static
    tuple of ("jtr", off, C) | ("d2", off, C) | ("pair", offa, Ca, offb, Cb)
    -> [F, N] f32.  CPU tensors take the plain version; CUDA tensors take
    the kernel products_route names: the range kernel (launched here,
    PRODUCTS_RANGE_THREADS threads a block), oh_setup_products_chunked or
    oh_setup_products_atomics; f64 operands go to oh_setup_products_f64."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    if rT.dtype == torch.float64:
        return oh_setup_products_f64(rT, Jall, ids, N=N, recipe=recipe)
    return _products_routed(oh_setup_products, rT, Jall, ids, N, recipe)


def oh_setup_products_chunked(rT, Jall, ids, *, N, recipe):
    """The f32 route's kernel before the range kernel: the
    shared-memory kernel over channel chunks on grid y, PRODUCTS_THREADS
    threads a block; kept for measurement.  A shape without a chunk plan
    raises ValueError.  CPU tensors take the plain version."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    rc, R, K = _checked("oh_setup_products_chunked", rT, Jall, ids)
    _recipe_rows(recipe, rc, K)
    plan = products_plan(tuple(recipe), rc, K, N, PRODUCTS_THREADS, PRODUCTS_SMEM)
    if plan is None:
        raise ValueError(f"oh_setup_products_chunked: no channel row fits at N={N}")
    return _launch_products(oh_setup_products_chunked, rT, Jall, ids, N, plan, PRODUCTS_THREADS)


def products_route(recipe, rc: int, K: int, N: int, dtype=torch.float32, R: int = 1 << 30) -> str:
    """The kernel oh_setup_products launches for a recipe, N and R
    observations, by the name of its wrapper (the f64 names end in
    "_f64"): the channel-chunk kernel ("oh_setup_products_chunked") where
    products_plan needs at most PRODUCTS_CHUNKED_MAX_CHUNKS chunks and R is
    below PRODUCTS_RANGE_MIN_R (f64: PRODUCTS_RANGE_MIN_R_F64); else the
    range kernel ("oh_setup_products") where products_ranges_plan has a
    plan; else the first body ("oh_setup_products_atomics")."""
    recipe, f64 = tuple(recipe), dtype == torch.float64
    ranges = products_ranges_plan(recipe, rc, K, N,
                                  PRODUCTS_RANGE_THREADS_F64 if f64 else PRODUCTS_RANGE_THREADS,
                                  PRODUCTS_SMEM, 8 if f64 else 4)
    chunks = products_plan(recipe, rc, K, N, PRODUCTS_THREADS_F64 if f64 else PRODUCTS_THREADS,
                           PRODUCTS_SMEM, 8 if f64 else 4)
    few = chunks is not None and chunks.n_chunks <= PRODUCTS_CHUNKED_MAX_CHUNKS
    if few and (R < (PRODUCTS_RANGE_MIN_R_F64 if f64 else PRODUCTS_RANGE_MIN_R) or not ranges):
        name = "oh_setup_products_chunked"
    elif ranges:
        name = "oh_setup_products"
    else:
        name = "oh_setup_products_atomics"
    return name + ("_f64" if f64 else "")


def oh_setup_products_f64(rT, Jall, ids, *, N, recipe):
    """oh_setup_products in f64 (rT, Jall f64 -> [F, N] f64): the kernel
    products_route names, the range kernel (launched here,
    PRODUCTS_RANGE_THREADS_F64 threads a block, each block summing all
    channels of the observations of one camera range),
    oh_setup_products_chunked_f64 or oh_setup_products_atomics_f64.  CPU
    tensors take the plain version."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    return _products_routed(oh_setup_products_f64, rT, Jall, ids, N, recipe)


def oh_setup_products_chunked_f64(rT, Jall, ids, *, N, recipe):
    """oh_setup_products_chunked in f64 (channel chunks on grid y,
    PRODUCTS_THREADS_F64 threads a block), the f64 route before the
    range kernel; kept for measurement.
    A shape without a chunk plan raises ValueError.  CPU tensors take the
    plain version."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    rc, R, K = _checked("oh_setup_products_chunked_f64", rT, Jall, ids, torch.float64)
    _recipe_rows(recipe, rc, K)
    plan = products_plan(tuple(recipe), rc, K, N, PRODUCTS_THREADS_F64, PRODUCTS_SMEM, 8)
    if plan is None:
        raise ValueError(f"oh_setup_products_chunked_f64: no channel row fits at N={N}")
    return _launch_products(oh_setup_products_chunked_f64, rT, Jall, ids, N, plan,
                            PRODUCTS_THREADS_F64)


def _products_routed(entry, rT, Jall, ids, N, recipe):
    """oh_setup_products[_f64] on the card: the range kernel, counted on
    `entry`, where products_route names it, else the body it names."""
    dt = rT.dtype
    rc, R, K = _checked(entry.__name__, rT, Jall, ids, dt)
    _recipe_rows(recipe, rc, K)
    route = products_route(recipe, rc, K, N, dt, R)
    if route != entry.__name__:
        return _PRODUCTS_BODIES[route](rT, Jall, ids, N=N, recipe=recipe)
    f64 = dt == torch.float64
    threads = PRODUCTS_RANGE_THREADS_F64 if f64 else PRODUCTS_RANGE_THREADS
    plan = products_ranges_plan(tuple(recipe), rc, K, N, threads, PRODUCTS_SMEM, 8 if f64 else 4)
    return _launch_products_ranges(entry, rT, Jall, ids, N, plan, threads)


def _launch_products_ranges(fn, rT, Jall, ids, N, plan, threads):
    """One launch of the range kernel (f32 or f64 by rT's dtype)
    and its slab sum."""
    (rc, R), K, dev, dt = rT.shape, Jall.shape[0], rT.device, rT.dtype
    grid = products_ranges_grid(plan, R, threads, _cuda.sm_count(dev))
    slab = torch.empty((grid, len(plan.chan), N), dtype=dt, device=dev)
    out = torch.empty((plan.F, N), dtype=dt, device=dev)
    chan = _cuda.recipe_tensor(plan.chan, dev)
    dest = _cuda.recipe_tensor(plan.dest, dev)
    launch = (_cuda.lib().thallo_oh_setup_products_ranges_f64 if dt == torch.float64
              else _cuda.lib().thallo_oh_setup_products_ranges)
    code = launch(rT.data_ptr(), Jall.data_ptr(), ids.data_ptr(), chan.data_ptr(),
                  dest.data_ptr(), out.data_ptr(), slab.data_ptr(), len(plan.chan), plan.stride,
                  plan.span, rc, K, R, N, threads, grid, _cuda.stream(rT))
    _cuda.check(code, fn.__name__)
    fn.launches += 1
    return out


def _launch_products(fn, rT, Jall, ids, N, plan, threads):
    (rc, R), K, dev, dt = rT.shape, Jall.shape[0], rT.device, rT.dtype
    grid = products_grid(plan, R, threads, _cuda.sm_count(dev))
    slab = torch.empty((grid, len(plan.chan), N), dtype=dt, device=dev)
    out = torch.empty((plan.F, N), dtype=dt, device=dev)
    chan = _cuda.recipe_tensor(plan.chan, dev)
    dest = _cuda.recipe_tensor(plan.dest, dev)
    launch = (_cuda.lib().thallo_oh_setup_products_persistent_f64 if dt == torch.float64
              else _cuda.lib().thallo_oh_setup_products_persistent)
    code = launch(rT.data_ptr(), Jall.data_ptr(), ids.data_ptr(), chan.data_ptr(),
                  dest.data_ptr(), out.data_ptr(), slab.data_ptr(), len(plan.chan), plan.chunk,
                  plan.stride, rc, K, R, N, threads, grid, _cuda.stream(rT))
    _cuda.check(code, fn.__name__)
    fn.launches += 1
    return out


def oh_setup_products_atomics(rT, Jall, ids, *, N, recipe):
    """The contract of oh_setup_products by the first body: one thread per
    observation, one global atomic per slab value; any N.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (f64 operands
    raise: oh_setup_products_atomics_f64 is theirs)."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    return _launch_products_first(oh_setup_products_atomics, rT, Jall, ids, N, recipe,
                                  torch.float32)


def oh_setup_products_atomics_f64(rT, Jall, ids, *, N, recipe):
    """oh_setup_products_atomics in f64 (the first body's f64
    instantiation, global atomicAdd on doubles): the f64 route where
    products_ranges_plan has no plan.  CPU tensors take the plain
    version."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    return _launch_products_first(oh_setup_products_atomics_f64, rT, Jall, ids, N, recipe,
                                  torch.float64)


def _launch_products_first(fn, rT, Jall, ids, N, recipe, dt):
    what = fn.__name__
    rc, R, K = _checked(what, rT, Jall, ids, dt)
    rows, F = _recipe_rows(recipe, rc, K)
    out = torch.zeros((F, N), dtype=dt, device=rT.device)
    rec = _cuda.recipe_tensor(rows, rT.device)
    launch = (_cuda.lib().thallo_oh_setup_products_f64 if dt == torch.float64
              else _cuda.lib().thallo_oh_setup_products)
    code = launch(rT.data_ptr(), Jall.data_ptr(), ids.data_ptr(), rec.data_ptr(),
                  out.data_ptr(), len(rows), rc, R, N, _cuda.stream(rT))
    _cuda.check(code, what)
    fn.launches += 1
    return out


# the bodies products_route names beside the range kernel
_PRODUCTS_BODIES = {fn.__name__: fn for fn in (
    oh_setup_products_chunked, oh_setup_products_chunked_f64, oh_setup_products_atomics,
    oh_setup_products_atomics_f64)}
for _fn in (oh_setup_products, oh_setup_products_f64, *_PRODUCTS_BODIES.values()):
    _fn.launches = 0


def oh_setup_aggregate_reference(parts_cm, ids, *, N):
    """Plain torch version, in parts' dtype: index_add_ of the in-range
    rows."""
    ok = (ids >= 0) & (ids < N)
    out = torch.zeros((parts_cm.shape[0], N), dtype=parts_cm.dtype, device=parts_cm.device)
    return out.index_add_(1, ids[ok].long(), parts_cm[:, ok])


# the shared-memory aggregation kernel: threads per block, blocks per SM,
# the shared memory a block may take, channels per warp merge (kBatch in
# csrc/oh_aggregate.cu), the fewest lanes of one id that make a warp merge
# (33: never).  H100 sweep (scripts/torch_redesign_sweep.py --sweep --only
# aggregate; H100 80GB HBM3, 700 W): 1024 threads, one block per SM,
# 0.0365 ms at [9, 1M] -> [9, 1024] and 0.0364 at the skewed scene's
# camera ids; 256-512 threads 0.0368-0.0420; merging from 2, 4 or 8 equal
# lanes alike on both, never merging 0.2310 skewed.  Not kept: a flush
# into per-block slabs summed by a second kernel in a fixed order (0.0394
# and 0.0394 against 0.0365 and 0.0364 for the global atomics), and the
# next quad's loads issued before the current quad's additions (128
# registers, 512 threads: 0.0494 and 0.0490 against 0.0372 and 0.0402 in
# the same run).
AGG_THREADS = 1024
AGG_BLOCKS_PER_SM = 1
AGG_SMEM = 224 * 1024
AGG_BATCH = 9
AGG_MERGE_MIN = 2
# the f64 instantiation: half the threads (csrc/oh_aggregate.cu's launch
# bound), so that a thread's 9 x 4 doubles stay in registers (not swept)
AGG_THREADS_F64 = 512


class AggregatePlan(NamedTuple):
    """chunk channels per grid row y, n_chunks of them, acc_rows
    accumulator rows (chunk rounded up to AGG_BATCH), block_smem bytes."""
    chunk: int
    n_chunks: int
    acc_rows: int
    block_smem: int


@functools.lru_cache(maxsize=64)
def aggregate_plan(F: int, N: int, smem: int = AGG_SMEM,
                   itemsize: int = 4) -> Optional[AggregatePlan]:
    """The channel chunks of the shared-memory kernel: as few as fit
    `smem` bytes of [acc_rows, N] accumulator (itemsize bytes a value),
    equal in size; None where not even AGG_BATCH rows fit (those shapes
    take oh_setup_aggregate_atomics in f32)."""
    max_rows = smem // (N * itemsize) // AGG_BATCH * AGG_BATCH
    if F < 1 or max_rows < AGG_BATCH:
        return None
    n_chunks = -(-F // max_rows)
    chunk = -(-F // n_chunks)
    acc_rows = -(-chunk // AGG_BATCH) * AGG_BATCH
    return AggregatePlan(chunk, n_chunks, acc_rows, acc_rows * N * itemsize)


def aggregate_grid(plan: AggregatePlan, R: int, threads: int, sms: int) -> int:
    """Blocks per chunk: AGG_BLOCKS_PER_SM per SM (fewer where the shared
    memory leaves no room) shared by the chunks, no more than the quads."""
    blocks = _cuda.blocks_per_sm(plan.block_smem, AGG_BLOCKS_PER_SM) * sms
    return max(1, min(blocks // plan.n_chunks, -(-R // (4 * threads))))


def oh_setup_aggregate_planned(parts_cm, ids, *, N, smem=AGG_SMEM):
    """The sum the shared-memory kernel computes, from its plan alone, in
    plain torch (in parts' dtype, planned at its itemsize): each chunk's
    channels summed by id into an [acc_rows, N] accumulator and its first
    rows written out; rows no chunk writes stay NaN."""
    F = parts_cm.shape[0]
    dt = parts_cm.dtype
    plan = aggregate_plan(F, N, smem, parts_cm.element_size())
    ok = (ids >= 0) & (ids < N)
    out = torch.full((F, N), float("nan"), dtype=dt, device=parts_cm.device)
    for k in range(plan.n_chunks):
        f0 = k * plan.chunk
        fc = min(plan.chunk, F - f0)
        acc = torch.zeros((plan.acc_rows, N), dtype=dt, device=parts_cm.device)
        acc[:fc].index_add_(1, ids[ok].long(), parts_cm[f0:f0 + fc][:, ok])
        out[f0:f0 + fc] = acc[:fc]
    return out


def _agg_checked(what, parts_cm, ids, dt=torch.float32):
    if parts_cm.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {parts_cm.device}")
    F, R = parts_cm.shape
    _cuda.require(parts_cm, "parts_cm", (F, R), dt, parts_cm.device)
    _cuda.require(ids, "ids", (R,), torch.int32, parts_cm.device)
    return F, R, parts_cm.device


def oh_setup_aggregate(parts_cm, ids, *, N):
    """parts_cm [F, R] f32, ids [R] int32 -> [F, N] f32 (out-of-range ids
    drop).  CPU tensors take the plain version; CUDA tensors launch the
    shared-memory kernel, or, where aggregate_plan has no plan for N, go
    to oh_setup_aggregate_atomics; f64 parts go to oh_setup_aggregate_f64."""
    if parts_cm.device.type == "cpu":
        return oh_setup_aggregate_reference(parts_cm, ids, N=N)
    if parts_cm.dtype == torch.float64:
        return oh_setup_aggregate_f64(parts_cm, ids, N=N)
    F, R, dev = _agg_checked("oh_setup_aggregate", parts_cm, ids)
    plan = aggregate_plan(F, N, AGG_SMEM)
    if plan is None:
        return oh_setup_aggregate_atomics(parts_cm, ids, N=N)
    return _launch_aggregate(oh_setup_aggregate, parts_cm, ids, N, plan)


def oh_setup_aggregate_f64(parts_cm, ids, *, N):
    """oh_setup_aggregate in f64 (parts f64 -> [F, N] f64): the f64
    instantiation of the shared-memory kernel.  CPU tensors take the plain
    version; an N without an f64 plan (beyond ~3 100) raises
    NotImplementedError (the first body is f32 only)."""
    if parts_cm.device.type == "cpu":
        return oh_setup_aggregate_reference(parts_cm, ids, N=N)
    F, R, dev = _agg_checked("oh_setup_aggregate_f64", parts_cm, ids, torch.float64)
    plan = aggregate_plan(F, N, AGG_SMEM, 8)
    if plan is None:
        raise NotImplementedError(f"oh_setup_aggregate_f64: no accumulator fits at N={N}; the "
                                  f"f64 first body waits ({_cuda.F64_TODO})")
    return _launch_aggregate(oh_setup_aggregate_f64, parts_cm, ids, N, plan)


def _launch_aggregate(fn, parts_cm, ids, N, plan):
    (F, R), dev, dt = parts_cm.shape, parts_cm.device, parts_cm.dtype
    threads = AGG_THREADS_F64 if dt == torch.float64 else AGG_THREADS
    grid = aggregate_grid(plan, R, threads, _cuda.sm_count(dev))
    out = torch.zeros((F, N), dtype=dt, device=dev)
    launch = (_cuda.lib().thallo_oh_setup_aggregate_smem_f64 if dt == torch.float64
              else _cuda.lib().thallo_oh_setup_aggregate_smem)
    code = launch(parts_cm.data_ptr(), ids.data_ptr(), out.data_ptr(), F, R, N, plan.chunk,
                  plan.acc_rows, AGG_MERGE_MIN, threads, grid, _cuda.stream(parts_cm))
    _cuda.check(code, fn.__name__)
    fn.launches += 1
    return out


def oh_setup_aggregate_atomics(parts_cm, ids, *, N):
    """The contract of oh_setup_aggregate by the first body; N up to
    _cuda.MAX_DYNAMIC_SMEM / 4.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if parts_cm.device.type == "cpu":
        return oh_setup_aggregate_reference(parts_cm, ids, N=N)
    F, R, dev = _agg_checked("oh_setup_aggregate_atomics", parts_cm, ids)
    if N * 4 > _cuda.MAX_DYNAMIC_SMEM:
        raise ValueError(f"oh_setup_aggregate_atomics: N={N} exceeds the "
                         f"{_cuda.MAX_DYNAMIC_SMEM}-byte shared accumulator")
    out = torch.zeros((F, N), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_oh_setup_aggregate_atomics(
        parts_cm.data_ptr(), ids.data_ptr(), out.data_ptr(), F, R, N, _cuda.stream(parts_cm))
    _cuda.check(code, "oh_setup_aggregate_atomics")
    oh_setup_aggregate_atomics.launches += 1
    return out


for _fn in (oh_setup_aggregate, oh_setup_aggregate_f64, oh_setup_aggregate_atomics):
    _fn.launches = 0
