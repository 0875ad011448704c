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
memory.  ``products_plan`` turns the recipe into channels, each a product
sum_c X[a0 + c*sa] * X[b0 + c*sb] over the stacked inputs X = [rT; Jall]
with an output row and a mirror row: a pair entry whose two operands are
the same slot (``offa == offb``, ``Ca == Cb``: BA's camera-camera block)
is symmetric, so only its a <= b entries are channels and each b > a
entry is the mirror of one (63 channels for BA's 99 rows).  The channels
are cut into chunks of at most 32 whose [N, chunk] f32 accumulator,
beside a stage of each warp's inputs, fits ``PRODUCTS_SMEM`` (two chunks
of 32 at N = 1024).  A fixed grid of blocks per chunk strides over
tiles of 32 observations, a warp per tile: it stages the tile's inputs,
groups equal ids, and then, a lane per channel, sums each distinct id's
observations in registers and adds once to the accumulator; the
accumulator is flushed once per block into a slab, and a second kernel
sums the slabs in a fixed order and writes the mirror rows.  The bound
is the input read, 80 MB at BA-1M.  Where one channel row does not fit
(N beyond ~36 000 for BA's camera slot at the default budget),
``oh_setup_products`` goes to ``oh_setup_products_atomics``, the first
body: one thread per observation, a global atomic per slab value (F*R
adds, 99 M at BA-1M, onto F*N addresses).  The TPU kernel's in-VMEM
one-hot and 3-term bf16 split are not carried over: every sum is a plain
f32 sum whose order varies with the shared atomics.

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
``oh_setup_aggregate`` hand f64 operands to ``oh_setup_products_f64`` and
``oh_setup_aggregate_f64``, the f64 instantiations of the two
shared-memory kernels (every stage, accumulator and sum f64).  Their
plans count 8 bytes a value: the products kernel runs
``PRODUCTS_THREADS_F64`` threads, so that the warps' stages leave room
for chunks of channel rows (BA's camera slot: 4 chunks of 16 channels at
N = 1024, against 2 of 32 in f32).  The first bodies have no f64
instantiation: a shape without an f64 plan raises NotImplementedError
(``_cuda.F64_TODO``).
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
    chunk = min(len(chan), PRODUCTS_MAX_CHUNK)
    while chunk >= 1 and _smem_bytes(chunk, N, rc, K, threads, itemsize) > smem:
        chunk -= 1
    if chunk < 1:
        return None
    n_chunks = -(-len(chan) // chunk)
    chunk = -(-len(chan) // n_chunks)  # the same work in every chunk
    return ProductsPlan(tuple(chan), tuple(dest), F, chunk, n_chunks, chunk | 1,
                        _smem_bytes(chunk, N, rc, K, threads, itemsize))


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
    -> [F, N] f32.  CPU tensors take the plain version; CUDA tensors
    launch the shared-memory kernel, or, where products_plan finds no
    room for one channel row, go to oh_setup_products_atomics; f64
    operands go to oh_setup_products_f64."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    if rT.dtype == torch.float64:
        return oh_setup_products_f64(rT, Jall, ids, N=N, recipe=recipe)
    rc, R, K = _checked("oh_setup_products", rT, Jall, ids)
    _recipe_rows(recipe, rc, K)
    plan = products_plan(tuple(recipe), rc, K, N, PRODUCTS_THREADS, PRODUCTS_SMEM)
    if plan is None:
        return oh_setup_products_atomics(rT, Jall, ids, N=N, recipe=recipe)
    return _launch_products(oh_setup_products, rT, Jall, ids, N, plan, PRODUCTS_THREADS)


def oh_setup_products_f64(rT, Jall, ids, *, N, recipe):
    """oh_setup_products in f64 (rT, Jall f64 -> [F, N] f64): the f64
    instantiation of the shared-memory kernel, PRODUCTS_THREADS_F64
    threads a block.  CPU tensors take the plain version; a shape without
    an f64 plan raises NotImplementedError (the first body is f32 only)."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    rc, R, K = _checked("oh_setup_products_f64", rT, Jall, ids, torch.float64)
    _recipe_rows(recipe, rc, K)
    plan = products_plan(tuple(recipe), rc, K, N, PRODUCTS_THREADS_F64, PRODUCTS_SMEM, 8)
    if plan is None:
        raise NotImplementedError(f"oh_setup_products_f64: no channel row fits at N={N}; the "
                                  f"f64 first body waits ({_cuda.F64_TODO})")
    return _launch_products(oh_setup_products_f64, rT, Jall, ids, N, plan, PRODUCTS_THREADS_F64)


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
    take the plain version; CUDA tensors launch the kernel."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    rc, R, K = _checked("oh_setup_products_atomics", rT, Jall, ids)
    rows, F = _recipe_rows(recipe, rc, K)
    out = torch.zeros((F, N), dtype=torch.float32, device=rT.device)
    rec = _cuda.recipe_tensor(rows, rT.device)
    code = _cuda.lib().thallo_oh_setup_products(
        rT.data_ptr(), Jall.data_ptr(), ids.data_ptr(), rec.data_ptr(),
        out.data_ptr(), len(rows), rc, R, N, _cuda.stream(rT))
    _cuda.check(code, "oh_setup_products_atomics")
    oh_setup_products_atomics.launches += 1
    return out


for _fn in (oh_setup_products, oh_setup_products_f64, oh_setup_products_atomics):
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
