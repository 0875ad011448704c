"""Fused cross-pair block apply: both directions of a (row-slot,
small-image) JᵀJ pair per PCG iteration.

Replaces ``thallo_tpu/ops/fusedpair.py::fused_pair_apply`` (Pallas
bodies ``_kernel`` / ``_kernel_wloop``).  For blocks ``B[w, ci, cj, n]``
stored w-major (``[W*Ci*Cj, N]``, the same memory as ``[W, Ci*Cj, N]``):

  rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
  cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s

An entry (w, n) whose id lies outside [0, S) contributes to neither
output (row-table padding relies on this).  Four kernels compute it, all
bound by the block read, W*Ci*Cj*N*4 bytes (108 MB at W=4, 3x9,
N=250 000); what they differ in is the cols side, W*N*Cj scattered
additions (9 M at that shape, half of them onto one camera's 9 addresses
on a degree-skewed scene):

* ``fused_pair_apply`` (``csrc/fused_pair.cu``, JAX's ``_kernel``): for
  the pairs it is specialised for (3 x 9) whose [Cj, S] f32 accumulator
  fits the shared memory, the persistent kernel: a fixed grid of blocks
  strides over element tiles (one element per thread), the cols side is
  summed in the block's shared accumulator (a warp first merges lanes
  with equal ids by shuffles, so a hot id costs one shared addition per
  warp and channel) and flushed once, one global atomic per nonzero
  entry.  Every other shape goes to ``fused_pair_apply_atomics``.
* ``fused_pair_apply_atomics`` (same source): one thread per n loops
  over w, owns rows[:, n] outright and adds its Cj-vector z into
  cols[:, id] with global atomics.  Any (Ci, Cj) up to 8 x 16, any S.
* ``fused_pair_apply_wloop`` (``csrc/fused_pair_wloop.cu``, JAX's
  ``_kernel_wloop``, the wide and short levels of degree skew): for 3 x 9
  with the accumulator in shared memory, a persistent kernel over work
  items of (32-element tile, w_item w's), a warp per item, lane = element,
  the same warp merge and shared accumulator as ``fused_pair_apply``,
  zeroed and flushed once per block with a global atomic per nonzero
  entry.  Every other shape goes to ``fused_pair_apply_wloop_chunked``.
* ``fused_pair_apply_wloop_chunked`` (same source, the first W-loop
  body): blocks over (32-element tile, w-chunk, cj-chunk), rows and cols
  summed per block and added once per nonzero entry per block.  Any
  (Ci, Cj) up to 8 x 16, S up to ``_cuda.MAX_DYNAMIC_SMEM`` / 4.

``fused_pair_route(W, N_t, Ci, Cj, S)`` names the kernel a level of the
solver takes (``solver/blocksparse.py``), from its shape alone.

``fused_pair_rows_floor`` runs the persistent kernel with its cols side
compiled out: the time below which no design of the cols side can bring
``fused_pair_apply`` (``chip_smoke.py`` times it; no solver path runs it).
Unlike the TPU kernel there is no one-hot, no id decomposition and no
bf16 rounding: values stay f32.  Atomics make the cols sums' order vary
from run to run.

The measurement scripts' kernels (``scripts/tpu_fused_pair_micro.py``,
``scripts/tpu_fused_variants.py``) are the same pair with bf16 block
storage (``csrc/fused_pair_variants.cu``): ``fused_pair_bf16`` (both
outputs, global atomics for cols), ``fused_pair_v1_rows`` (rows only),
``fused_pair_v2_smem`` (cols in a shared accumulator per block, one global
atomic per nonzero entry) and ``fused_pair_v3_partials`` (per-block cols
slabs [G, Cj, S], summed outside the kernel).  Their plain version is
``fused_pair_apply_reference``, which reads the blocks as f32.
``scripts/torch_fused_pair_micro.py`` and ``scripts/torch_fused_variants.py``
time them; no solver path runs them.
"""
from __future__ import annotations

import torch

from . import _cuda

MAX_CI, MAX_CJ = 8, 16  # csrc/fused_pair*.cu register-array bounds
# the persistent kernel (csrc/fused_pair.cu): the pairs it is instantiated
# for, and the largest [Cj, S] f32 accumulator it takes (kMaxSmem there):
# two blocks still fit an SM's shared memory
PERSISTENT_PAIRS = frozenset({(3, 9)})
PERSISTENT_MAX_SMEM = 112 * 1024
# persistent blocks: threads each, and how many per SM (H100 sweep over
# 128-1024 x 1-12, scripts/torch_redesign_sweep.py --sweep: larger blocks
# flush fewer accumulators; 1024 x 1 leaves SMs idle on short levels)
THREADS = 512
BLOCKS_PER_SM = 2
MERGE_MIN = 2  # a warp merges equal ids once some id has this many lanes
# the persistent W-loop kernel (csrc/fused_pair_wloop.cu): threads and
# blocks per SM, and the fewest w's a work item takes (H100 sweep at the
# skewed 1M scene's levels, scripts/torch_redesign_sweep.py --sweep: 512 x
# 2 within 3% of the best everywhere; items of 2-3 w's)
WLOOP_THREADS = 512
WLOOP_BLOCKS_PER_SM = 2
WLOOP_MIN_ITEM = 2
# where the solver's levels go (fused_pair_route): levels narrower than
# WLOOP_MIN_W with at least PERSISTENT_MIN_N elements take the persistent
# kernel, the rest the W-loop one (H100: the persistent kernel is ahead at
# (2, 250000), (6, 70845) and (2, 32768), behind at (8, 16384), (4, 8192)
# and every W >= 24; one thread per element leaves a short level's SMs idle)
WLOOP_MIN_W = 9
PERSISTENT_MIN_N = 32768


def fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Plain torch version (f32; bf16 blocks are read as f32): the CPU
    path and the card-side oracle of every kernel here."""
    W, N = ids2d.shape
    B = blocks_wm.reshape(W, Ci, Cj, N).to(torch.float32)
    ok = (ids2d >= 0) & (ids2d < S)
    idx = torch.where(ok, ids2d, torch.zeros_like(ids2d)).long()
    pc = pcol.to(torch.float32)[:, idx] * ok  # [Cj, W, N]
    rows = (B * pc.permute(1, 0, 2)[:, None]).sum(dim=(0, 2))  # [Ci, N]
    z = (B * prow.to(torch.float32)[None, :, None, :]).sum(dim=1) * ok[:, None]  # [W, Cj, N]
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=pcol.device)
    cols.index_add_(1, idx.reshape(-1), z.permute(1, 0, 2).reshape(Cj, W * N))
    return rows, cols


def _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, block_dtype):
    """Validate a CUDA launch's operands; returns (W, N, blocks [W*Ci*Cj, N])."""
    if ids2d.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ids2d.device}")
    if not (1 <= Ci <= MAX_CI and 1 <= Cj <= MAX_CJ and S >= 1):
        raise ValueError(f"{what}: Ci={Ci}, Cj={Cj}, S={S} outside "
                         f"[1, {MAX_CI}] x [1, {MAX_CJ}] x [1, inf)")
    W, N = ids2d.shape
    dev = ids2d.device
    blocks = blocks_wm.reshape(W * Ci * Cj, N)
    _cuda.require(ids2d, "ids2d", (W, N), torch.int32, dev)
    _cuda.require(blocks, "blocks_wm", (W * Ci * Cj, N), block_dtype, dev)
    _cuda.require(pcol, "pcol", (Cj, S), torch.float32, dev)
    _cuda.require(prow, "prow", (Ci, N), torch.float32, dev)
    return W, N, blocks


def persistent_fits(Ci: int, Cj: int, S: int) -> bool:
    """A pair the persistent kernels are specialised for, with its [Cj, S]
    f32 accumulator within their shared-memory limit."""
    return (Ci, Cj) in PERSISTENT_PAIRS and Cj * S * 4 <= PERSISTENT_MAX_SMEM


def fused_pair_route(W: int, N_t: int, Ci: int, Cj: int, S: int) -> str:
    """The kernel a level of W x N_t elements takes on the card, by the
    name of its wrapper: "fused_pair_apply" (persistent) or
    "fused_pair_apply_wloop" for the specialised pairs, by the level's
    shape; "fused_pair_apply_wloop_chunked" for other wide levels whose
    S fits the chunked kernel's accumulator; else
    "fused_pair_apply_atomics"."""
    wide = W >= WLOOP_MIN_W
    if persistent_fits(Ci, Cj, S):
        return "fused_pair_apply" if not wide and N_t >= PERSISTENT_MIN_N \
            else "fused_pair_apply_wloop"
    if wide and S * 4 <= _cuda.MAX_DYNAMIC_SMEM:
        return "fused_pair_apply_wloop_chunked"
    return "fused_pair_apply_atomics"


def _launch_persistent(fn, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, with_cols):
    what = fn.__name__
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, torch.float32)
    if not persistent_fits(Ci, Cj, S):
        raise ValueError(f"{what}: no persistent kernel for Ci={Ci}, Cj={Cj}, S={S}")
    dev = ids2d.device
    rows = torch.empty((Ci, N), dtype=torch.float32, device=dev)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=dev) if with_cols else None
    # blocks resident on an SM: BLOCKS_PER_SM, fewer where the accumulator
    # leaves no room for as many
    per_sm = _cuda.blocks_per_sm(Cj * S * 4 if with_cols else 0, BLOCKS_PER_SM)
    code = _cuda.lib().thallo_fused_pair_persistent(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(), rows.data_ptr(),
        cols.data_ptr() if with_cols else None, W, N, Ci, Cj, S, THREADS,
        per_sm * _cuda.sm_count(dev), MERGE_MIN, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
    return rows, cols


def fused_pair_apply(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """ids2d [W, N] int32; blocks_wm [W*Ci*Cj, N] (or [W, Ci*Cj, N]) f32;
    pcol [Cj, S] f32; prow [Ci, N] f32 -> (rows [Ci, N], cols [Cj, S]) f32
    (any W; the solver sends the levels fused_pair_route names it for).
    CPU tensors take the plain version; CUDA tensors launch the persistent
    kernel, or, for a pair it is not specialised for or an accumulator
    beyond its shared memory, go to fused_pair_apply_atomics."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if not persistent_fits(Ci, Cj, S):
        return fused_pair_apply_atomics(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_persistent(fused_pair_apply, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, True)


def fused_pair_rows_floor(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """rows [Ci, N] alone, by the persistent kernel with its cols side
    compiled out (a measurement; the persistent route's shapes only)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)[0]
    return _launch_persistent(fused_pair_rows_floor, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                              False)[0]


def fused_pair_apply_atomics(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The contract of fused_pair_apply by one thread per element and one
    global atomic per cols value: any Ci <= 8, Cj <= 16 and S.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    W, N, blocks = _checked("fused_pair_apply_atomics", ids2d, blocks_wm, pcol, prow, Ci, Cj,
                            S, torch.float32)
    rows = torch.empty((Ci, N), dtype=torch.float32, device=ids2d.device)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=ids2d.device)
    code = _cuda.lib().thallo_fused_pair_atomics(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), W, N, Ci, Cj, S, _cuda.stream(ids2d))
    _cuda.check(code, "fused_pair_apply_atomics")
    fused_pair_apply_atomics.launches += 1
    return rows, cols


for _fn in (fused_pair_apply, fused_pair_rows_floor, fused_pair_apply_atomics):
    _fn.launches = 0


def wloop_plan(W: int, N: int, S: int, sms: int):
    """(w_item, grid) of the persistent W-loop kernel: items of a 32-element
    tile and w_item w's, about one per warp of the grid, at least
    WLOOP_MIN_ITEM w's each, W split evenly (an item that covers its
    elements' whole level stores their rows); grid: WLOOP_BLOCKS_PER_SM
    blocks per SM (fewer where the [9, S] accumulator leaves no room), no
    more than the items fill."""
    warps = WLOOP_THREADS // 32
    tiles = -(-N // 32)
    blocks = _cuda.blocks_per_sm(9 * S * 4, WLOOP_BLOCKS_PER_SM) * sms
    target = max(1, WLOOP_MIN_ITEM, -(-(W * tiles) // (blocks * warps)))
    w_item = max(1, -(-W // max(1, -(-W // target))))
    items = tiles * -(-W // w_item)
    return w_item, max(1, min(blocks, -(-items // warps)))


def fused_pair_apply_wloop(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The same contract as fused_pair_apply, for wide levels: a persistent
    kernel over (element tile, w-range) items, a warp per item (3 x 9 with
    a [9, S] accumulator within PERSISTENT_MAX_SMEM; every other shape goes
    to fused_pair_apply_wloop_chunked).  CPU tensors take the plain
    version; CUDA tensors launch a kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if not persistent_fits(Ci, Cj, S):
        return fused_pair_apply_wloop_chunked(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    W, N, blocks = _checked("fused_pair_apply_wloop", ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                            torch.float32)
    dev = ids2d.device
    w_item, grid = wloop_plan(W, N, S, _cuda.sm_count(dev))
    rows = (torch.empty if w_item >= W else torch.zeros)((Ci, N), dtype=torch.float32, device=dev)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_fused_pair_wloop_persistent(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), W, N, Ci, Cj, S, WLOOP_THREADS, grid, w_item, MERGE_MIN,
        _cuda.stream(ids2d))
    _cuda.check(code, "fused_pair_apply_wloop")
    fused_pair_apply_wloop.launches += 1
    return rows, cols


def fused_pair_apply_wloop_chunked(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The contract of fused_pair_apply by the first W-loop body: blocks
    over (element tile, w-chunk, channel chunk), rows and cols summed per
    block first.  Any Ci <= 8, Cj <= 16; Cj channels are split into chunks
    whose [chunk, S] f32 accumulator fits the shared memory, so S alone
    must fit it.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    W, N, blocks = _checked("fused_pair_apply_wloop_chunked", ids2d, blocks_wm, pcol, prow, Ci,
                            Cj, S, torch.float32)
    if S * 4 > _cuda.MAX_DYNAMIC_SMEM:
        raise ValueError(f"fused_pair_apply_wloop_chunked: S={S} exceeds the "
                         f"{_cuda.MAX_DYNAMIC_SMEM}-byte shared accumulator")
    rows = torch.zeros((Ci, N), dtype=torch.float32, device=ids2d.device)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=ids2d.device)
    code = _cuda.lib().thallo_fused_pair_wloop(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), W, N, Ci, Cj, S, _cuda.stream(ids2d))
    _cuda.check(code, "fused_pair_apply_wloop_chunked")
    fused_pair_apply_wloop_chunked.launches += 1
    return rows, cols


for _fn in (fused_pair_apply_wloop, fused_pair_apply_wloop_chunked):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# bf16 block storage: the measurement scripts' kernels
# ---------------------------------------------------------------------------
_MICRO, _ROWS_ONLY, _SMEM, _PARTIALS = range(4)  # csrc/fused_pair_variants.cu kMode


def _bf16_launch(fn, mode, ids2d, blocks_wm, pcol, prow, Ci, Cj, S):
    what = fn.__name__
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, torch.bfloat16)
    dev = ids2d.device
    if mode >= _SMEM and Cj * S * 4 > _cuda.MAX_DYNAMIC_SMEM:
        raise ValueError(f"{what}: Cj*S={Cj * S} exceeds the "
                         f"{_cuda.MAX_DYNAMIC_SMEM}-byte shared accumulator")
    grid = 0  # one thread per element
    if mode >= _SMEM:  # about two blocks per SM, striding over the elements
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(-(-N // 256), 2 * sms))
    rows = torch.empty((Ci, N), dtype=torch.float32, device=dev)
    if mode == _PARTIALS:
        cols = torch.empty((grid, Cj, S), dtype=torch.float32, device=dev)
    elif mode == _ROWS_ONLY:
        cols = None
    else:
        cols = torch.zeros((Cj, S), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_fused_pair_bf16(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
        rows.data_ptr(), 0 if cols is None else cols.data_ptr(), W, N, Ci, Cj, S, mode,
        grid, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
    if mode == _PARTIALS:
        cols = cols.sum(0)
    return rows, cols


def fused_pair_bf16(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply reading bf16 blocks (scripts/tpu_fused_pair_micro.py)
    -> (rows, cols); cols by one global atomic per value."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _bf16_launch(fused_pair_bf16, _MICRO, ids2d, blocks_wm, pcol, prow, Ci, Cj, S)


def fused_pair_v1_rows(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v1: rows only -> rows [Ci, N]."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)[0]
    return _bf16_launch(fused_pair_v1_rows, _ROWS_ONLY, ids2d, blocks_wm, pcol, prow,
                        Ci, Cj, S)[0]


def fused_pair_v2_smem(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v2: cols summed in a shared [Cj, S] accumulator per block,
    one global atomic per nonzero entry -> (rows, cols)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _bf16_launch(fused_pair_v2_smem, _SMEM, ids2d, blocks_wm, pcol, prow, Ci, Cj, S)


def fused_pair_v3_partials(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v3: per-block cols slabs [G, Cj, S] written without atomics
    and summed outside the kernel -> (rows, cols)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _bf16_launch(fused_pair_v3_partials, _PARTIALS, ids2d, blocks_wm, pcol, prow,
                        Ci, Cj, S)


for _fn in (fused_pair_bf16, fused_pair_v1_rows, fused_pair_v2_smem, fused_pair_v3_partials):
    _fn.launches = 0
