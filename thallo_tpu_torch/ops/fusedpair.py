"""Fused cross-pair block apply: both directions of a (row-slot,
small-image) JᵀJ pair per PCG iteration.

Replaces ``thallo_tpu/ops/fusedpair.py::fused_pair_apply`` (Pallas
bodies ``_kernel`` / ``_kernel_wloop``).  For blocks ``B[w, ci, cj, n]``
stored w-major (``[W*Ci*Cj, N]``, the same memory as ``[W, Ci*Cj, N]``):

  rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
  cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s

An entry (w, n) whose id lies outside [0, S) contributes to neither
output (row-table padding relies on this).  Three kernels compute it, all
bound by the block read, W*Ci*Cj*N*4 bytes (108 MB at W=4, 3x9,
N=250 000); what they differ in is the cols side, W*N*Cj scattered
additions (9 M at that shape, half of them onto one camera's 9 addresses
on a degree-skewed scene):

* ``fused_pair_apply`` (``csrc/fused_pair.cu``, JAX's ``_kernel``, levels
  with W <= 8).  ``fused_pair_route`` sends the pairs the kernel is
  specialised for (3 x 9) whose [Cj, S] f32 accumulator fits the shared
  memory to the persistent kernel: a fixed grid of blocks strides over
  element tiles (one element per thread), the cols side is
  summed in the block's shared accumulator (a warp first merges lanes
  with equal ids by shuffles, so a hot id costs one shared addition per
  warp and channel) and flushed once, one global atomic per nonzero
  entry.  Every other shape goes to ``fused_pair_apply_atomics``.
* ``fused_pair_apply_atomics`` (same source): one thread per n loops
  over w, owns rows[:, n] outright and adds its Cj-vector z into
  cols[:, id] with global atomics.  Any (Ci, Cj) up to 8 x 16, any S.
* ``fused_pair_apply_wloop`` (``csrc/fused_pair_wloop.cu``, JAX's
  ``_kernel_wloop``, levels with W > 8, the wide and short tails of
  degree skew): blocks over (32-element tile, w-chunk); rows summed per
  block and added once, cols summed in a shared-memory [Cj, S]
  accumulator and added once per nonzero entry per block.

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

import functools

import torch

from . import _cuda

MAX_CI, MAX_CJ = 8, 16  # csrc/fused_pair*.cu register-array bounds
# the persistent kernel (csrc/fused_pair.cu): the pairs it is instantiated
# for, and the largest [Cj, S] f32 accumulator it takes (kMaxSmem there):
# two blocks still fit an SM's shared memory
PERSISTENT_PAIRS = frozenset({(3, 9)})
PERSISTENT_MAX_SMEM = 112 * 1024
SM_SMEM = 227 * 1024  # shared memory the blocks resident on one H100 SM share
# persistent blocks: threads each, and how many per SM (H100 sweep over
# 128-1024 x 1-12, scripts/torch_redesign_sweep.py --sweep: larger blocks
# flush fewer accumulators; 1024 x 1 leaves SMs idle on short levels)
THREADS = 512
BLOCKS_PER_SM = 2
MERGE_MIN = 2  # a warp merges equal ids once some id has this many lanes
# thallo_tpu's store_3d: levels wider than 8 take the W-loop body
WLOOP_MIN_W = 9


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


def fused_pair_route(Ci: int, Cj: int, S: int) -> str:
    """The kernel fused_pair_apply launches on the card, from the shape
    alone: "persistent" for a specialised pair whose [Cj, S] f32
    accumulator fits the shared memory, else "atomics"."""
    if (Ci, Cj) in PERSISTENT_PAIRS and Cj * S * 4 <= PERSISTENT_MAX_SMEM:
        return "persistent"
    return "atomics"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_persistent(fn, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, with_cols):
    what = fn.__name__
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, torch.float32)
    if fused_pair_route(Ci, Cj, S) != "persistent":
        raise ValueError(f"{what}: no persistent kernel for Ci={Ci}, Cj={Cj}, S={S}")
    dev = ids2d.device
    rows = torch.empty((Ci, N), dtype=torch.float32, device=dev)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=dev) if with_cols else None
    # blocks resident on an SM: BLOCKS_PER_SM, fewer where the accumulator
    # (plus the 1 KB a block reserves) leaves no room for as many
    smem = Cj * S * 4 + 1024 if with_cols else 1024
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // smem))
    code = _cuda.lib().thallo_fused_pair_persistent(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(), rows.data_ptr(),
        cols.data_ptr() if with_cols else None, W, N, Ci, Cj, S, THREADS,
        per_sm * _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()),
        MERGE_MIN, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
    return rows, cols


def fused_pair_apply(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """ids2d [W, N] int32; blocks_wm [W*Ci*Cj, N] (or [W, Ci*Cj, N]) f32;
    pcol [Cj, S] f32; prow [Ci, N] f32 -> (rows [Ci, N], cols [Cj, S]) f32
    (any W; the solver sends W <= 8).  CPU tensors take the plain version;
    CUDA tensors launch the persistent kernel, or, where fused_pair_route
    says so, go to fused_pair_apply_atomics."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if fused_pair_route(Ci, Cj, S) == "atomics":
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


def fused_pair_apply_wloop(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The same contract as fused_pair_apply, for wide levels: blocks over
    (element tile, w-chunk), rows and cols summed per block first.  Cj
    channels are split into chunks whose [chunk, S] f32 accumulator fits
    the shared memory; S alone must fit it.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    W, N, blocks = _checked("fused_pair_apply_wloop", ids2d, blocks_wm, pcol, prow, Ci, Cj,
                            S, torch.float32)
    if S * 4 > _cuda.MAX_DYNAMIC_SMEM:
        raise ValueError(f"fused_pair_apply_wloop: S={S} exceeds the "
                         f"{_cuda.MAX_DYNAMIC_SMEM}-byte shared accumulator")
    rows = torch.zeros((Ci, N), dtype=torch.float32, device=ids2d.device)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=ids2d.device)
    code = _cuda.lib().thallo_fused_pair_wloop(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), W, N, Ci, Cj, S, _cuda.stream(ids2d))
    _cuda.check(code, "fused_pair_apply_wloop")
    fused_pair_apply_wloop.launches += 1
    return rows, cols


fused_pair_apply_wloop.launches = 0


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
