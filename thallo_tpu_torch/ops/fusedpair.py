"""Fused cross-pair block apply: both directions of a (row-slot,
small-image) JᵀJ pair per PCG iteration.

Replaces ``thallo_tpu/ops/fusedpair.py::fused_pair_apply`` (Pallas
bodies ``_kernel`` / ``_kernel_wloop``).  For blocks ``B[w, ci, cj, n]``
stored w-major (``[W*Ci*Cj, N]``, the same memory as ``[W, Ci*Cj, N]``):

  rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
  cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s

An entry (w, n) whose id lies outside [0, S) contributes to neither
output (row-table padding relies on this).  Two kernels compute it:

* ``fused_pair_apply`` (``csrc/fused_pair.cu``, JAX's ``_kernel``, levels
  with W <= 8): one thread per n loops over w, reads ids[w, n] and the
  Ci*Cj block entries with neighbouring threads on neighbouring n
  (coalesced), gathers pcol[:, id] (Cj*S floats, 36 KB at BA-1M,
  resident in L1/L2), owns rows[:, n] outright, and adds its Cj-vector z
  into cols[:, id] with global atomics.
* ``fused_pair_apply_wloop`` (``csrc/fused_pair_wloop.cu``, JAX's
  ``_kernel_wloop``, levels with W > 8, the wide and short tails of
  degree skew): blocks over (32-element tile, w-chunk); rows summed per
  block and added once, cols summed in a shared-memory [Cj, S]
  accumulator and added once per nonzero entry per block.

Both are bound by the block read, W*Ci*Cj*N*4 bytes (108 MB at W=4, 3x9,
N=250 000).  Unlike the TPU kernel there is no one-hot, no id
decomposition and no bf16 rounding: values stay f32.  Atomics make the
cols sums' order vary from run to run.

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


def fused_pair_apply(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """ids2d [W, N] int32; blocks_wm [W*Ci*Cj, N] (or [W, Ci*Cj, N]) f32;
    pcol [Cj, S] f32; prow [Ci, N] f32 -> (rows [Ci, N], cols [Cj, S]) f32.
    One thread per element (any W; the solver sends W <= 8).  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    W, N, blocks = _checked("fused_pair_apply", ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                            torch.float32)
    rows = torch.empty((Ci, N), dtype=torch.float32, device=ids2d.device)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=ids2d.device)
    code = _cuda.lib().thallo_fused_pair_apply(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), W, N, Ci, Cj, S, _cuda.stream(ids2d))
    _cuda.check(code, "fused_pair_apply")
    fused_pair_apply.launches += 1
    return rows, cols


fused_pair_apply.launches = 0


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
