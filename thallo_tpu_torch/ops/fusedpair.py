"""Fused cross-pair block apply: both directions of a (row-slot,
small-image) JᵀJ pair per PCG iteration.

Replaces ``thallo_tpu/ops/fusedpair.py::fused_pair_apply`` (Pallas
bodies ``_kernel`` / ``_kernel_wloop``).  For blocks ``B[w, ci, cj, n]``
stored w-major (``[W*Ci*Cj, N]``, the same memory as ``[W, Ci*Cj, N]``):

  rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
  cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s

An entry (w, n) whose id lies outside [0, S) contributes to neither
output (row-table padding relies on this).

On the card (``csrc/fused_pair.cu``): one thread per n loops over w,
reads ids[w, n] and the Ci*Cj block entries with neighbouring threads on
neighbouring n (coalesced), gathers pcol[:, id] (Cj*S floats, 36 KB at
BA-1M, resident in L1/L2), owns rows[:, n] outright, and adds its
Cj-vector z into cols[:, id] with global atomics.  The bound is the
block read: W*Ci*Cj*N*4 bytes per call (108 MB at W=4, 3x9,
N=250 000), so the kernel is memory-bound; atomics land on Cj*S
addresses spread by camera id.  Unlike the TPU kernel there is no
one-hot, no id decomposition and no bf16 rounding: values stay f32.
Atomics make the cols sums' order vary from run to run.
"""
from __future__ import annotations

import torch

from . import _cuda


def fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Plain torch version (f32): the CPU path and the card-side oracle."""
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


MAX_CI, MAX_CJ = 8, 16  # csrc/fused_pair.cu register-array bounds


def fused_pair_apply(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """ids2d [W, N] int32; blocks_wm [W*Ci*Cj, N] (or [W, Ci*Cj, N]) f32;
    pcol [Cj, S] f32; prow [Ci, N] f32 -> (rows [Ci, N], cols [Cj, S]) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow,
                                          Ci=Ci, Cj=Cj, S=S)
    if ids2d.device.type != "cuda":
        raise ValueError(f"fused_pair_apply: unsupported device {ids2d.device}")
    if not (1 <= Ci <= MAX_CI and 1 <= Cj <= MAX_CJ and S >= 1):
        raise ValueError(f"fused_pair_apply: Ci={Ci}, Cj={Cj}, S={S} outside "
                         f"[1, {MAX_CI}] x [1, {MAX_CJ}] x [1, inf)")
    W, N = ids2d.shape
    dev = ids2d.device
    blocks = blocks_wm.reshape(W * Ci * Cj, N)
    _cuda.require(ids2d, "ids2d", (W, N), torch.int32, dev)
    _cuda.require(blocks, "blocks_wm", (W * Ci * Cj, N), torch.float32, dev)
    _cuda.require(pcol, "pcol", (Cj, S), torch.float32, dev)
    _cuda.require(prow, "prow", (Ci, N), torch.float32, dev)
    rows = torch.empty((Ci, N), dtype=torch.float32, device=dev)
    cols = torch.zeros((Cj, S), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_fused_pair_apply(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), W, N, Ci, Cj, S, _cuda.stream(ids2d))
    _cuda.check(code, "fused_pair_apply")
    fused_pair_apply.launches += 1
    return rows, cols


fused_pair_apply.launches = 0
