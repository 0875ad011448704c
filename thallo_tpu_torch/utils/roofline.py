"""Roofline accounting: modeled device-memory bytes per marginal PCG
iteration (counterpart of ``thallo_tpu/utils/roofline.py``, function for
function, over the port's own tables).

A PCG iteration is bound by memory, so the hardware-efficiency metric is
the achieved bandwidth as a fraction of the card's peak, not a FLOP
share.  The model counts real bytes only (no per-index penalty
equivalents: those belong to the schedule cost model, schedule.py):
every byte a marginal PCG iteration must move given the plan's schedule,
assuming the elementwise chains fused and no re-reads beyond the
algorithmic ones.  It is a lower bound on traffic, so a fraction against
it understates the card's efficiency, as JAX's does.  The block-sparse
term walks the port's tables (solver/blocksparse.py: ``pairs``,
``col_gathers``, ``cols``, ``slot_channels``), whose shapes are JAX's but
for JAX's TPU padding (JAX's level widths are padded, its affine maps
keyed by segment); the others read ``schedule._group_stats``.
"""
from __future__ import annotations

import os

import numpy as np

# H100 SXM HBM3 peak (NVIDIA data sheet); THALLO_HBM_PEAK_GBPS for another card
HBM_PEAK_GBPS = float(os.environ.get("THALLO_HBM_PEAK_GBPS", "3350"))


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


def _unknown_bytes(plan) -> int:
    return sum(int(np.prod([d.size for d in im.dims])) * im.channels * _itemsize(plan.dtype)
               for im in plan.spec.unknowns)


def _bsr_iter_bytes(bsr, block_itemsize, f32=4) -> int:
    """Bytes one block-sparse apply moves: the pair blocks (the dominant
    term), the gathered column operands, and the accumulators."""
    total = 0
    elems = {n: int(np.prod(s[:-1])) for n, s in bsr.image_shapes.items()}
    for pr in bsr.pairs:
        i, j = pr[0], pr[1]
        Ci, Cj = bsr.slot_channels[i], bsr.slot_channels[j]
        if pr[2] == "diag":
            N = elems[bsr.slot_images[i]]
            total += Ci * Cj * N * f32          # diag blocks stay in the value dtype
            total += Cj * N * f32               # p operand
        elif pr[2] == "col":
            ct = bsr.col_gathers[pr[3]][0]
            W, Nt = bsr.cols[ct].shape
            total += Ci * Cj * W * Nt * block_itemsize  # cross blocks
            total += Cj * W * Nt * f32          # gathered p columns
        else:  # transpose: the partner's blocks, read once by the fused pair
            partner = bsr.pairs[pr[3]]
            ct = bsr.col_gathers[partner[3]][0]
            W, Nt = bsr.cols[ct].shape
            total += Cj * Nt * f32              # p rows (broadcast over W)
    for i in set(pr[0] for pr in bsr.pairs):   # per-row-slot accumulator writes
        total += bsr.slot_channels[i] * elems[bsr.slot_images[i]] * f32
    return total


def _inline_iter_bytes(gp, dtype_bytes) -> int:
    """INLINE/LINEARIZE groups re-evaluate J·p and Jᵀ·q each iteration:
    ~4 passes (jvp forward + tangent, vjp forward + cotangent; LINEARIZE:
    2) over the slot gathers, consts and residuals."""
    from ..schedule import _group_stats
    from ..spec import JTJpSchedule

    st = _group_stats(gp, dtype_bytes)
    passes = 2.0 if gp.schedule == JTJpSchedule.LINEARIZE else 4.0
    return int(passes * (st["gather_bytes"] + st["const_bytes"] + st["res_bytes"]))


def pcg_iter_traffic_bytes(plan) -> int:
    """Modeled bytes per MARGINAL PCG iteration of this plan: the groups'
    JᵀJ·p traffic (by schedule) + the PCG vector updates (p, r, z, delta,
    Ap: ~8 unknown-vector passes over PCGStep1-3 and the dots) + the
    preconditioner read (scalar, or block-Jacobi)."""
    from ..schedule import DENSE_JTJ_MAX_UNKNOWNS, _group_stats
    from ..spec import JTJpSchedule

    comp = plan.compiled
    f32 = _itemsize(plan.dtype)
    block_itemsize = 2 if comp.block_dtype is not None else f32
    total = 0
    consts = plan._prep.get("consts", []) if isinstance(plan._prep, dict) else []
    for gi, gp in enumerate(comp.groups):
        c = consts[gi] if gi < len(consts) else None
        bsr = c.get("bsr") if isinstance(c, dict) else None
        if bsr is not None and comp._wants_bsr(gp):
            total += _bsr_iter_bytes(bsr, block_itemsize, f32)
        elif gp.schedule in (JTJpSchedule.PRECOMPUTE_JTJ, JTJpSchedule.PRECOMPUTE_J_THEN_JTJ):
            st = _group_stats(gp, f32)
            n = st["unknown_elems"]
            if n <= DENSE_JTJ_MAX_UNKNOWNS:
                total += n * n * f32  # dense gemv
            else:
                total += 2 * (st["jblock_bytes"] + st["gather_bytes"])
        elif gp.schedule in (JTJpSchedule.PRECOMPUTE_J, JTJpSchedule.APPLY_SEPARATELY):
            st = _group_stats(gp, f32)
            total += 2 * (st["jblock_bytes"] + st["gather_bytes"])
        else:
            total += _inline_iter_bytes(gp, f32)
    ub = _unknown_bytes(plan)
    total += 8 * ub  # p/r/z/delta/Ap updates + alpha/beta dots
    total += ub      # the preconditioner: one unknown pass (scalar)
    if comp.precond_kind in ("auto", "block_jacobi"):
        for im in plan.spec.unknowns:
            N = int(np.prod([d.size for d in im.dims]))
            total += im.channels * im.channels * N * f32
    return int(total)


def roofline(plan, marginal_iter_s: float) -> dict:
    """Achieved GB/s and fraction of the card's peak for a measured
    marginal PCG-iteration time."""
    b = pcg_iter_traffic_bytes(plan)
    gbps = b / max(marginal_iter_s, 1e-12) / 1e9
    return {
        "modeled_bytes_per_iter": b,
        "achieved_gbps": round(gbps, 1),
        "hbm_peak_gbps": HBM_PEAK_GBPS,
        "hbm_fraction": round(gbps / HBM_PEAK_GBPS, 4),
    }
