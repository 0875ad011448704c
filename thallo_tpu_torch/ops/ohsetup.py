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

On the card (``csrc/oh_setup.cu``): one thread per observation forms
each slab value from its rc + K inputs (coalesced reads, L1-resident
reuse) and adds it into ``out[f, id]`` with a global atomic — F*R adds
(99 M at BA-1M) spread over F*N addresses (101 k), about R/N per
address.  The bound is the atomic traffic, not the 80 MB of input.
The TPU kernel's in-VMEM one-hot and 3-term bf16 split are not carried
over: every sum is a plain f32 sum whose order varies with the atomics.

``oh_setup_aggregate`` replaces ``thallo_tpu/ops/ohsetup.py::
oh_setup_aggregate`` (Pallas body ``_kernel``): channel-major parts
``[F, R]`` summed by ``ids [R]`` into ``[F, N]``; ids outside [0, N)
drop.  The matrix-free schedules (PRECOMPUTE_J, APPLY_SEPARATELY) scatter
a small image's per-observation values with it (lower.py), in setup and
on every PCG iteration.  On the card (``csrc/oh_aggregate.cu``) each
thread block takes a contiguous run of rows, sums them into an
``[F_chunk, N]`` accumulator in shared memory (shared-memory atomics,
~R/N hits per address spread over the block), then adds each nonzero
entry into the output with one global atomic: about (blocks x F x N)
global atomics (2.3 M at BA-1M, F = 9) instead of F x R (9 M).  The
bound is the parts read, F*R*4 bytes.  Channels that do not fit the
shared accumulator at once run as further chunks (grid y).
"""
from __future__ import annotations

import torch

from . import _cuda

_KIND = {"jtr": 0, "d2": 1, "pair": 2}


def recipe_width(recipe) -> int:
    return sum(e[2] if e[0] in ("jtr", "d2") else e[2] * e[4] for e in recipe)


def setup_slabs(rT, Jall, recipe):
    """The recipe's slabs, stacked channel-major: [F, R] (f32, per
    observation, before any sum by id)."""
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
    """Plain torch version (f32): slabs [F, R], then index_add_ by id."""
    x = setup_slabs(rT.to(torch.float32), Jall.to(torch.float32), recipe)
    ok = (ids >= 0) & (ids < N)
    out = torch.zeros((x.shape[0], N), dtype=torch.float32, device=rT.device)
    return out.index_add_(1, ids[ok].long(), x[:, ok])


def oh_setup_products(rT, Jall, ids, *, N, recipe):
    """rT [rc, R] f32, Jall [K, R] f32, ids [R] int32, recipe: static
    tuple of ("jtr", off, C) | ("d2", off, C) | ("pair", offa, Ca, offb, Cb)
    -> [F, N] f32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if rT.device.type == "cpu":
        return oh_setup_products_reference(rT, Jall, ids, N=N, recipe=recipe)
    if rT.device.type != "cuda":
        raise ValueError(f"oh_setup_products: unsupported device {rT.device}")
    rc, R = rT.shape
    K = Jall.shape[0]
    dev = rT.device
    _cuda.require(rT, "rT", (rc, R), torch.float32, dev)
    _cuda.require(Jall, "Jall", (K, R), torch.float32, dev)
    _cuda.require(ids, "ids", (R,), torch.int32, dev)
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
    out = torch.zeros((F, N), dtype=torch.float32, device=dev)
    rec = _cuda.recipe_tensor(tuple(rows), dev)
    code = _cuda.lib().thallo_oh_setup_products(
        rT.data_ptr(), Jall.data_ptr(), ids.data_ptr(), rec.data_ptr(),
        out.data_ptr(), len(rows), rc, R, N, _cuda.stream(rT))
    _cuda.check(code, "oh_setup_products")
    oh_setup_products.launches += 1
    return out


oh_setup_products.launches = 0


def oh_setup_aggregate_reference(parts_cm, ids, *, N):
    """Plain torch version (f32): index_add_ of the in-range rows."""
    ok = (ids >= 0) & (ids < N)
    out = torch.zeros((parts_cm.shape[0], N), dtype=torch.float32, device=parts_cm.device)
    return out.index_add_(1, ids[ok].long(), parts_cm.to(torch.float32)[:, ok])


def oh_setup_aggregate(parts_cm, ids, *, N):
    """parts_cm [F, R] f32, ids [R] int32 -> [F, N] f32 (out-of-range ids
    drop).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if parts_cm.device.type == "cpu":
        return oh_setup_aggregate_reference(parts_cm, ids, N=N)
    if parts_cm.device.type != "cuda":
        raise ValueError(f"oh_setup_aggregate: unsupported device {parts_cm.device}")
    F, R = parts_cm.shape
    dev = parts_cm.device
    _cuda.require(parts_cm, "parts_cm", (F, R), torch.float32, dev)
    _cuda.require(ids, "ids", (R,), torch.int32, dev)
    if N * 4 > _cuda.MAX_DYNAMIC_SMEM:
        raise ValueError(f"oh_setup_aggregate: N={N} exceeds the "
                         f"{_cuda.MAX_DYNAMIC_SMEM}-byte shared accumulator")
    out = torch.zeros((F, N), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_oh_setup_aggregate(
        parts_cm.data_ptr(), ids.data_ptr(), out.data_ptr(), F, R, N, _cuda.stream(parts_cm))
    _cuda.check(code, "oh_setup_aggregate")
    oh_setup_aggregate.launches += 1
    return out


oh_setup_aggregate.launches = 0
