"""Point-side setup on a FULL-REPEAT level (sorted uniform observation
maps: observation ``n*W + w`` belongs to element ``n``).

Replaces ``thallo_tpu/ops/fullrepeat.py::fullrepeat_setup`` (Pallas body
``_kernel``).  From the residual window ``rT_win [rc, N_t*W]`` and the
stacked channel-major Jacobian slot windows ``Jall_win [Kall, N_t*W]``
(slot rows ``off + c*C + ch``), each recipe entry yields:

  ("jtr", off, C)                      sum_w sum_c J * r          -> agg
  ("d2", off, C)                       sum_w sum_c J^2            -> agg
  ("diag", offa, Ca, offb, Cb)         sum_w sum_c Ja (x) Jb      -> agg
  ("cross", offa, Ca, offb, Cb, k)     per w: sum_c Ja_w (x) Jb_w -> cross k,
                                       w-major [W*Ca*Cb, N_t] (ops/fusedpair.py layout)

Returns ``(agg [F_agg, N_t], [cross_0, ...])``.

On the card (``csrc/fullrepeat.cu``): one thread per element n walks
its W contiguous observations, sums the aggregated slabs and writes the
per-w cross rows itself — no reduction across threads, no atomics, so
the result is deterministic.  Reads of ``[*, n*W + w]`` from
neighbouring threads share cache lines; writes of ``[row, n]`` are
coalesced.  The bound is memory: the (rc + Kall) * N_t * W * 4 input
bytes (104 MB at BA-1M) plus the cross output (108 MB).  The TPU
kernel's resident layout one-hot ``sel`` and its bf16 split are not
carried over: the element order is just an index.
"""
from __future__ import annotations

import torch

from . import _cuda

_KIND = {"jtr": 0, "d2": 1, "diag": 2, "cross": 3}


def fullrepeat_setup_reference(rT_win, Jall_win, *, W, N_t, recipe):
    """Plain torch version (f32) on [*, N_t, W] views of the windows."""
    rc = rT_win.shape[0]
    r = rT_win.to(torch.float32).reshape(rc, N_t, W)
    J = Jall_win.to(torch.float32).reshape(-1, N_t, W)
    agg, crosses = [], []
    for ent in recipe:
        kind = ent[0]
        if kind in ("jtr", "d2"):
            _, off, C = ent
            Jc = J[off:off + rc * C].reshape(rc, C, N_t, W)
            agg.append(((Jc * r[:, None]) if kind == "jtr" else (Jc * Jc)).sum(dim=(0, 3)))
            continue
        _, offa, Ca, offb, Cb = ent[:5]
        Ja = J[offa:offa + rc * Ca].reshape(rc, Ca, 1, N_t, W)
        Jb = J[offb:offb + rc * Cb].reshape(rc, 1, Cb, N_t, W)
        prod = (Ja * Jb).sum(0)  # [Ca, Cb, N_t, W]
        if kind == "diag":
            agg.append(prod.sum(-1).reshape(Ca * Cb, N_t))
        else:
            crosses.append(prod.permute(3, 0, 1, 2).reshape(W * Ca * Cb, N_t))
    if agg:
        agg = torch.cat(agg)
    else:
        agg = torch.zeros((1, N_t), dtype=torch.float32, device=rT_win.device)
    return agg, crosses


def fullrepeat_setup(rT_win, Jall_win, *, W, N_t, recipe):
    """rT_win [rc, N_t*W] f32, Jall_win [Kall, N_t*W] f32, static recipe
    -> (agg [F_agg, N_t], [cross_k [W*Ca*Cb, N_t]]) f32.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if rT_win.device.type == "cpu":
        return fullrepeat_setup_reference(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    if rT_win.device.type != "cuda":
        raise ValueError(f"fullrepeat_setup: unsupported device {rT_win.device}")
    rc = rT_win.shape[0]
    Kall = Jall_win.shape[0]
    dev = rT_win.device
    _cuda.require(rT_win, "rT_win", (rc, N_t * W), torch.float32, dev)
    _cuda.require(Jall_win, "Jall_win", (Kall, N_t * W), torch.float32, dev)
    rows, F_agg, cross_rows, cross_widths = [], 0, 0, []
    for ent in recipe:
        kind = _KIND[ent[0]]
        if kind <= 1:
            _, off, C = ent
            rows.append((kind, off, C, 0, 0, F_agg))
            F_agg += C
        elif kind == 2:
            _, offa, Ca, offb, Cb = ent
            rows.append((kind, offa, Ca, offb, Cb, F_agg))
            F_agg += Ca * Cb
        else:
            _, offa, Ca, offb, Cb, k = ent
            if k != len(cross_widths):
                raise ValueError("fullrepeat_setup: cross entries must be numbered 0, 1, ...")
            rows.append((kind, offa, Ca, offb, Cb, cross_rows))
            cross_widths.append(W * Ca * Cb)
            cross_rows += W * Ca * Cb
        if max(rows[-1][1] + rc * rows[-1][2],
               rows[-1][3] + rc * rows[-1][4]) > Kall:
            raise ValueError(f"fullrepeat_setup: recipe entry {ent} reads past Kall={Kall}")
    agg = torch.zeros((max(F_agg, 1), N_t), dtype=torch.float32, device=dev)
    cross = torch.empty((max(cross_rows, 1), N_t), dtype=torch.float32, device=dev)
    rec = _cuda.recipe_tensor(tuple(rows), dev)
    code = _cuda.lib().thallo_fullrepeat_setup(
        rT_win.data_ptr(), Jall_win.data_ptr(), rec.data_ptr(), agg.data_ptr(),
        cross.data_ptr(), len(rows), rc, W, N_t, _cuda.stream(rT_win))
    _cuda.check(code, "fullrepeat_setup")
    fullrepeat_setup.launches += 1
    return agg, list(torch.split(cross[:cross_rows], cross_widths)) if cross_widths else []


fullrepeat_setup.launches = 0
