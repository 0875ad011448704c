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

The bound is memory: the (rc + Kall) * N_t * W * 4 input bytes (104 MB
at BA-1M) plus the outputs (123 MB).  Three kernels compute it
(``csrc/fullrepeat.cu``):

* ``fullrepeat_setup``: the tile kernel, for 2 <= W <= 8, rc <= 8 and a
  window that fits the shared memory (``fullrepeat_plan``).  A persistent
  block walks over tiles of T elements; it copies each tile's
  [rc + Kall, T*W] input window into shared memory with 16-byte
  ``cp.async`` copies (each input byte read once, coalesced), the next
  tile's copy in flight while it computes the current one.  The plan
  turns the recipe into channels, each a product
  sum_c X[a0 + c*sa] * X[b0 + c*sb] over the stacked inputs X = [rT; Jall],
  summed over w into an agg row or kept per w as W cross rows, grouped by
  their first operand (BA's point side: 39 channels in 3 groups, one per
  point channel; a symmetric diag pair keeps a <= b and writes the
  mirror).  A thread takes an (element, group) item: it reads the group's
  first operand into registers once, each channel's second operand from
  shared memory, and writes the channel's rows at its element, a warp
  over 32 consecutive elements (coalesced stores).  The TPU kernel's
  relayout by a one-hot ``sel`` dot is an indexing choice here: the
  window stays in observation order and a thread reads its element's W
  observations of a row as one vector (conflict-free for W = 2, 4).
* ``fullrepeat_setup_wide``: the wide kernel, for every shape the tile
  plan refuses (W > 8, rc > 8, Kall > 128; W = 1), planned by
  ``fullrepeat_wide_plan``.  The same staged windows, but nothing of W in
  registers: an (element, channel) item loops over w at run time with both
  operands read from shared memory (two observations a load where the
  pitch is even), the window staged at pitch W with 16-byte copies where
  that reads without bank conflicts (``read_conflict``; BA's W = 10), else
  at an odd pitch with scalar copies, and, where one element's window does
  not fit at T = 32, in w-chunks with the agg partials in shared memory.
* ``fullrepeat_setup_thread``: the first body: one thread per element
  walks its W observations and reloads every operand from global memory.
  On no route; kept for measurement (``chip_smoke.py`` phases 2 and 8).
  ``fullrepeat_route`` names it only for a shape without a wide plan
  either: rc + Kall window rows too many for one observation of 32
  elements in shared memory (over ~1 800 rows in f32, ~900 in f64).

No atomics in any, so the sums are deterministic.  The TPU kernel's
bf16 split is not carried over.

**f64** (the solver's ``double_precision``): ``fullrepeat_setup`` hands
f64 windows to ``fullrepeat_setup_f64``, the f64 instantiation of the tile
kernel (16-byte ``cp.async`` copies of 2 values; tiles planned at 8 bytes
a value: BA's point level takes T = 64 with two windows), or, for a shape
without an f64 tile plan (W > 8, rc > 8, Kall > 128: a scene whose points
are each seen by 10 cameras), to ``fullrepeat_setup_wide_f64``, the wide
kernel's f64 instantiation.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda

_KIND = {"jtr": 0, "d2": 1, "diag": 2, "cross": 3}
# the tile kernel (csrc/fullrepeat.cu): elements per tile, blocks per SM,
# the cap on threads per block (kMaxTileThreads there), and the shapes it
# is compiled for (W a template parameter; rc bounds a register array)
FULLREPEAT_TILE = 128
FULLREPEAT_BLOCKS_PER_SM = 2
FULLREPEAT_THREADS = 512
MIN_W, MAX_W, MAX_RC, MAX_KALL = 2, 8, 8, 128
# the wide kernel (csrc/fullrepeat.cu fullrepeat_wide_kernel): the largest
# tile, the blocks per SM it tries first, the cap on threads per block (f32,
# f64), the most stages, and the most shared-memory wavefronts a warp's read
# at pitch W may take over the least (else an odd pitch: scalar copies,
# conflict-free reads; 0: always odd); MAX_WIDE_THREADS is kMaxWideThreads
# there.  From scripts/torch_redesign_sweep.py --only fullrepeat --sweep at
# BA's W = 10 point level (N_t 100 000; NVIDIA H100 80GB HBM3, 700 W;
# PERF.md, Findings): pitch W with pair reads 0.083-0.087 ms in f32 and
# 0.156-0.170 in f64, against 0.128-0.154 and 0.159-0.198 at pitch 11;
# f32 fastest at 640 threads (0.0856 at two blocks an SM, 0.0830 at one,
# 0.0913 at 256 threads), f64 at 256 (0.156, against 0.169 at 640); a tile
# of 64 no faster
WIDE_TILE = 32
WIDE_BLOCKS_PER_SM = 2
WIDE_THREADS = 1024
WIDE_THREADS_F64 = 256
WIDE_MAX_STAGES = 2
WIDE_MAX_CONFLICT = 2
MAX_WIDE_THREADS = 1024


def fullrepeat_setup_reference(rT_win, Jall_win, *, W, N_t, recipe):
    """Plain torch version, in rT_win's dtype (f32 or f64), on [*, N_t, W]
    views of the windows."""
    rc = rT_win.shape[0]
    r = rT_win.reshape(rc, N_t, W)
    J = Jall_win.to(rT_win.dtype).reshape(-1, N_t, W)
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
        agg = torch.zeros((1, N_t), dtype=rT_win.dtype, device=rT_win.device)
    return agg, crosses


def _recipe_rows(recipe, rc, Kall, W):
    """The recipe as the first body's rows (kind, offa, Ca, offb, Cb, f0),
    F_agg and the cross widths; raises on an entry that reads past Kall or
    a cross entry out of order."""
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
    return tuple(rows), F_agg, tuple(cross_widths)


class FullrepeatPlan(NamedTuple):
    """The recipe for the tile kernel: groups[g] = (a0, sa, j0, j1), the
    first operand rows a0 + c*sa of the stacked [rT; Jall] shared by
    channels j0 <= j < j1; chans[j] = (b0, sb, row, step), the second
    operand and where the channel goes: step == 0 agg row `row` (summed
    over w), step < 0 agg row `row` and its mirror row -1 - step, step > 0
    cross rows row + w*step.  T elements per tile, `stages` windows in
    shared memory (2: the next tile's copy overlaps the current tile's
    work), threads per block, blocks_per_sm, block_smem bytes."""
    groups: Tuple[Tuple[int, int, int, int], ...]
    chans: Tuple[Tuple[int, int, int, int], ...]
    F_agg: int
    cross_widths: Tuple[int, ...]
    T: int
    stages: int
    threads: int
    blocks_per_sm: int
    block_smem: int


def _channels(recipe, rc, W):
    """Groups and channels of a recipe (FullrepeatPlan's first fields)."""
    by_a, F, cbase, widths = {}, 0, 0, []
    for ent in recipe:
        kind = ent[0]
        if kind in ("jtr", "d2"):
            _, off, C = ent
            for ch in range(C):
                a = (rc + off + ch, C)
                by_a.setdefault(a, []).append((0, 1, F + ch, 0) if kind == "jtr"
                                              else a + (F + ch, 0))
            F += C
            continue
        _, offa, Ca, offb, Cb = ent[:5]
        sym = kind == "diag" and offa == offb and Ca == Cb
        for a in range(Ca):
            for b in range(a if sym else 0, Cb):
                if kind == "diag":
                    mirror = F + b * Ca + a
                    ch = (rc + offb + b, Cb, F + a * Cb + b,
                          -1 - mirror if sym and b != a else 0)
                else:
                    ch = (rc + offb + b, Cb, cbase + a * Cb + b, Ca * Cb)
                by_a.setdefault((rc + offa + a, Ca), []).append(ch)
        if kind == "diag":
            F += Ca * Cb
        else:
            widths.append(W * Ca * Cb)
            cbase += W * Ca * Cb
    groups, chans = [], []
    for (a0, sa), cs in by_a.items():
        groups.append((a0, sa, len(chans), len(chans) + len(cs)))
        chans += cs
    return tuple(groups), tuple(chans), F, tuple(widths)


def tile_smem(rc, Kall, W, T, stages, n_groups, n_chans, itemsize=4) -> int:
    """Shared memory of a tile-kernel block (csrc/fullrepeat.cu): the input
    windows (itemsize bytes a value) and the group and channel tables."""
    return stages * (rc + Kall) * T * W * itemsize + (n_groups + n_chans) * 16


@functools.lru_cache(maxsize=64)
def fullrepeat_plan(recipe, W: int, Kall: int, rc: int, tile: int = FULLREPEAT_TILE,
                    blocks_per_sm: int = FULLREPEAT_BLOCKS_PER_SM,
                    threads: int = FULLREPEAT_THREADS,
                    itemsize: int = 4) -> Optional[FullrepeatPlan]:
    """The tile kernel's plan for a recipe at (W, Kall, rc): `blocks_per_sm`
    blocks to an SM if they fit, else fewer; two windows (double-buffered)
    if they fit, else one; the largest tile of at most `tile` elements (a
    multiple of 32) that fits; threads: one per (element, group) item, at most
    `threads`.  None outside 2 <= W <= 8, rc <= 8, Kall <= 128 (those
    shapes take fullrepeat_setup_thread).  itemsize: 4, or 8 for the f64
    instantiation.  Pure Python, cached per static recipe."""
    if not (MIN_W <= W <= MAX_W and 1 <= rc <= MAX_RC and Kall <= MAX_KALL):
        return None
    groups, chans, F_agg, widths = _channels(recipe, rc, W)
    for bps in range(blocks_per_sm, 0, -1):
        budget = _cuda.SM_SMEM // bps - 1024  # a block reserves 1 KB
        for stages in (2, 1):
            for T in range(tile, 31, -32):
                smem = tile_smem(rc, Kall, W, T, stages, len(groups), len(chans), itemsize)
                if smem <= budget:
                    return FullrepeatPlan(groups, chans, F_agg, widths, T, stages,
                                          min(threads, T * max(len(groups), 1)), bps, smem)
    return None


class FullrepeatWidePlan(NamedTuple):
    """The recipe for the wide kernel: chans[j] = (a0, sa, b0, sb, row,
    step, 0, 0), channel j's product sum_c X[a0 + c*sa] * X[b0 + c*sb] over
    the stacked [rT; Jall] and where it goes (FullrepeatPlan's step rule).
    T elements a tile, Wc observations a chunk (one chunk: Wc == W), the
    staged window's element pitch, `stages` windows in shared memory,
    threads per block, blocks_per_sm, block_smem bytes."""
    chans: Tuple[Tuple[int, ...], ...]
    F_agg: int
    cross_widths: Tuple[int, ...]
    T: int
    Wc: int
    pitch: int
    stages: int
    threads: int
    blocks_per_sm: int
    block_smem: int


def wide_smem(rc, Kall, T, pitch, stages, n_chans, n_chunks, itemsize=4) -> int:
    """Shared memory of a wide-kernel block: the windows [rc + Kall, T,
    pitch], the channel table (32 bytes a channel) and, with more than one
    chunk, the agg partials (one value an item)."""
    return (stages * (rc + Kall) * T * pitch * itemsize + 32 * n_chans
            + (n_chans * T * itemsize if n_chunks > 1 else 0))


@functools.lru_cache(maxsize=256)
def read_conflict(pitch, itemsize) -> float:
    """Shared-memory wavefronts of a warp's read of one window row (lane n
    at n * pitch; a pair of values a lane where pitch is even, as the kernel
    loads them) over the least such a read takes: 1 is conflict-free.  Each
    wavefront serves 128 bytes of lanes; a bank (4 bytes) serves one word a
    wavefront."""
    vec = 2 if pitch % 2 == 0 else 1
    words = itemsize * vec // 4            # 4-byte words a lane reads
    per_phase = 32 // words                # lanes a wavefront can serve
    fronts = 0
    for p0 in range(0, 32, per_phase):
        banks = {}
        for n in range(p0, p0 + per_phase):
            for k in range(words):
                word = n * pitch * itemsize // 4 + k
                banks.setdefault(word % 32, set()).add(word)
        fronts += max(len(v) for v in banks.values())
    return fronts / (32 // per_phase)


def _wide_threads(items, cap):
    """Threads a block: the items of a unit in the fewest rounds of at
    most `cap` threads, spread evenly, whole warps."""
    per_round = -(-items // -(-items // cap))
    return max(32, -(-per_round // 32) * 32)


@functools.lru_cache(maxsize=64)
def fullrepeat_wide_plan(recipe, W: int, Kall: int, rc: int, itemsize: int = 4,
                         tile: int = WIDE_TILE, blocks_per_sm: int = WIDE_BLOCKS_PER_SM,
                         threads: int = WIDE_THREADS, max_stages: int = WIDE_MAX_STAGES,
                         max_conflict: float = WIDE_MAX_CONFLICT
                         ) -> Optional[FullrepeatWidePlan]:
    """The wide kernel's plan for a recipe at (W, Kall, rc), itemsize 4
    or 8 (f64).  Two stages (the next unit's copy overlaps the current
    one's work) before more blocks an SM; then the most blocks an SM, up
    to `blocks_per_sm`; then the largest tile of at most `tile` elements (a
    multiple of 32) whose whole window of W observations fits.  Where none
    does, w-chunks at T = 32 and one block an SM: the fewest chunks that
    fit, balanced.  pitch: Wc where a warp's read at that pitch takes at
    most max_conflict times the least wavefronts (read_conflict), else the
    smallest odd number >= Wc.  None where even one observation of 32
    elements does not fit (fullrepeat_route then names the first body).
    Pure Python, cached per static recipe."""
    if W < 1 or rc < 1:
        return None
    groups, chans, F_agg, widths = _channels(recipe, rc, W)
    table = tuple((a0, sa, b0, sb, row, step, 0, 0)
                  for a0, sa, j0, j1 in groups for b0, sb, row, step in chans[j0:j1])
    n = len(table)

    def pitch(wc):
        return wc if read_conflict(wc, itemsize) <= max_conflict else wc | 1

    def plan(T, wc, stages, bps, smem):
        return FullrepeatWidePlan(table, F_agg, widths, T, wc, pitch(wc), stages,
                                  _wide_threads(max(n, 1) * T, threads), bps, smem)

    stage_counts = (2, 1) if max_stages == 2 else (1,)
    for stages in stage_counts:
        for bps in range(blocks_per_sm, 0, -1):
            budget = _cuda.SM_SMEM // bps - 1024  # a block reserves 1 KB
            for T in range(tile, 31, -32):
                smem = wide_smem(rc, Kall, T, pitch(W), stages, n, 1, itemsize)
                if smem <= budget:
                    return plan(T, W, stages, bps, smem)
        for chunks in range(2, W + 1):
            wc = -(-W // chunks)
            smem = wide_smem(rc, Kall, 32, pitch(wc), stages, n, chunks, itemsize)
            if smem <= _cuda.SM_SMEM - 1024:
                return plan(32, wc, stages, 1, smem)
    return None


def _wide_plan(recipe, W, Kall, rc, itemsize):
    return fullrepeat_wide_plan(tuple(recipe), W, Kall, rc, itemsize, WIDE_TILE,
                                WIDE_BLOCKS_PER_SM,
                                WIDE_THREADS_F64 if itemsize == 8 else WIDE_THREADS,
                                WIDE_MAX_STAGES, WIDE_MAX_CONFLICT)


def fullrepeat_route(recipe, W: int, Kall: int, rc: int, dtype=torch.float32) -> str:
    """The kernel fullrepeat_setup launches on the card at this shape, by
    the name of its wrapper: the tile kernel where fullrepeat_plan has a
    plan (at dtype's itemsize), else the wide kernel where
    fullrepeat_wide_plan has one, else the first body (a window of more
    rows than one observation of 32 elements holds in shared memory); "_f64"
    for f64 windows."""
    f64 = dtype == torch.float64
    itemsize = 8 if f64 else 4
    if fullrepeat_plan(tuple(recipe), W, Kall, rc, FULLREPEAT_TILE,
                       FULLREPEAT_BLOCKS_PER_SM, FULLREPEAT_THREADS, itemsize):
        name = "fullrepeat_setup"
    elif _wide_plan(recipe, W, Kall, rc, itemsize):
        name = "fullrepeat_setup_wide"
    else:
        name = "fullrepeat_setup_thread"
    return name + ("_f64" if f64 else "")


def fullrepeat_grid(plan: FullrepeatPlan, N_t: int, sms: int) -> int:
    """Persistent blocks: plan.blocks_per_sm per SM, no more than tiles."""
    return max(1, min(plan.blocks_per_sm * sms, -(-N_t // plan.T)))


def fullrepeat_setup_planned(rT_win, Jall_win, *, W, N_t, recipe, **plan_kw):
    """What the tile kernel computes, from its plan alone, in plain torch
    (in rT_win's dtype): every channel's product at every element, written
    to its agg row (and mirror) or its W cross rows; rows no channel
    writes stay NaN."""
    rc, Kall = rT_win.shape[0], Jall_win.shape[0]
    plan = fullrepeat_plan(tuple(recipe), W, Kall, rc, **plan_kw)
    dt = rT_win.dtype
    X = torch.cat([rT_win, Jall_win.to(dt)]).reshape(rc + Kall, N_t, W)
    dev = rT_win.device
    agg = torch.full((max(plan.F_agg, 1), N_t), float("nan"), dtype=dt, device=dev)
    cross = torch.full((max(sum(plan.cross_widths), 1), N_t), float("nan"), dtype=dt,
                       device=dev)
    c = torch.arange(rc, device=dev)
    for a0, sa, j0, j1 in plan.groups:
        xa = X[a0 + sa * c]  # [rc, N_t, W]
        for b0, sb, row, step in plan.chans[j0:j1]:
            s = (xa * X[b0 + sb * c]).sum(0)  # [N_t, W]
            if step > 0:
                cross[row + step * torch.arange(W, device=dev)] = s.T
            else:
                agg[row] = s.sum(-1)
                if step < 0:
                    agg[-1 - step] = agg[row]
    return agg, list(torch.split(cross, plan.cross_widths)) if plan.cross_widths else []


def fullrepeat_setup_wide_planned(rT_win, Jall_win, *, W, N_t, recipe, itemsize=4,
                                  **plan_kw):
    """What the wide kernel computes, from its plan alone, in plain torch
    (in rT_win's dtype): chunk by chunk, every channel's product at every
    element, its cross rows written per w, its agg sum carried over the
    chunks and written (and mirrored) after the last; rows no channel
    writes stay NaN."""
    rc, Kall = rT_win.shape[0], Jall_win.shape[0]
    plan = fullrepeat_wide_plan(tuple(recipe), W, Kall, rc, itemsize, **plan_kw)
    dt, dev = rT_win.dtype, rT_win.device
    X = torch.cat([rT_win, Jall_win.to(dt)]).reshape(rc + Kall, N_t, W)
    agg = torch.full((max(plan.F_agg, 1), N_t), float("nan"), dtype=dt, device=dev)
    cross = torch.full((max(sum(plan.cross_widths), 1), N_t), float("nan"), dtype=dt,
                       device=dev)
    c = torch.arange(rc, device=dev)
    part = {}
    for w0 in range(0, W, plan.Wc):
        ws = torch.arange(w0, min(W, w0 + plan.Wc), device=dev)
        for j, (a0, sa, b0, sb, row, step, _, _) in enumerate(plan.chans):
            s = (X[a0 + sa * c][:, :, ws] * X[b0 + sb * c][:, :, ws]).sum(0)  # [N_t, wc]
            if step > 0:
                cross[row + step * ws] = s.T
            else:
                part[j] = part.get(j, 0) + s.sum(-1)
    for j, (_, _, _, _, row, step, _, _) in enumerate(plan.chans):
        if step <= 0:
            agg[row] = part[j]
            if step < 0:
                agg[-1 - step] = part[j]
    return agg, list(torch.split(cross, plan.cross_widths)) if plan.cross_widths else []


def _checked(what, rT_win, Jall_win, W, N_t, dt=torch.float32):
    if rT_win.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {rT_win.device}")
    rc, Kall, dev = rT_win.shape[0], Jall_win.shape[0], rT_win.device
    _cuda.require(rT_win, "rT_win", (rc, N_t * W), dt, dev)
    _cuda.require(Jall_win, "Jall_win", (Kall, N_t * W), dt, dev)
    return rc, Kall, dev


def _outputs(F_agg, cross_widths, N_t, dev, dt=torch.float32):
    """agg and cross for a kernel that writes every row (a recipe without
    agg entries returns one row of zeros, as the plain version does)."""
    agg = (torch.empty if F_agg else torch.zeros)((max(F_agg, 1), N_t), dtype=dt, device=dev)
    cross = torch.empty((max(sum(cross_widths), 1), N_t), dtype=dt, device=dev)
    return agg, cross


def _split(cross, cross_widths):
    return list(torch.split(cross[:sum(cross_widths)], cross_widths)) if cross_widths else []


def fullrepeat_setup(rT_win, Jall_win, *, W, N_t, recipe):
    """rT_win [rc, N_t*W] f32, Jall_win [Kall, N_t*W] f32, static recipe
    -> (agg [F_agg, N_t], [cross_k [W*Ca*Cb, N_t]]) f32.  CPU tensors take
    the plain version; CUDA tensors launch the kernel fullrepeat_route
    names: the tile kernel, or, where fullrepeat_plan has no plan for the
    shape, fullrepeat_setup_wide (fullrepeat_setup_thread where that has
    none either); f64 windows go to fullrepeat_setup_f64."""
    if rT_win.device.type == "cpu":
        return fullrepeat_setup_reference(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    if rT_win.dtype == torch.float64:
        return fullrepeat_setup_f64(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    return _routed(fullrepeat_setup, rT_win, Jall_win, W, N_t, recipe, torch.float32)


def fullrepeat_setup_f64(rT_win, Jall_win, *, W, N_t, recipe):
    """fullrepeat_setup in f64 (windows f64 -> agg, crosses f64): the f64
    instantiation of the tile kernel, or, for a shape without an f64 tile
    plan, fullrepeat_setup_wide_f64 (fullrepeat_setup_thread_f64 where that
    has none either).  CPU tensors take the plain version."""
    if rT_win.device.type == "cpu":
        return fullrepeat_setup_reference(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    return _routed(fullrepeat_setup_f64, rT_win, Jall_win, W, N_t, recipe, torch.float64)


def _routed(fn, rT_win, Jall_win, W, N_t, recipe, dt):
    rc, Kall, dev = _checked(fn.__name__, rT_win, Jall_win, W, N_t, dt)
    _recipe_rows(recipe, rc, Kall, W)
    route = fullrepeat_route(recipe, W, Kall, rc, dt)
    if route != fn.__name__:
        return globals()[route](rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    plan = fullrepeat_plan(tuple(recipe), W, Kall, rc, FULLREPEAT_TILE,
                           FULLREPEAT_BLOCKS_PER_SM, FULLREPEAT_THREADS, dt.itemsize)
    return _launch_tiles(fn, rT_win, Jall_win, W, N_t, plan)


def _launch_tiles(fn, rT_win, Jall_win, W, N_t, plan):
    rc, Kall, dev, dt = rT_win.shape[0], Jall_win.shape[0], rT_win.device, rT_win.dtype
    agg, cross = _outputs(plan.F_agg, plan.cross_widths, N_t, dev, dt)
    groups = _cuda.recipe_tensor(plan.groups, dev)
    chans = _cuda.recipe_tensor(plan.chans, dev)
    launch = (_cuda.lib().thallo_fullrepeat_setup_tiles_f64 if dt == torch.float64
              else _cuda.lib().thallo_fullrepeat_setup_tiles)
    code = launch(rT_win.data_ptr(), Jall_win.data_ptr(), groups.data_ptr(), chans.data_ptr(),
                  agg.data_ptr(), cross.data_ptr(), len(plan.groups), len(plan.chans), rc, Kall,
                  W, N_t, plan.T, plan.stages, plan.threads,
                  fullrepeat_grid(plan, N_t, _cuda.sm_count(dev)), _cuda.stream(rT_win))
    _cuda.check(code, fn.__name__)
    fn.launches += 1
    return agg, _split(cross, plan.cross_widths)


def fullrepeat_setup_wide(rT_win, Jall_win, *, W, N_t, recipe):
    """The contract of fullrepeat_setup by the wide kernel, for the shapes
    without a tile plan.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (f64 windows raise: fullrepeat_setup_wide_f64 is
    theirs), or raise ValueError at a shape without a wide plan."""
    if rT_win.device.type == "cpu":
        return fullrepeat_setup_reference(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    return _launch_wide(fullrepeat_setup_wide, rT_win, Jall_win, W, N_t, recipe, torch.float32)


def fullrepeat_setup_wide_f64(rT_win, Jall_win, *, W, N_t, recipe):
    """fullrepeat_setup_wide in f64 (windows f64 -> agg, crosses f64): the
    wide kernel's f64 instantiation, every product summed in f64.  CPU
    tensors take the plain version."""
    if rT_win.device.type == "cpu":
        return fullrepeat_setup_reference(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    return _launch_wide(fullrepeat_setup_wide_f64, rT_win, Jall_win, W, N_t, recipe,
                        torch.float64)


def _launch_wide(fn, rT_win, Jall_win, W, N_t, recipe, dt):
    what = fn.__name__
    rc, Kall, dev = _checked(what, rT_win, Jall_win, W, N_t, dt)
    _recipe_rows(recipe, rc, Kall, W)
    plan = _wide_plan(recipe, W, Kall, rc, dt.itemsize)
    if plan is None:
        raise ValueError(f"{what}: no shared-memory plan for W={W}, rc={rc}, Kall={Kall} "
                         "(fullrepeat_route names the first body there)")
    agg, cross = _outputs(plan.F_agg, plan.cross_widths, N_t, dev, dt)
    chans = _cuda.recipe_tensor(plan.chans, dev)
    grid = max(1, min(plan.blocks_per_sm * _cuda.sm_count(dev), -(-N_t // plan.T)))
    launch = (_cuda.lib().thallo_fullrepeat_setup_wide_f64 if dt == torch.float64
              else _cuda.lib().thallo_fullrepeat_setup_wide)
    code = launch(rT_win.data_ptr(), Jall_win.data_ptr(), chans.data_ptr(), agg.data_ptr(),
                  cross.data_ptr(), len(plan.chans), rc, Kall, W, N_t, plan.T, plan.Wc,
                  plan.pitch, plan.stages, plan.threads, grid, _cuda.stream(rT_win))
    _cuda.check(code, what)
    fn.launches += 1
    return agg, _split(cross, plan.cross_widths)


def fullrepeat_setup_thread(rT_win, Jall_win, *, W, N_t, recipe):
    """The contract of fullrepeat_setup by the first body: one thread per
    element; any W, rc, Kall (routed only where the wide kernel has no
    plan).  CPU tensors take the plain version; CUDA tensors launch the
    kernel (f64 windows raise: fullrepeat_setup_thread_f64 is theirs)."""
    if rT_win.device.type == "cpu":
        return fullrepeat_setup_reference(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    return _launch_thread(fullrepeat_setup_thread, rT_win, Jall_win, W, N_t, recipe,
                          torch.float32)


def fullrepeat_setup_thread_f64(rT_win, Jall_win, *, W, N_t, recipe):
    """fullrepeat_setup_thread in f64 (windows f64 -> agg, crosses f64):
    the first body's f64 instantiation, every product summed in f64.  CPU
    tensors take the plain version."""
    if rT_win.device.type == "cpu":
        return fullrepeat_setup_reference(rT_win, Jall_win, W=W, N_t=N_t, recipe=recipe)
    return _launch_thread(fullrepeat_setup_thread_f64, rT_win, Jall_win, W, N_t, recipe,
                          torch.float64)


def _launch_thread(fn, rT_win, Jall_win, W, N_t, recipe, dt):
    what = fn.__name__
    rc, Kall, dev = _checked(what, rT_win, Jall_win, W, N_t, dt)
    rows, F_agg, cross_widths = _recipe_rows(recipe, rc, Kall, W)
    agg, cross = _outputs(F_agg, cross_widths, N_t, dev, dt)
    rec = _cuda.recipe_tensor(rows, dev)
    launch = (_cuda.lib().thallo_fullrepeat_setup_thread_f64 if dt == torch.float64
              else _cuda.lib().thallo_fullrepeat_setup_thread)
    code = launch(rT_win.data_ptr(), Jall_win.data_ptr(), rec.data_ptr(), agg.data_ptr(),
                  cross.data_ptr(), len(rows), rc, W, N_t, _cuda.stream(rT_win))
    _cuda.check(code, what)
    fn.launches += 1
    return agg, _split(cross, cross_widths)


for _fn in (fullrepeat_setup, fullrepeat_setup_f64, fullrepeat_setup_wide,
            fullrepeat_setup_wide_f64, fullrepeat_setup_thread, fullrepeat_setup_thread_f64):
    _fn.launches = 0
