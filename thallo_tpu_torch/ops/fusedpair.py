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
  entry.  Every other shape goes to the atomics route below.
* ``fused_pair_apply_atomics`` (same source, the slots kernel): any
  (Ci, Cj) up to ATOMICS_MAX_CI x 16, any S.  A thread loads the ids of
  its slots, then (for the 3 x 3 pair) all their blocks, then the pcol
  gathers, before any sum, and adds its Cj-vector z into cols[:, id]
  with global atomics; on a level of fewer than SLOT_SPREAD_MAX_N
  elements an element's W slots are spread over up to 8 slot lanes and
  its rows summed through shared memory.  ``fused_pair_apply_atomics_thread``
  (the first atomics body): one thread per n walks its w's one after
  another.  ``atomics_keeps_thread`` names the levels that keep the
  first body (fused_pair_route).
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
bf16 rounding of pcol or z: all arithmetic is f32 (f64 in the f64
instantiations below).  Atomics make the
cols sums' order vary from run to run.

**bf16 blocks** (the solver's ``block_dtype="bf16"``, JAX's bf16 block
storage): ``fused_pair_apply`` and ``fused_pair_apply_wloop`` take
``blocks_wm`` in f32 or bf16 and hand bf16 to ``fused_pair_apply_bf16``
and ``fused_pair_apply_wloop_bf16``, the bf16 instantiations of the two
persistent kernels (block values widened to f32 on load, every other
operand f32; the persistent one takes ``BF16_ELEMS`` neighbouring
elements per thread where N is even, read as one ``__nv_bfloat162``).
Shapes those do not take go to ``fused_pair_apply_atomics_bf16`` (the
slots kernel of ``csrc/fused_pair.cu`` on bf16 blocks: every load of an
element's slots issued before any sum, its slots spread over
``bf16_slot_lanes`` lanes where one thread per element leaves the card
idle; Ci up to ``ATOMICS_MAX_CI``).  The first bf16 body,
``fused_pair_bf16_atomics`` (``csrc/fused_pair_variants.cu`` mode 0, one
thread per element walking its slots, cols by global atomics;
instantiated per (Ci, Cj) bound as the f32 atomics body, so it takes Ci
up to ``ATOMICS_MAX_CI`` too), is on no route: the slots kernel measured
faster at every shape the route reaches (H100 device ms, slots / first
bf16 body, ``chip_smoke.py`` phase 2 in one call: ARAP 256²'s (3, 3)
levels 0.0072-0.0077 / 0.0084-0.0085 grouped, 0.0071-0.0093 /
0.0085-0.0100 shuffled; W = 12, N = S = 16 384 at (9, 3) 0.0192 / 0.0415
and (16, 3) 0.0211 / 0.0711; embedded deformation's [4, 1 600] (3, 3)
0.0051 / 0.0069 and (9, 3) 0.0061 / 0.0140).  ``fused_pair_route(...,
bf16=True)`` names the bf16 kernel of a level.

**f64** (the solver's ``double_precision``: blocks, pcol and prow f64):
``fused_pair_apply_f64`` and ``fused_pair_apply_wloop_f64``, the f64
instantiations of the two persistent kernels (the [9, S] f64 accumulator,
72 KB at S = 1024, in opted-in dynamic shared memory), and
``fused_pair_apply_atomics_f64`` and
``fused_pair_apply_atomics_thread_f64``, those of the two atomics bodies
(``csrc/fused_pair.cu``, ``csrc/fused_pair_wloop.cu``, every sum f64).
``fused_pair_route(..., dtype=torch.float64)`` is the one place that picks
between them: the f32 route's persistent kernel, by the same shape rule,
where the f64 accumulator fits ``PERSISTENT_MAX_SMEM``; an f64 atomics
body for every other f64 level.  **bf16 blocks with f64 values**
(``block_dtype="bf16"`` under ``double_precision``):
``fused_pair_apply_bf16_f64`` and ``fused_pair_apply_atomics_bf16_f64``,
the <bf16, double> instantiations of the persistent pair (one element a
thread) and the slots kernel, and ``fused_pair_apply_wloop_bf16_f64``, the
w-lane W-loop kernel redesigned for it (``csrc/fused_pair_wloop.cu``
``wloop_lanes_kernel``: an item of 16 elements x all W w's spread over the
warp's w-lanes stores its rows, one 512-thread block an SM;
``wloop_lanes_plan``), each block value widened exactly to a double.  The
W-loop kernel's <bf16, double> instantiation, the first body it replaced,
stays as ``fused_pair_apply_wloop_bf16_f64_gathered``, on no route
(``chip_smoke.py`` times it beside the w-lane kernel).  Only the
``_f64`` wrappers take f64 values: the f32 and bf16 wrappers, the first
W-loop body, the first bf16 body and the measurement scripts' kernels
raise NotImplementedError on an f64 tensor (``_cuda.F64_TODO``).

The measurement scripts' kernels (``scripts/tpu_fused_pair_micro.py``,
``scripts/tpu_fused_variants.py``) are the same pair on bf16 blocks:
``fused_pair_bf16`` (the micro's pair: the bf16 persistent kernel, counted
on its own); ``fused_pair_v1_rows`` (make_v1, rows only: for 3 x 9 the
rows kernel of ``csrc/fused_pair_rows.cu``, two elements a thread with
the block rows streamed by ``__ldcs``; other pairs take its
first body, ``fused_pair_v1_rows_generic``, ``csrc/fused_pair_variants.cu``
mode 1, one thread per element);
``fused_pair_v2_smem`` (make_v2: one cols accumulator carried across the
grid) and ``fused_pair_v3_partials`` (make_v3: cols partials summed
outside the kernel).  For the pairs the persistent kernels take, v2 and
v3 launch the cluster kernel (``csrc/fused_pair_cluster.cu``): the bf16
persistent body, launched as clusters of ``CLUSTER_SIZE`` blocks whose
shared accumulators are summed through distributed shared memory, then
added to cols by one global atomic per nonzero entry per cluster (v2) or
stored as one slab per cluster and summed by ``torch.sum`` (v3)
(``variant_route``; ``cluster_plan`` sizes the grid).  Other shapes take
their first bodies, ``fused_pair_v2_smem_generic`` and
``fused_pair_v3_partials_generic`` (``csrc/fused_pair_variants.cu``,
modes 2 and 3: a shared accumulator per block, flushed by global atomics
or as [G, Cj, S] slabs).  ``fused_pair_cluster_noflush`` runs the cluster
kernel without its last step (nothing leaves the cluster): a
measurement, no route.  The plain version of every kernel here is
``fused_pair_apply_reference``, which reads bf16 blocks as f32.
``scripts/torch_fused_pair_micro.py`` and
``scripts/torch_fused_variants.py`` time the scripts' kernels; no solver
path runs them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

MAX_CI, MAX_CJ = 8, 16  # csrc/fused_pair*.cu register-array bounds
# the atomics body's row slots (csrc/fused_pair.cu kAtomicsMaxCi): up to
# a 9-channel rotation matrix (embedded_mesh_deformation)
ATOMICS_MAX_CI = 16
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
# bf16 blocks: neighbouring elements per thread of the persistent kernel
# where N is even (odd N: 1); 2 reads one __nv_bfloat162 per block row, 4
# bytes a lane (H100 sweep, scripts/torch_redesign_sweep.py --only bf16:
# 9% ahead of 1 at (4, 250000), 5% at (2, 250000); the W-loop kernel keeps
# one element a lane, csrc/fused_pair_wloop.cu)
BF16_ELEMS = 2


def bf16_elems(N: int) -> int:
    """Elements per thread of the bf16 persistent kernels at N elements:
    BF16_ELEMS where N is even (a bf16 pair starts 4-byte aligned in every
    block plane), else 1."""
    return BF16_ELEMS if N % 2 == 0 else 1


def fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Plain torch version, in pcol's dtype (f32 or f64; bf16 blocks are
    read at that dtype): the CPU path and the card-side oracle of every
    kernel here."""
    W, N = ids2d.shape
    dt = pcol.dtype
    B = blocks_wm.reshape(W, Ci, Cj, N).to(dt)
    ok = (ids2d >= 0) & (ids2d < S)
    idx = torch.where(ok, ids2d, torch.zeros_like(ids2d)).long()
    pc = pcol[:, idx] * ok  # [Cj, W, N]
    rows = (B * pc.permute(1, 0, 2)[:, None]).sum(dim=(0, 2))  # [Ci, N]
    z = (B * prow.to(dt)[None, :, None, :]).sum(dim=1) * ok[:, None]  # [W, Cj, N]
    cols = torch.zeros((Cj, S), dtype=dt, device=pcol.device)
    cols.index_add_(1, idx.reshape(-1), z.permute(1, 0, 2).reshape(Cj, W * N))
    return rows, cols


def _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, block_dtype, max_ci=MAX_CI,
             value_dtype=torch.float32):
    """Validate a CUDA launch's operands; returns (W, N, blocks [W*Ci*Cj, N])."""
    if ids2d.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ids2d.device}")
    if not (1 <= Ci <= max_ci and 1 <= Cj <= MAX_CJ and S >= 1):
        raise ValueError(f"{what}: Ci={Ci}, Cj={Cj}, S={S} outside "
                         f"[1, {max_ci}] x [1, {MAX_CJ}] x [1, inf)")
    W, N = ids2d.shape
    dev = ids2d.device
    blocks = blocks_wm.reshape(W * Ci * Cj, N)
    _cuda.require(ids2d, "ids2d", (W, N), torch.int32, dev)
    _cuda.require(blocks, "blocks_wm", (W * Ci * Cj, N), block_dtype, dev)
    _cuda.require(pcol, "pcol", (Cj, S), value_dtype, dev)
    _cuda.require(prow, "prow", (Ci, N), value_dtype, dev)
    return W, N, blocks


def persistent_fits(Ci: int, Cj: int, S: int, itemsize: int = 4) -> bool:
    """A pair the persistent kernels are specialised for, with its [Cj, S]
    accumulator (itemsize bytes a value: 4, or 8 in f64) within their
    shared-memory limit."""
    return (Ci, Cj) in PERSISTENT_PAIRS and Cj * S * itemsize <= PERSISTENT_MAX_SMEM


# a level's f32 route -> its kernel on bf16 blocks (every other route:
# fused_pair_bf16_atomics)
BF16_ROUTES = {"fused_pair_apply": "fused_pair_apply_bf16",
               "fused_pair_apply_wloop": "fused_pair_apply_wloop_bf16"}


# the slots kernel spreads a level's W slots over lanes below this many
# elements (csrc/fused_pair.cu kSlotSpreadMaxN)
SLOT_SPREAD_MAX_N = 4096
# on bf16 blocks the caller picks the slot lanes (bf16_slot_lanes): a level
# spreads its slots while its threads stay below this many per SM (H100
# graph ms at P = 1 / 2 / 4 / 8, scripts/torch_redesign_sweep.py --only
# bf16_slots: ARAP 256²'s [4, 65 536] 0.0070 / 0.0099 / 0.0151 / 0.0245; W
# = 12, N = 16 384 at (9, 3) 0.0219 / 0.0187 / 0.0199 / 0.0219, at (16, 3)
# 0.0251 / 0.0205 / 0.0209 / 0.0271; [4, 1 600] (9, 3) 0.0095 / 0.0069 /
# 0.0068 / 0.0076: the rule picks the fastest at each, within 2%)
BF16_SLOT_FILL = 128


def bf16_slot_lanes(W: int, N: int, sms: int) -> int:
    """Slot lanes P of the bf16 slots kernel at a level of W x N elements
    on `sms` SMs: doubled from 1 while P * 2 <= min(W, 8) and the level's
    N * P threads stay below BF16_SLOT_FILL a SM, so a short level fills
    the card and a long one keeps a thread per element."""
    P = 1
    while P * 2 <= min(W, 8) and N * P < BF16_SLOT_FILL * sms:
        P *= 2
    return P


def atomics_keeps_thread(W: int, N_t: int, Ci: int, Cj: int, f64: bool = False) -> bool:
    """Whether a level of the atomics route keeps the first atomics body
    (fused_pair_apply_atomics_thread[_f64]) over the slots kernel: every
    level of SLOT_SPREAD_MAX_N elements or more but the f32 3 x 3 pair.
    H100 graph ms with the zeroed cols (slots / first body;
    scripts/torch_redesign_sweep.py --only slots; PERF.md, Findings):
    ARAP 256²'s 3 x 3 [4, 65 536] 0.0077-0.0109 / 0.0117-0.0126 in f32
    and 0.0115-0.0132 / 0.0105-0.0132 in f64; [4, 250 000] 3 x 9 into 4000
    0.1949 / 0.1655; [3, 5000] 16 x 16 0.1693 / 0.0579; the short levels,
    bundle_fusion's [8, 700] 6 x 6 0.0159 / 0.0429 and [4, 1600] 9 x 3
    0.0137 / 0.0162, in f64 alike.  bf16 levels keep no first body (the
    module docstring)."""
    spread = N_t < SLOT_SPREAD_MAX_N and W >= 2
    return not spread and (f64 or (Ci, Cj) != (3, 3))


def fused_pair_route(W: int, N_t: int, Ci: int, Cj: int, S: int, bf16: bool = False,
                     dtype: torch.dtype = torch.float32) -> str:
    """The kernel a level of W x N_t elements takes on the card, by the
    name of its wrapper: "fused_pair_apply" (persistent) or
    "fused_pair_apply_wloop" for the specialised pairs, by the level's
    shape; "fused_pair_apply_wloop_chunked" for other wide levels whose
    S fits the chunked kernel's accumulator and whose Ci its register
    arrays take (MAX_CI); else "fused_pair_apply_atomics" (the slots
    kernel), or "fused_pair_apply_atomics_thread" (the first atomics body)
    where atomics_keeps_thread names the level.  bf16: the
    level's kernel on bf16 blocks (BF16_ROUTES, else
    "fused_pair_apply_atomics_bf16", the slots kernel, which takes Ci up to
    ATOMICS_MAX_CI).
    dtype float64 (the values' dtype): where the [9, S] f64 accumulator
    fits (persistent_fits at 8 bytes) the level takes the f32 route's
    persistent kernel by the same shape rule, "fused_pair_apply_f64" or
    "fused_pair_apply_wloop_f64"; else "fused_pair_apply_atomics_f64" (Ci up
    to ATOMICS_MAX_CI), or "fused_pair_apply_atomics_thread_f64" where
    atomics_keeps_thread names the level.  bf16 blocks with f64 values:
    "fused_pair_apply_bf16_f64" or "fused_pair_apply_wloop_bf16_f64" (the
    w-lane kernel) where the f64 accumulator fits, else
    "fused_pair_apply_atomics_bf16_f64"."""
    wide = W >= WLOOP_MIN_W
    persistent = not wide and N_t >= PERSISTENT_MIN_N
    if dtype == torch.float64:
        if persistent_fits(Ci, Cj, S, 8):
            route = "fused_pair_apply" if persistent else "fused_pair_apply_wloop"
            return route + ("_bf16_f64" if bf16 else "_f64")
        if bf16:
            return "fused_pair_apply_atomics_bf16_f64"
        thread = atomics_keeps_thread(W, N_t, Ci, Cj, f64=True)
        return "fused_pair_apply_atomics_thread_f64" if thread else "fused_pair_apply_atomics_f64"
    if persistent_fits(Ci, Cj, S):
        route = "fused_pair_apply" if persistent else "fused_pair_apply_wloop"
    elif wide and Ci <= MAX_CI and S * 4 <= _cuda.MAX_DYNAMIC_SMEM:
        route = "fused_pair_apply_wloop_chunked"
    elif not bf16 and atomics_keeps_thread(W, N_t, Ci, Cj):
        route = "fused_pair_apply_atomics_thread"
    else:
        route = "fused_pair_apply_atomics"
    return BF16_ROUTES.get(route, "fused_pair_apply_atomics_bf16") if bf16 else route


def _launch_persistent(fn, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, with_cols,
                       block_dtype=torch.float32, value_dtype=None):
    what = fn.__name__
    vdt = value_dtype or (torch.float64 if block_dtype == torch.float64 else torch.float32)
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, block_dtype,
                            value_dtype=vdt)
    itemsize = torch.finfo(vdt).bits // 8
    if not persistent_fits(Ci, Cj, S, itemsize):
        raise ValueError(f"{what}: no persistent kernel for Ci={Ci}, Cj={Cj}, S={S}")
    dev = ids2d.device
    rows = torch.empty((Ci, N), dtype=vdt, device=dev)
    cols = torch.zeros((Cj, S), dtype=vdt, device=dev) if with_cols else None
    # blocks resident on an SM: BLOCKS_PER_SM, fewer where the accumulator
    # leaves no room for as many
    per_sm = _cuda.blocks_per_sm(Cj * S * itemsize if with_cols else 0, BLOCKS_PER_SM)
    args = (ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
            rows.data_ptr(), cols.data_ptr() if with_cols else None, W, N, Ci, Cj, S, THREADS,
            per_sm * _cuda.sm_count(dev), MERGE_MIN)
    if block_dtype == torch.bfloat16 and vdt == torch.float64:
        code = _cuda.lib().thallo_fused_pair_persistent_bf16_f64(*args, _cuda.stream(ids2d))
    elif block_dtype == torch.bfloat16:
        code = _cuda.lib().thallo_fused_pair_persistent_bf16(*args, bf16_elems(N),
                                                             _cuda.stream(ids2d))
    elif block_dtype == torch.float64:
        code = _cuda.lib().thallo_fused_pair_persistent_f64(*args, _cuda.stream(ids2d))
    else:
        code = _cuda.lib().thallo_fused_pair_persistent(*args, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
    return rows, cols


def fused_pair_apply(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """ids2d [W, N] int32; blocks_wm [W*Ci*Cj, N] (or [W, Ci*Cj, N]) f32 or
    bf16; pcol [Cj, S] f32; prow [Ci, N] f32 -> (rows [Ci, N], cols [Cj, S])
    f32 (any W; the solver sends the levels fused_pair_route names it for).
    CPU tensors take the plain version; CUDA tensors with bf16 blocks go to
    fused_pair_apply_bf16; with f32 blocks they launch the f32 persistent
    kernel, or, for a pair it is not specialised for or an accumulator
    beyond its shared memory, go to the atomics body atomics_keeps_thread
    picks (f64 operands raise: fused_pair_route names their kernel)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if blocks_wm.dtype == torch.bfloat16:
        return fused_pair_apply_bf16(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if not persistent_fits(Ci, Cj, S):
        W, N = ids2d.shape
        body = fused_pair_apply_atomics_thread if atomics_keeps_thread(W, N, Ci, Cj) \
            else fused_pair_apply_atomics
        return body(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_persistent(fused_pair_apply, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, True)


def fused_pair_apply_bf16(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply on bf16 blocks: the bf16 instantiation of the
    persistent kernel (csrc/fused_pair.cu), or, for a pair it is not
    specialised for or an accumulator beyond its shared memory,
    fused_pair_apply_atomics_bf16.  CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if not persistent_fits(Ci, Cj, S):
        return fused_pair_apply_atomics_bf16(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_persistent(fused_pair_apply_bf16, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                              True, torch.bfloat16)


def fused_pair_apply_f64(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply in f64 (blocks, pcol, prow f64 -> rows, cols
    f64): the f64 instantiation of the persistent kernel
    (csrc/fused_pair.cu); a pair it is not specialised for, or an f64
    accumulator beyond its shared memory, raises ValueError
    (fused_pair_route sends those levels to fused_pair_apply_atomics_f64).
    CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_persistent(fused_pair_apply_f64, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                              True, torch.float64)


def fused_pair_apply_bf16_f64(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply on bf16 blocks with f64 values (pcol, prow -> rows,
    cols f64; block_dtype="bf16" under double_precision): the persistent
    kernel's <bf16, double> instantiation, one element a thread, each block
    value widened exactly to a double.  A pair it is not specialised for,
    or an f64 accumulator beyond its shared memory, raises ValueError
    (fused_pair_route sends those levels to
    fused_pair_apply_atomics_bf16_f64).  CPU tensors take the plain
    version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_persistent(fused_pair_apply_bf16_f64, ids2d, blocks_wm, pcol, prow, Ci, Cj,
                              S, True, torch.bfloat16, torch.float64)


def fused_pair_rows_floor(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """rows [Ci, N] alone, by the persistent kernel (f32 or bf16 blocks)
    with its cols side compiled out (a measurement; the persistent route's
    shapes only)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)[0]
    bf16 = blocks_wm.dtype == torch.bfloat16
    return _launch_persistent(fused_pair_rows_floor, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                              False, torch.bfloat16 if bf16 else torch.float32)[0]


def fused_pair_apply_atomics(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The contract of fused_pair_apply for any Ci <= ATOMICS_MAX_CI, Cj <=
    16 and S, by the slots kernel: an element's W slots spread over slot
    lanes, rows summed per element in shared memory, one global atomic per
    cols value (equal ids of a warp merged first).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (f64 operands raise:
    fused_pair_apply_atomics_f64 is theirs)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_atomics(fused_pair_apply_atomics, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                           torch.float32, slots=True)


def fused_pair_apply_atomics_f64(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply_atomics in f64: the f64 instantiation of the slots
    kernel (every operand but ids f64, atomicAdd on doubles).  CPU tensors
    take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_atomics(fused_pair_apply_atomics_f64, ids2d, blocks_wm, pcol, prow, Ci, Cj,
                           S, torch.float64, slots=True)


def fused_pair_apply_atomics_bf16(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply_atomics on bf16 blocks (pcol, prow, rows and cols
    f32): the slots kernel's bf16 instantiation, each block value widened
    on load, its slots on bf16_slot_lanes lanes; any Ci <= ATOMICS_MAX_CI,
    Cj <= 16 and S.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_atomics(fused_pair_apply_atomics_bf16, ids2d, blocks_wm, pcol, prow, Ci, Cj,
                           S, torch.bfloat16, slots=True)


def fused_pair_apply_atomics_bf16_f64(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply_atomics_bf16 with f64 values (pcol, prow, rows and
    cols f64; block_dtype="bf16" under double_precision): the slots
    kernel's <bf16, double> instantiation, each block value widened exactly
    to a double, its slots on bf16_slot_lanes lanes; any Ci <=
    ATOMICS_MAX_CI, Cj <= 16 and S.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_atomics(fused_pair_apply_atomics_bf16_f64, ids2d, blocks_wm, pcol, prow, Ci,
                           Cj, S, torch.bfloat16, slots=True, value_dtype=torch.float64)


def fused_pair_apply_atomics_thread(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The first atomics body: one thread per element walks its W slots,
    one global atomic per cols value; the same contract and shapes as
    fused_pair_apply_atomics, kept where fused_pair_route names it.  CPU
    tensors take the plain version (f64 operands raise:
    fused_pair_apply_atomics_thread_f64 is theirs)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_atomics(fused_pair_apply_atomics_thread, ids2d, blocks_wm, pcol, prow, Ci,
                           Cj, S, torch.float32, slots=False)


def fused_pair_apply_atomics_thread_f64(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply_atomics_thread in f64 (the first body's f64
    instantiation).  CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_atomics(fused_pair_apply_atomics_thread_f64, ids2d, blocks_wm, pcol, prow, Ci,
                           Cj, S, torch.float64, slots=False)


def _launch_atomics(fn, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, block_dtype, slots, P=None,
                    value_dtype=None):
    what = fn.__name__
    dt = value_dtype or (torch.float32 if block_dtype == torch.bfloat16 else block_dtype)
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, block_dtype,
                            ATOMICS_MAX_CI, value_dtype=dt)
    rows = torch.empty((Ci, N), dtype=dt, device=ids2d.device)
    cols = torch.zeros((Cj, S), dtype=dt, device=ids2d.device)
    lib, f64 = _cuda.lib(), dt == torch.float64
    args = (ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), W, N, Ci, Cj, S)
    if block_dtype == torch.bfloat16:
        lanes = P or bf16_slot_lanes(W, N, _cuda.sm_count(ids2d.device))
        launch = lib.thallo_fused_pair_atomics_slots_bf16_f64 if f64 else \
            lib.thallo_fused_pair_atomics_slots_bf16
        code = launch(*args, lanes, _cuda.stream(ids2d))
    elif slots:
        launch = lib.thallo_fused_pair_atomics_slots_f64 if f64 else \
            lib.thallo_fused_pair_atomics_slots
        code = launch(*args, _cuda.stream(ids2d))
    else:
        launch = lib.thallo_fused_pair_atomics_f64 if f64 else lib.thallo_fused_pair_atomics
        code = launch(*args, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
    return rows, cols


for _fn in (fused_pair_apply, fused_pair_apply_bf16, fused_pair_apply_f64,
            fused_pair_apply_bf16_f64, fused_pair_rows_floor, fused_pair_apply_atomics,
            fused_pair_apply_atomics_f64, fused_pair_apply_atomics_bf16,
            fused_pair_apply_atomics_bf16_f64, fused_pair_apply_atomics_thread,
            fused_pair_apply_atomics_thread_f64):
    _fn.launches = 0


def wloop_plan(W: int, N: int, S: int, sms: int, itemsize: int = 4):
    """(w_item, grid) of the persistent W-loop kernel: items of a 32-element
    tile and w_item w's, about one per warp of the grid, at least
    WLOOP_MIN_ITEM w's each, W split evenly (an item that covers its
    elements' whole level stores their rows); grid: WLOOP_BLOCKS_PER_SM
    blocks per SM (fewer where the [9, S] accumulator, itemsize bytes a
    value, leaves no room), no more than the items fill."""
    warps = WLOOP_THREADS // 32
    tiles = -(-N // 32)
    blocks = _cuda.blocks_per_sm(9 * S * itemsize, WLOOP_BLOCKS_PER_SM) * sms
    target = max(1, WLOOP_MIN_ITEM, -(-(W * tiles) // (blocks * warps)))
    w_item = max(1, -(-W // max(1, -(-W // target))))
    items = tiles * -(-W // w_item)
    return w_item, max(1, min(blocks, -(-items // warps)))


# the persistent W-loop kernel's export by (block dtype, value dtype)
_WLOOP_EXPORTS = {
    (torch.float32, torch.float32): "thallo_fused_pair_wloop_persistent",
    (torch.bfloat16, torch.float32): "thallo_fused_pair_wloop_persistent_bf16",
    (torch.float64, torch.float64): "thallo_fused_pair_wloop_persistent_f64",
    (torch.bfloat16, torch.float64): "thallo_fused_pair_wloop_persistent_bf16_f64"}


def _launch_wloop(fn, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, block_dtype,
                  value_dtype=torch.float32):
    what = fn.__name__
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, block_dtype,
                            value_dtype=value_dtype)
    itemsize = torch.finfo(value_dtype).bits // 8
    if not persistent_fits(Ci, Cj, S, itemsize):
        raise ValueError(f"{what}: no persistent W-loop kernel for Ci={Ci}, Cj={Cj}, S={S}")
    dev = ids2d.device
    w_item, grid = wloop_plan(W, N, S, _cuda.sm_count(dev), itemsize)
    rows = (torch.empty if w_item >= W else torch.zeros)((Ci, N), dtype=value_dtype, device=dev)
    cols = torch.zeros((Cj, S), dtype=value_dtype, device=dev)
    args = (ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), W, N, Ci, Cj, S, WLOOP_THREADS, grid, w_item,
            MERGE_MIN)
    launch = getattr(_cuda.lib(), _WLOOP_EXPORTS[block_dtype, value_dtype])
    code = launch(*args, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
    return rows, cols


def fused_pair_apply_wloop(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The same contract as fused_pair_apply, for wide levels: a persistent
    kernel over (element tile, w-range) items, a warp per item (3 x 9 with
    a [9, S] accumulator within PERSISTENT_MAX_SMEM; every other shape goes
    to fused_pair_apply_wloop_chunked).  CPU tensors take the plain
    version; CUDA tensors with bf16 blocks go to fused_pair_apply_wloop_bf16,
    with f32 blocks they launch a kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if blocks_wm.dtype == torch.bfloat16:
        return fused_pair_apply_wloop_bf16(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if not persistent_fits(Ci, Cj, S):
        return fused_pair_apply_wloop_chunked(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_wloop(fused_pair_apply_wloop, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                         torch.float32)


def fused_pair_apply_wloop_bf16(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply_wloop on bf16 blocks: the bf16 instantiation of the
    persistent W-loop kernel (csrc/fused_pair_wloop.cu), or, for a pair it
    is not specialised for or an accumulator beyond its shared memory,
    fused_pair_apply_atomics_bf16.  CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if not persistent_fits(Ci, Cj, S):
        return fused_pair_apply_atomics_bf16(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_wloop(fused_pair_apply_wloop_bf16, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                         torch.bfloat16)


def fused_pair_apply_wloop_f64(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply_wloop in f64 (blocks, pcol, prow -> rows, cols f64):
    the persistent W-loop kernel's f64 instantiation, its [9, S] f64
    accumulator in opted-in dynamic shared memory (72 KB at S = 1024); a
    pair it is not specialised for, or an accumulator beyond
    PERSISTENT_MAX_SMEM, raises ValueError (fused_pair_route sends those
    levels to an f64 atomics body).  CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_wloop(fused_pair_apply_wloop_f64, ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                         torch.float64, torch.float64)


def fused_pair_apply_wloop_bf16_f64(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply_wloop on bf16 blocks with f64 values
    (block_dtype="bf16" under double_precision): the w-lane W-loop kernel
    (items of wloop_lanes_plan: an element's w's spread over w-lanes of
    one warp, so an item covers its elements' whole level and stores their
    rows; one 512-thread block an SM), each block value widened exactly to
    a double.  A pair it is not specialised for, or an f64 accumulator
    beyond PERSISTENT_MAX_SMEM, raises ValueError: fused_pair_route sends
    those levels elsewhere.  CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_wloop_lanes(fused_pair_apply_wloop_bf16_f64, ids2d, blocks_wm, pcol, prow,
                               Ci, Cj, S)


def fused_pair_apply_wloop_bf16_f64_gathered(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The first <bf16, double> W-loop body, which the w-lane kernel
    replaced (a measurement, on no route): the persistent W-loop kernel's
    <bf16, double> instantiation (wloop_plan's items, two blocks an SM),
    each block value widened exactly to a double.  A pair it is not
    specialised for, or an accumulator beyond PERSISTENT_MAX_SMEM, raises
    ValueError.  CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_wloop(fused_pair_apply_wloop_bf16_f64_gathered, ids2d, blocks_wm, pcol, prow,
                         Ci, Cj, S, torch.bfloat16, torch.float64)


# the w-lane W-loop kernel (csrc/fused_pair_wloop.cu wloop_lanes_kernel,
# <bf16, double>): threads a block (one block an SM: up to 128 registers a
# thread, csrc kLanesThreads), the elements an item may take (a bf16 warp
# load of 16 elements fills a 32-byte sector)
WLOOP_LANES_THREADS = 512
WLOOP_LANES_ELEMS = (32, 16)


@functools.lru_cache(maxsize=256)
def wloop_lanes_plan(W: int, N: int, sms: int):
    """(elems, w_item, grid) of the w-lane W-loop kernel: items of `elems`
    elements (32 / elems w-lanes an element) and w_item w's; one block an
    SM.  The pick minimises the steps of the busiest warp,
    ceil(items / warps) x ceil(w_item / w-lanes); among equals it prefers
    items that cover their elements' whole level (rows stored, not added),
    then more elements an item, then fewer items."""
    grid = max(1, sms)
    warps = grid * (WLOOP_LANES_THREADS // 32)
    best = None
    for elems in WLOOP_LANES_ELEMS:
        lanes = 32 // elems
        tiles = -(-N // elems)
        for k in range(1, W + 1):
            w_item = -(-W // k)
            if k > 1 and w_item == -(-W // (k - 1)):
                continue
            if w_item < min(W, WLOOP_MIN_ITEM):
                break
            items = tiles * -(-W // w_item)
            steps = -(-items // warps) * -(-w_item // lanes)
            key = (steps, w_item < W, -elems, items)
            if best is None or key < best[0]:
                best = (key, elems, w_item)
    if best is None:  # W == 0
        return WLOOP_LANES_ELEMS[0], 1, grid
    return best[1], best[2], grid


def fused_pair_apply_wloop_lanes_planned(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S, sms):
    """What the w-lane W-loop kernel computes, from its plan alone, in plain
    torch at pcol's dtype: each item's rows summed over its w-lanes' w's
    (w-lane h takes w0 + h, w0 + h + lanes, ...) and added over the item's
    w-chunks, cols summed by id (wloop_lanes_plan at `sms` SMs)."""
    W, N = ids2d.shape
    dt = pcol.dtype
    elems, w_item, _ = wloop_lanes_plan(W, N, sms)
    lanes = 32 // elems
    B = blocks_wm.reshape(W, Ci, Cj, N).to(dt)
    ok = (ids2d >= 0) & (ids2d < S)
    idx = torch.where(ok, ids2d, torch.zeros_like(ids2d)).long()
    pc = (pcol[:, idx] * ok).permute(1, 0, 2)  # [W, Cj, N]
    per_w = (B * pc[:, None]).sum(dim=2)  # [W, Ci, N]
    rows = torch.zeros((Ci, N), dtype=dt, device=pcol.device)
    for w0 in range(0, W, w_item):
        w1 = min(W, w0 + w_item)
        lane_sums = [per_w[w0 + h:w1:lanes].sum(dim=0) for h in range(min(lanes, w1 - w0))]
        rows += sum(lane_sums[1:], lane_sums[0])
    z = (B * prow.to(dt)[None, :, None, :]).sum(dim=1) * ok[:, None]  # [W, Cj, N]
    cols = torch.zeros((Cj, S), dtype=dt, device=pcol.device)
    cols.index_add_(1, idx.reshape(-1), z.permute(1, 0, 2).reshape(Cj, W * N))
    return rows, cols


def _launch_wloop_lanes(fn, ids2d, blocks_wm, pcol, prow, Ci, Cj, S):
    what = fn.__name__
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, torch.bfloat16,
                            value_dtype=torch.float64)
    if not persistent_fits(Ci, Cj, S, 8):
        raise ValueError(f"{what}: no w-lane W-loop kernel for Ci={Ci}, Cj={Cj}, S={S}")
    dev = ids2d.device
    elems, w_item, grid = wloop_lanes_plan(W, N, _cuda.sm_count(dev))
    rows = (torch.empty if w_item >= W > 0 else torch.zeros)((Ci, N), dtype=torch.float64,
                                                             device=dev)
    cols = torch.zeros((Cj, S), dtype=torch.float64, device=dev)
    code = _cuda.lib().thallo_fused_pair_wloop_lanes_bf16_f64(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), W, N, Ci, Cj, S, grid, elems, w_item, MERGE_MIN, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
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


for _fn in (fused_pair_apply_wloop, fused_pair_apply_wloop_bf16, fused_pair_apply_wloop_f64,
            fused_pair_apply_wloop_bf16_f64, fused_pair_apply_wloop_bf16_f64_gathered,
            fused_pair_apply_wloop_chunked):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# bf16 blocks: the first bf16 body and the measurement scripts' kernels
# ---------------------------------------------------------------------------
_ATOMICS, _ROWS_ONLY, _SMEM, _PARTIALS = range(4)  # csrc/fused_pair_variants.cu kMode


def _bf16_launch(fn, mode, ids2d, blocks_wm, pcol, prow, Ci, Cj, S):
    what = fn.__name__
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, torch.bfloat16,
                            ATOMICS_MAX_CI if mode == _ATOMICS else MAX_CI)
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


def fused_pair_bf16_atomics(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """fused_pair_apply on bf16 blocks by one thread per element and one
    global atomic per cols value (the first bf16 body): any
    Ci <= ATOMICS_MAX_CI, Cj <= 16 and S; the shapes the bf16 persistent
    kernels do not take.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _bf16_launch(fused_pair_bf16_atomics, _ATOMICS, ids2d, blocks_wm, pcol, prow, Ci, Cj, S)


def fused_pair_bf16(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """The micro script's pair (scripts/tpu_fused_pair_micro.py) on bf16
    blocks -> (rows, cols): the bf16 persistent kernel, as
    fused_pair_apply_bf16 launches it but counted here, or, for a shape it
    does not take, fused_pair_apply_atomics_bf16.  CPU tensors take the
    plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if not persistent_fits(Ci, Cj, S):
        return fused_pair_apply_atomics_bf16(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_persistent(fused_pair_bf16, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, True,
                              torch.bfloat16)


# the rows kernel of make_v1 (csrc/fused_pair_rows.cu): threads a block and
# blocks per SM of a persistent grid (0: one tile a block).  The kernel
# takes two elements a thread (one where N is odd), pcol through the
# read-only cache and the block rows by __ldcs: the fastest of the forms
# tried (PERF.md, PR 9's findings), at 1024 threads x 1 block per SM
# (scripts/torch_redesign_sweep.py --only v1 --sweep)
V1_THREADS = 1024
V1_BLOCKS_PER_SM = 1


def v1_elems(N: int) -> int:
    """Elements a thread of the rows kernel at N elements: two where N is
    even (every block plane then starts 4-byte aligned), else one."""
    return 2 if N % 2 == 0 else 1


def fused_pair_v1_rows(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v1 (make_v1: rows only) -> rows [Ci, N]: the rows kernel
    (csrc/fused_pair_rows.cu) for the 3 x 9 pair, any S; other pairs go
    to fused_pair_v1_rows_generic (variant_route).  CPU tensors take the
    plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)[0]
    if variant_route("fused_pair_v1_rows", Ci, Cj, S) != "fused_pair_v1_rows":
        return fused_pair_v1_rows_generic(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    W, N, blocks = _checked("fused_pair_v1_rows", ids2d, blocks_wm, pcol, prow, Ci, Cj, S,
                            torch.bfloat16)
    dev = ids2d.device
    elems = v1_elems(N)
    tiles = -(-N // (V1_THREADS * elems))
    grid = V1_BLOCKS_PER_SM * _cuda.sm_count(dev) if V1_BLOCKS_PER_SM else tiles
    rows = torch.empty((Ci, N), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_fused_pair_rows(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), rows.data_ptr(), W, N, Ci, Cj, S,
        V1_THREADS, max(1, grid), elems, _cuda.stream(ids2d))
    _cuda.check(code, "fused_pair_v1_rows")
    fused_pair_v1_rows.launches += 1
    return rows


def fused_pair_v1_rows_generic(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v1's first body: one thread per element, any Ci <= 8,
    Cj <= 16 and S -> rows [Ci, N].  CPU tensors take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)[0]
    return _bf16_launch(fused_pair_v1_rows_generic, _ROWS_ONLY, ids2d, blocks_wm, pcol, prow,
                        Ci, Cj, S)[0]


def fused_pair_v2_smem_generic(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v2's first body: cols summed in a shared [Cj, S]
    accumulator per block of about two per SM, one global atomic per
    nonzero entry per block -> (rows, cols); any Ci <= 8, Cj <= 16 whose
    accumulator fits _cuda.MAX_DYNAMIC_SMEM."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _bf16_launch(fused_pair_v2_smem_generic, _SMEM, ids2d, blocks_wm, pcol, prow, Ci, Cj,
                        S)


def fused_pair_v3_partials_generic(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v3's first body: per-block cols slabs [G, Cj, S] written
    without atomics and summed outside the kernel -> (rows, cols); the
    shapes of fused_pair_v2_smem_generic."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _bf16_launch(fused_pair_v3_partials_generic, _PARTIALS, ids2d, blocks_wm, pcol, prow,
                        Ci, Cj, S)


for _fn in (fused_pair_bf16_atomics, fused_pair_bf16, fused_pair_v1_rows,
            fused_pair_v1_rows_generic, fused_pair_v2_smem_generic,
            fused_pair_v3_partials_generic):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the cluster kernel of variants v2 and v3 (csrc/fused_pair_cluster.cu)
# ---------------------------------------------------------------------------
_NO_FLUSH, _FLUSH_ATOMICS, _FLUSH_SLABS = range(3)  # csrc/fused_pair_cluster.cu Flush
# blocks per cluster, threads per block, and blocks per SM the grid aims
# at (at most what cudaOccupancyMaxActiveClusters allows at those threads
# and the [9, S] accumulator).  H100 sweep at the uniform 1M shape
# (scripts/torch_redesign_sweep.py --only variants --sweep, C 2-16 x 256,
# 512 threads x 1-3 blocks per SM): v2 / v3 0.0495 / 0.0520 ms at C 2,
# 512 x 2; 0.0500 / 0.0552 at C 4; at C 8 and 16 0.078 / 0.079, as slow
# as one block per SM (C 2, 512 x 1: 0.0709) though the occupancy query
# holds 30 clusters of 8 (240 blocks); 256 threads 0.072 and worse
CLUSTER_SIZE = 2
CLUSTER_THREADS = 512
CLUSTER_BLOCKS_PER_SM = 2
VARIANTS = ("fused_pair_v1_rows", "fused_pair_v2_smem", "fused_pair_v3_partials")


def variant_route(name: str, Ci: int, Cj: int, S: int) -> str:
    """The kernel variant `name` (fused_pair_v1_rows, fused_pair_v2_smem or
    fused_pair_v3_partials) launches on a CUDA tensor.  v1: itself (the
    rows kernel) for the 3 x 9 pair at any S, else its first body,
    name + "_generic", for any Ci <= 8, Cj <= 16.  v2, v3: themselves (the
    cluster kernel) where persistent_fits(Ci, Cj, S); else their first
    bodies where those take the pair and its [Cj, S] f32 accumulator fits
    _cuda.MAX_DYNAMIC_SMEM.  Raises ValueError for a shape neither takes."""
    if name not in VARIANTS:
        raise ValueError(f"variant_route: unknown variant {name!r}")
    pair_ok = 1 <= Ci <= MAX_CI and 1 <= Cj <= MAX_CJ and 1 <= S
    if name == "fused_pair_v1_rows":
        if (Ci, Cj) in PERSISTENT_PAIRS and S >= 1:
            return name
        if pair_ok:
            return name + "_generic"
        raise ValueError(f"{name}: no kernel for Ci={Ci}, Cj={Cj}, S={S} (the rows kernel "
                         f"takes {sorted(PERSISTENT_PAIRS)}, the generic body Ci <= {MAX_CI}, "
                         f"Cj <= {MAX_CJ})")
    if persistent_fits(Ci, Cj, S):
        return name
    if pair_ok and Cj * S * 4 <= _cuda.MAX_DYNAMIC_SMEM:
        return name + "_generic"
    raise ValueError(f"{name}: no kernel for Ci={Ci}, Cj={Cj}, S={S} (the cluster kernel takes "
                     f"{sorted(PERSISTENT_PAIRS)} with Cj*S*4 <= {PERSISTENT_MAX_SMEM}, the "
                     f"generic body Ci <= {MAX_CI}, Cj <= {MAX_CJ}, Cj*S*4 <= "
                     f"{_cuda.MAX_DYNAMIC_SMEM})")


def cluster_plan(N: int, elems: int, threads: int, C: int, max_clusters: int):
    """(grid, n_slabs) of the cluster kernel at N elements, elems a thread
    and threads a block: as many clusters of C blocks as max_clusters
    allows, no more than the element tiles fill (at least one); the grid
    is clusters x C blocks, and v3 writes one slab per cluster."""
    if min(elems, threads, C, max_clusters) < 1 or N < 0:
        raise ValueError(f"cluster_plan: N={N}, elems={elems}, threads={threads}, C={C}, "
                         f"max_clusters={max_clusters}")
    tiles = -(-N // (threads * elems))
    clusters = max(1, min(max_clusters, -(-tiles // C)))
    return clusters * C, clusters


@functools.lru_cache(maxsize=None)
def max_active_clusters(device, S, threads, C, elems, mode=_FLUSH_ATOMICS) -> int:
    """Clusters of C blocks of the cluster kernel's instantiation (elems,
    mode) that the card holds at once (cudaOccupancyMaxActiveClusters;
    cached).  0 where none fits; raises where the card refuses the query
    (e.g. C > 8 without non-portable cluster sizes)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = _cuda.lib().thallo_fused_pair_cluster_occupancy(S, threads, C, elems, mode,
                                                               ctypes.byref(n))
    _cuda.check(code, f"cudaOccupancyMaxActiveClusters (S={S}, threads={threads}, C={C})")
    return n.value


def cluster_threads(N: int, elems: int, aim_blocks: int) -> int:
    """Threads a block of the cluster kernel: CLUSTER_THREADS, unless its
    block-sized tiles of N elements would give fewer than half of the
    aim_blocks blocks a tile; then the fewest warps (at least 2) whose
    tiles spread N over aim_blocks blocks, so a short level still reaches
    most SMs."""
    per_block = CLUSTER_THREADS * elems
    if 2 * -(-N // per_block) >= aim_blocks:
        return CLUSTER_THREADS
    return min(CLUSTER_THREADS, max(64, 32 * -(-N // (32 * elems * aim_blocks))))


def cluster_grid(device, N: int, S: int, mode: int = _FLUSH_ATOMICS):
    """(threads, grid, n_slabs) of a launch of the cluster kernel at N
    elements and the current CLUSTER_* constants: CLUSTER_BLOCKS_PER_SM
    blocks per SM in clusters of CLUSTER_SIZE, at most the clusters the
    card holds at once (raises where it holds none)."""
    elems, C = bf16_elems(N), CLUSTER_SIZE
    aim = -(-CLUSTER_BLOCKS_PER_SM * _cuda.sm_count(device) // C)
    threads = cluster_threads(N, elems, aim * C)
    occupancy = max_active_clusters(device, S, threads, C, elems, mode)
    if occupancy < 1:
        raise RuntimeError(f"no cluster of {C} blocks of {threads} threads and a "
                           f"{9 * S * 4}-byte accumulator fits the card")
    return (threads, *cluster_plan(N, elems, threads, C, min(aim, occupancy)))


def _launch_cluster(fn, mode, ids2d, blocks_wm, pcol, prow, Ci, Cj, S):
    what = fn.__name__
    W, N, blocks = _checked(what, ids2d, blocks_wm, pcol, prow, Ci, Cj, S, torch.bfloat16)
    if not persistent_fits(Ci, Cj, S):
        raise ValueError(f"{what}: no cluster kernel for Ci={Ci}, Cj={Cj}, S={S}")
    dev = ids2d.device
    threads, grid, n_slabs = cluster_grid(dev, N, S, mode)
    n_pad = -(-(Cj * S) // 4) * 4
    rows = torch.empty((Ci, N), dtype=torch.float32, device=dev)
    out = None
    if mode == _FLUSH_ATOMICS:
        out = torch.zeros((Cj, S), dtype=torch.float32, device=dev)
    elif mode == _FLUSH_SLABS:
        out = torch.empty((n_slabs, n_pad), dtype=torch.float32, device=dev)
    code = _cuda.lib().thallo_fused_pair_cluster(
        ids2d.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(), rows.data_ptr(),
        None if out is None else out.data_ptr(), W, N, Ci, Cj, S, threads, grid, CLUSTER_SIZE,
        MERGE_MIN, bf16_elems(N), mode, _cuda.stream(ids2d))
    _cuda.check(code, what)
    fn.launches += 1
    if mode == _FLUSH_SLABS:  # the slabs summed outside the kernel, as make_v3's jnp.sum
        out = torch.sum(out, 0)[:Cj * S].view(Cj, S)
    return rows, out


def fused_pair_v2_smem(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v2 (make_v2: one cols accumulator carried across the grid)
    -> (rows, cols): the cluster kernel, whose clusters sum their blocks'
    shared accumulators through distributed shared memory and add the sum
    to cols by one global atomic per nonzero entry; shapes it does not
    take go to fused_pair_v2_smem_generic (variant_route).  CPU tensors
    take the plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if variant_route("fused_pair_v2_smem", Ci, Cj, S) != "fused_pair_v2_smem":
        return fused_pair_v2_smem_generic(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_cluster(fused_pair_v2_smem, _FLUSH_ATOMICS, ids2d, blocks_wm, pcol, prow, Ci,
                           Cj, S)


def fused_pair_v3_partials(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """Variant v3 (make_v3: cols partials summed outside the kernel) ->
    (rows, cols): the cluster kernel, each cluster storing its reduced
    accumulator as one slab without atomics, the slabs summed by
    torch.sum; shapes it does not take go to
    fused_pair_v3_partials_generic (variant_route).  CPU tensors take the
    plain version."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    if variant_route("fused_pair_v3_partials", Ci, Cj, S) != "fused_pair_v3_partials":
        return fused_pair_v3_partials_generic(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)
    return _launch_cluster(fused_pair_v3_partials, _FLUSH_SLABS, ids2d, blocks_wm, pcol, prow, Ci,
                           Cj, S)


def fused_pair_cluster_noflush(ids2d, blocks_wm, pcol, prow, *, Ci, Cj, S):
    """rows [Ci, N] alone, by the cluster kernel with its cols summed in
    each cluster but never stored (a measurement of the body and the
    in-cluster sum without the cross-cluster step; the cluster kernel's
    shapes only)."""
    if ids2d.device.type == "cpu":
        return fused_pair_apply_reference(ids2d, blocks_wm, pcol, prow, Ci=Ci, Cj=Cj, S=S)[0]
    return _launch_cluster(fused_pair_cluster_noflush, _NO_FLUSH, ids2d, blocks_wm, pcol, prow,
                           Ci, Cj, S)[0]


for _fn in (fused_pair_v2_smem, fused_pair_v3_partials, fused_pair_cluster_noflush):
    _fn.launches = 0
