"""Block-sparse materialized JᵀJ for graph energies (counterpart of
``thallo_tpu/solver/blocksparse.py``).

Each unknown slot of a group takes one of three row forms, chosen at
table build (plan init) as the JAX package chooses:

* **one-hot row mode** for slots over small images (BA cameras:
  ``N <= THALLO_ONEHOT_ROWS`` (1024) and ``R >= 4*N``).  The name is kept;
  on the GPU their setup aggregation is a segment sum by element id
  (ops/ohsetup.py) and their cross JᵀJ·p term is the transpose of the
  partner pair's blocks, computed by the fused pair kernel;
* **full-repeat row tables** when the index array is
  ``repeat(arange(N), W)`` (a sorted map with W >= 2 incidences per
  element, which the JAX package keys by affine segment): observation
  ``n*W + w`` is entry (n, w) of the table and the setup reads contiguous
  windows (ops/fullrepeat.py);
* **rank-keyed level tables** for every other map (degree skew, unsorted
  maps, affine maps that are not a full repeat, which the JAX package
  keys by segment): level 0 is an [N, W0] table over the first W0 incidences of
  every element, and each overflow level covers incidence ranks
  [T, T+W) of the N_t elements whose degree exceeds T, with its element
  ids in ``row_sels``.  The setup gathers one channel-major payload per
  level (``index_select`` by perm, times mask) and folds the overflow
  levels' sums into one ``index_add_`` per base table; the apply adds the
  overflow levels' row contributions with one ``index_add_`` per slot.

The tables (perms, masks, cols, row_sels, row_starts, oh_idxs, pairs)
equal what JAX's ``build_group_bsr`` builds, but for two TPU workarounds
left out: affine maps get rank-keyed tables, not segment-keyed ones, and
a col pair takes a transpose partner at any element count (JAX stops at
8192 by default).  A col pair with a transpose
partner runs both directions through one fused kernel launch per level
(the kernel ``fused_pair_route`` names for the level's shape: the
persistent ``fused_pair_apply`` or the W-loop kernel for wide, short
levels; under ``block_dtype="bf16"`` their bf16 instantiations, and
the slots kernel on bf16 blocks, ``fused_pair_apply_atomics_bf16``, for
the other shapes); a col pair without one
gathers p by its col table and multiplies.  An image that
``linear_solver="schur_dense"`` is told to eliminate builds row tables
instead of one-hot rows and keeps its col blocks (``onehot_exclude``):
the dense Schur assembly reads its couplings from them.  A pure-stencil
group, and a group whose tables exceed the padding budget, build none
(``build_group_bsr`` returns None, as JAX's does).

Under a mesh each rank builds the tables of its own residual shard
(perms hold local residual ids; col tables and one-hot ids hold global
element ids).  A row table whose index array stays inside the element
block the rank owns is a **window**: its rows are that block alone
(``row_win``, JAX's row-block sharding of the tables,
``thallo_tpu/parallel/mesh.py:55-102``), its overflow ids count from the
block's start, and its diag blocks and row contributions cover the block;
``bsr_setup`` and ``bsr_apply`` return full images all the same.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import structured
from ..ops.fullrepeat import fullrepeat_setup
from ..ops.fusedpair import (fused_pair_apply, fused_pair_apply_atomics,
                             fused_pair_apply_atomics_bf16,
                             fused_pair_apply_atomics_f64, fused_pair_apply_atomics_thread,
                             fused_pair_apply_atomics_thread_f64, fused_pair_apply_bf16,
                             fused_pair_apply_f64, fused_pair_apply_wloop,
                             fused_pair_apply_wloop_bf16, fused_pair_apply_wloop_chunked,
                             fused_pair_route)
from ..ops.ohsetup import oh_setup_products, setup_slabs

# padding budget of the rank-keyed tables: sum N_t*W_t <= MAX_WASTE*R + MAX_PAD_EXTRA
MAX_WASTE = 4.0
MAX_PAD_EXTRA = 1 << 16


@dataclasses.dataclass
class GroupBsr:
    """Static row/col tables for one lowered group."""

    perms: Tuple[torch.Tensor, ...]      # per row table: [N_t, W_t] int32 into [0, R)
    masks: Tuple[torch.Tensor, ...]      # per row table: [N_t, W_t] float (1 = valid)
    cols: Tuple[torch.Tensor, ...]       # per col table: [W_t, N_t] int32 element ids
    slot_row: Tuple[int, ...]            # slot i -> BASE row table, or -1 for one-hot row mode
    pairs: Tuple[tuple, ...]             # (i, j, "diag") | (i, j, "col", gather_idx) per level
    #                                      | (i, j, "transpose", partner_pair_idx)
    col_gathers: Tuple[tuple, ...]       # per gather: (col_table, image_name, C)
    slot_images: Tuple[str, ...]         # slot i -> image name
    slot_channels: Tuple[int, ...]       # slot i -> channel count
    image_shapes: dict                   # image name -> full array shape
    col_row: Tuple[int, ...]             # col table -> owning row table
    row_base: Tuple[int, ...]            # row table -> its level-0 base table
    # per row table: [N_t] int32 element ids of an overflow level, or None
    # (level 0 covers every element)
    row_sels: Tuple[Optional[torch.Tensor], ...]
    oh_idxs: Tuple[Optional[torch.Tensor], ...]  # per slot: [R] int32 ids (one-hot) or None
    # per row table of a sorted map: [N_t] int32 first payload row of each
    # element's run at this level, or None.  Kept on the host: JAX's
    # sorted-run gather reads it, the port's gather reads the perm.
    row_starts: Tuple[Optional[np.ndarray], ...]
    full_repeat: Tuple[bool, ...]        # row table -> full-repeat (ops/fullrepeat.py)
    # per row table: (first element, elements of the image) of a window,
    # or None (the table's rows are the whole image)
    row_win: Tuple[Optional[Tuple[int, int]], ...] = ()

    def levels_of(self, base: int) -> Tuple[int, ...]:
        """All row tables sharing this base, base first."""
        return _levels_of(self.row_base, base)

    def slot_onehot(self, i: int) -> bool:
        return self.slot_row[i] < 0

    def window(self, t: int) -> Optional[Tuple[int, int]]:
        """(first element, image elements) of row table t's window, or None."""
        return self.row_win[t] if t < len(self.row_win) else None

    def diag_full(self, p_idx: int, blk: torch.Tensor) -> torch.Tensor:
        """A diag pair's blocks [Ci*Cj, N] over the whole image (a window's
        blocks padded with zero blocks)."""
        row = self.slot_row[self.pairs[p_idx][0]]
        return blk if row < 0 else _embed(blk, self.window(row))


def _embed(v: torch.Tensor, win) -> torch.Tensor:
    """[F, N_win] values of a window -> [F, N] over the whole image."""
    if win is None:
        return v
    lo, n = win
    return torch.nn.functional.pad(v, (lo, n - lo - v.shape[1]))


def _levels_of(row_base, base: int) -> Tuple[int, ...]:
    return tuple(t for t, b in enumerate(row_base) if b == base)


def _repeat_width(idx: np.ndarray, N: int) -> int:
    """W when idx == repeat(arange(N), W), else 0."""
    R = idx.shape[0]
    if N <= 0 or R % N:
        return 0
    W = R // N
    if not np.array_equal(idx.reshape(N, W), np.broadcast_to(np.arange(N)[:, None], (N, W))):
        return 0
    return W


def _seg_keyed(idx: np.ndarray, N: int, R: int) -> bool:
    """Whether thallo_tpu keys this index array's row table by affine
    segment (``_seg_keyed_table``, blocksparse.py:147-197): the same
    tests, without building the table."""
    segs = structured.detect_segments_cached(idx) if structured.enabled() else None
    segs = structured.normalize_segments(segs)
    if segs is None:
        return False
    D = 0
    for (_s0, H, W, _b, c1, c2) in segs:
        if c2 == 0 and W > 1:
            if H > 1 and c1 == 0:
                return False  # same unknown everywhere: not keyable
            D += W
        else:
            D += 1
    return D <= 32 and N * D <= MAX_WASTE * R + MAX_PAD_EXTRA


def _level_widths(counts: np.ndarray, R: int, max_waste: float,
                  max_pad_extra: int) -> Optional[List[Tuple[int, int]]]:
    """Level boundaries [(rank_start, width), ...] of a rank-keyed row
    table under degree skew (a copy of thallo_tpu's ``_level_widths``).
    Level 0 covers every element; each further level covers the elements
    whose degree exceeds the cumulative cap, with geometrically growing
    widths.  The base width minimizes the padded entries plus 16384 per
    level, within the waste budget; None when even W0 = 1 exceeds it."""
    N = counts.shape[0]
    Dmax = int(counts.max()) if counts.size else 1
    Dmax = max(Dmax, 1)
    budget = max_waste * R + max_pad_extra
    if N > budget:
        return None
    csort = np.sort(counts)

    def simulate(W0):
        levels = [(0, min(W0, Dmax))]
        total = N * levels[0][1]
        T = levels[0][1]
        while T < Dmax:
            n_over = int(N - np.searchsorted(csort, T, side="right"))
            if n_over == 0:
                break
            remaining = int(np.clip(counts - T, 0, None).sum())
            if n_over * (Dmax - T) <= max_waste * remaining + 4096:
                W = Dmax - T  # the tail is cheap to finish in one level
            else:
                W = min(max(1, 3 * T), Dmax - T)
            levels.append((T, W))
            total += n_over * W
            T += W
        return levels, total

    qs = [max(1, int(np.ceil(np.quantile(counts, q))))
          for q in (0.5, 0.75, 0.9, 0.95)]
    cands = sorted({*qs, *(1 << k for k in range(0, 11)
                           if (1 << k) <= max(qs[-1] * 2, 2))})
    best = None
    for W0 in cands:
        if N * W0 > budget:
            continue
        levels, total = simulate(W0)
        if total > budget:
            continue
        score = total + 16384 * len(levels)
        if best is None or score < best[1]:
            best = (levels, score)
    if best is None:
        return None
    return best[0]


def _rank_keyed_tables(idx: np.ndarray, N: int, R: int, max_waste: float,
                       max_pad_extra: int) -> Optional[List[dict]]:
    """The level tables of one index array (a copy of thallo_tpu's
    ``_rank_keyed_tables``): dicts with perm, mask, sel (None on level 0)
    and start (run starts when the array is sorted, else None), level 0
    first; None when the budget refuses every base width."""
    counts = np.bincount(idx, minlength=N)
    levels = _level_widths(counts, R, max_waste, max_pad_extra)
    if levels is None:
        return None
    order = np.argsort(idx, kind="stable").astype(np.int64)
    starts = np.zeros(N + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    sorted_rows = idx[order]
    pos = np.arange(R, dtype=np.int64) - starts[sorted_rows]
    is_sorted = bool(np.all(np.diff(idx) >= 0)) if idx.size else False
    out = []
    for li, (T, W) in enumerate(levels):
        if li == 0:
            sel = None
            rowmap = None
            N_t = N
        else:
            sel = np.nonzero(counts > T)[0].astype(np.int32)
            N_t = sel.shape[0]
            if N_t == 0:
                continue
            rowmap = np.full(N, -1, np.int64)
            rowmap[sel] = np.arange(N_t)
        in_level = (pos >= T) & (pos < T + W)
        rows = sorted_rows[in_level]
        lanes = pos[in_level] - T
        perm = np.zeros((N_t, W), np.int32)
        mask = np.zeros((N_t, W), np.float32)
        r_t = rows if rowmap is None else rowmap[rows]
        perm[r_t, lanes] = order[in_level].astype(np.int32)
        mask[r_t, lanes] = 1.0
        run_start = None
        if is_sorted:
            elems = np.arange(N, dtype=np.int64) if sel is None else sel
            run_start = np.minimum(starts[elems] + T, R).astype(np.int32)
        out.append({"perm": perm, "mask": mask, "sel": sel, "start": run_start})
    return out


def build_group_bsr(group, idxs: List[np.ndarray], dtype, device,
                    onehot_exclude=(), row_windows=None) -> Optional[GroupBsr]:
    """Build the static tables from the slots' concrete flat indices
    (host side, once per init).  idxs[i] is slot i's [R] element index.
    THALLO_ONEHOT_ROWS and THALLO_TRANSPOSE_ROWS are read here, as
    thallo_tpu reads them (the latter without JAX's default cap).  Slots of an image in onehot_exclude build row
    tables and keep their col blocks (schur_dense eliminates through
    them).  Returns None where JAX's ``build_group_bsr`` does
    (thallo_tpu/solver/blocksparse.py:381-383, :468-470): for a
    pure-stencil group, and when an index array's rank-keyed tables
    exceed the padding budget; the solver then runs the group from its
    stored point Jacobians.  The slots are the group's jac slots (the
    unknown slots, then the composed slots of materialized computed
    arrays); a group with contractions builds none.  row_windows (image
    name -> [lo, hi), a rank's owned elements under a mesh): a row table
    whose every slot's image has that window, narrower than the image, and
    whose index array lies inside it covers the window's rows alone."""
    jslots = group.jac_slots
    R = group.R
    if not jslots or R == 0 or group.con_domains or any(s.dep_cons for s in jslots) \
            or group.pure_stencil:
        return None
    slot_N = [int(np.prod([d.size for d in s.image.dims])) for s in jslots]
    nslots = len(jslots)

    oh_max = int(os.environ.get("THALLO_ONEHOT_ROWS", "1024"))
    onehot = [0 < oh_max and slot_N[i] <= oh_max and R >= 4 * slot_N[i]
              and jslots[i].image.name not in onehot_exclude
              for i in range(nslots)]
    for i in range(nslots):
        for j in range(nslots):
            if i == j or not (onehot[i] and onehot[j]):
                continue
            if slot_N[i] == slot_N[j] and np.array_equal(idxs[i], idxs[j]):
                continue  # diag pair: pure aggregation, no table needed
            k = i if slot_N[i] > slot_N[j] else j  # demote the larger
            onehot[k] = False
    # JAX caps the transposed slot at 8192 elements by default: on the TPU
    # the transpose side is a one-hot MXU aggregation whose cost grows with
    # the slot's N (thallo_tpu/solver/blocksparse.py:416-428).  On the GPU
    # it is the fused-pair kernel's cols scatter, in the same pass over the
    # blocks as the rows, at any N; so the port transposes at any N unless
    # THALLO_TRANSPOSE_ROWS sets a cap (0: none)
    tr_env = os.environ.get("THALLO_TRANSPOSE_ROWS")
    tr_max = None if tr_env is None else int(tr_env)

    def _transpose_ok(i, j):
        if onehot[i]:
            return True
        if (tr_max is not None and slot_N[i] > tr_max) or onehot[j] \
                or jslots[i].image.name in onehot_exclude:
            return False
        return (slot_N[i], i) < (slot_N[j], j)

    # row tables keyed by the index array's bytes; each key maps to its
    # base (level-0) table
    row_of_slot: List[int] = []
    tables: List[dict] = []
    row_base_of: List[int] = []
    key_to_row: Dict[bytes, int] = {}
    wins = [None if row_windows is None else row_windows.get(s.image.name) for s in jslots]
    for i, s in enumerate(jslots):
        if onehot[i]:
            row_of_slot.append(-1)
            continue
        key = idxs[i].tobytes()
        if key not in key_to_row:
            idx, N, base = idxs[i], slot_N[i], len(tables)
            same = [k for k in range(nslots) if not onehot[k] and idxs[k].tobytes() == key]
            win = wins[i]
            if win is not None and win[1] - win[0] < N and idx.size \
                    and all(wins[k] == win for k in same) \
                    and win[0] <= int(idx.min()) and int(idx.max()) < win[1]:
                idx, N, win = idx - win[0], win[1] - win[0], (win[0], N)
            else:
                win = None
            W = _repeat_width(idx, N) if _seg_keyed(idx, N, R) else 0
            if W >= 2:
                tables.append({"perm": np.arange(R, dtype=np.int32).reshape(N, W),
                               "mask": np.ones((N, W), np.float32), "sel": None,
                               "start": None, "full": True, "win": win})
                row_base_of.append(base)
            else:
                # every other map, affine ones included (JAX keys those by
                # segment, a TPU gather workaround)
                levels = _rank_keyed_tables(idx, N, R, MAX_WASTE, MAX_PAD_EXTRA)
                if levels is None:
                    return None  # N alone exceeds the padding budget
                for t in levels:
                    tables.append({**t, "full": False, "win": win})
                    row_base_of.append(base)
            key_to_row[key] = base
        row_of_slot.append(key_to_row[key])

    pairs: List[tuple] = []
    col_tables: List[np.ndarray] = []
    col_row_of: List[int] = []
    col_key: Dict[tuple, int] = {}
    gathers: List[tuple] = []
    gather_key: Dict[tuple, int] = {}
    partner_pairs: Dict[Tuple[int, int], List[int]] = {}  # (i, j) -> col pairs, per level
    transpose_todo: List[Tuple[int, int]] = []
    for i in range(nslots):
        for j, sj in enumerate(jslots):
            if slot_N[i] == slot_N[j] and np.array_equal(idxs[i], idxs[j]):
                pairs.append((i, j, "diag"))
                continue
            if _transpose_ok(i, j):
                transpose_todo.append((i, j))
                continue
            plist = []
            for t in _levels_of(row_base_of, row_of_slot[i]):
                ck = (t, idxs[j].tobytes())
                if ck not in col_key:
                    # column element ids aligned to table t's padded layout
                    # (padded lanes repeat idxs[j][0]; their blocks are 0)
                    col_key[ck] = len(col_tables)
                    col_tables.append(np.ascontiguousarray(
                        idxs[j][tables[t]["perm"]].astype(np.int32).T))
                    col_row_of.append(t)
                gk = (col_key[ck], sj.image.name)
                if gk not in gather_key:
                    gather_key[gk] = len(gathers)
                    gathers.append((col_key[ck], sj.image.name, sj.image.channels))
                plist.append(len(pairs))
                pairs.append((i, j, "col", gather_key[gk]))
            partner_pairs[(i, j)] = plist
    for (i, j) in transpose_todo:
        for pidx in partner_pairs[(j, i)]:
            pairs.append((i, j, "transpose", pidx))

    shapes = {s.image.name: tuple(d.size for d in s.image.dims) + (s.image.channels,)
              for s in jslots}

    def dev(a, dt=None):
        return None if a is None else torch.as_tensor(a, dtype=dt).to(device)

    return GroupBsr(
        perms=tuple(dev(t["perm"]) for t in tables),
        masks=tuple(dev(t["mask"], dtype) for t in tables),
        cols=tuple(dev(c) for c in col_tables),
        slot_row=tuple(row_of_slot),
        pairs=tuple(pairs),
        col_gathers=tuple(gathers),
        slot_images=tuple(s.image.name for s in jslots),
        slot_channels=tuple(s.image.channels for s in jslots),
        image_shapes=shapes,
        col_row=tuple(col_row_of),
        row_base=tuple(row_base_of),
        row_sels=tuple(dev(t["sel"]) for t in tables),
        oh_idxs=tuple(dev(idxs[i].astype(np.int32)) if onehot[i] else None
                      for i in range(nslots)),
        row_starts=tuple(t["start"] for t in tables),
        full_repeat=tuple(t["full"] for t in tables),
        row_win=tuple(t["win"] for t in tables),
    )


def _stack_slots(jTs, slots, rc, R):
    """Stacked channel-major slot rows [sum rc*C, R] and each slot's row
    offset (rows off + c*C + ch)."""
    offs, K, parts = {}, 0, []
    for s in slots:
        offs[s] = K
        K += jTs[s].shape[0] * jTs[s].shape[1]
        parts.append(jTs[s].reshape(-1, R))
    return torch.cat(parts).contiguous(), offs


def _pair_slots(bsr, kind, key):
    return (bsr.pairs[key][0], bsr.pairs[key][1]) if kind == "pair" else (key,)


def _slab_entry(bsr, kind, key, offs):
    """The ohsetup/fullrepeat recipe entry of one spec, without its kind."""
    if kind == "pair":
        a, b = bsr.pairs[key][0], bsr.pairs[key][1]
        return (offs[a], bsr.slot_channels[a], offs[b], bsr.slot_channels[b])
    return (offs[key], bsr.slot_channels[key])


def _stored(blk, block_dtype):
    """A cross block as stored: cast after it is made in f32, as JAX's
    ``blk.astype(block_dtype)`` (thallo_tpu/solver/blocksparse.py:905-906)."""
    return blk if block_dtype is None else blk.to(block_dtype)


def _setup_levels(bsr, base, specs, rT, Jall, offs, blocks, block_dtype):
    """Setup of a rank-keyed table: the per-observation slabs of every
    spec (one payload [F, R], each cross pair's slab once), one gather of
    it per level, the aggregated rows summed into full element order
    (overflow levels by one index_add_) and each col pair's w-major
    blocks [W*Ci*Cj, N_t] from its level's gather (cast to block_dtype
    where given).  Returns the aggregated [A, N] in the order of the
    non-cross specs."""
    recipe, A = [], 0
    for kind, key, width in specs:
        if kind != "pair" or bsr.pairs[key][2] == "diag":
            recipe.append((kind,) + _slab_entry(bsr, kind, key, offs))
            A += width
    F, cross_off, level_pairs = A, {}, {}
    for kind, key, width in specs:
        if kind != "pair" or bsr.pairs[key][2] == "diag":
            continue
        ij = bsr.pairs[key][:2]
        if ij not in cross_off:
            cross_off[ij] = F
            recipe.append(("pair",) + _slab_entry(bsr, kind, key, offs))
            F += width
        t = bsr.col_row[bsr.col_gathers[bsr.pairs[key][3]][0]]
        level_pairs.setdefault(t, []).append((key, cross_off[ij], width))
    payload = setup_slabs(rT, Jall, tuple(recipe))  # [F, R]
    agg, deferred = None, []
    for t in bsr.levels_of(base):
        N_t, W = bsr.perms[t].shape
        g = payload.index_select(1, bsr.perms[t].T.reshape(-1)).view(F, W, N_t) \
            * bsr.masks[t].T
        gsum = g[:A].sum(1)  # [A, N_t]
        if bsr.row_sels[t] is None:
            agg = gsum if agg is None else agg + gsum
        else:
            deferred.append((bsr.row_sels[t], gsum))
        for key, off, width in level_pairs.get(t, ()):
            blocks[key] = _stored(
                g[off:off + width].transpose(0, 1).reshape(W * width, N_t), block_dtype)
    if deferred:
        agg.index_add_(1, torch.cat([s for s, _ in deferred]),
                       torch.cat([v for _, v in deferred], 1))
    return agg


def bsr_setup(bsr: GroupBsr, rT, jTs, block_dtype=None):
    """Once per nonlinear iteration: JᵀF, diag(JᵀJ) and every pair's
    blocks.  rT [rc, R], jTs per slot [rc, C, R] (channel-major, as
    point_jacobians_cm makes them).  Returns (jtr, d2, blocks): jtr/d2
    map image -> [*imshape], blocks map pair idx -> [Ci*Cj, N] (diag) or
    [W*Ci*Cj, N_t] w-major (col pairs, per level; transpose pairs store
    nothing).  block_dtype (None or torch.bfloat16): the storage of the
    cross blocks; diag blocks, jtr and d2 stay f32."""
    rc, R = rT.shape
    rT = rT.contiguous()
    jtr_out: Dict[str, torch.Tensor] = {}
    d2_out: Dict[str, torch.Tensor] = {}
    blocks: Dict[int, torch.Tensor] = {}

    def add(out, name, v):
        out[name] = out[name] + v if name in out else v

    def scatter_slabs(agg, specs, win=None):
        off = 0
        for kind, key, width in specs:
            v = agg[off:off + width]
            if kind == "pair":
                blocks[key] = v  # [Ci*Cj, N] diag block (over the window)
            else:
                name = bsr.slot_images[key]
                add(jtr_out if kind == "jtr" else d2_out, name,
                    _embed(v, win).T.reshape(bsr.image_shapes[name]))
            off += width

    # ---- one-hot row slots: segment sum by element id --------------------
    for i in range(len(bsr.slot_images)):
        if not bsr.slot_onehot(i):
            continue
        C = bsr.slot_channels[i]
        specs = [("jtr", i, C), ("d2", i, C)]
        specs += [("pair", p, C * bsr.slot_channels[pr[1]])
                  for p, pr in enumerate(bsr.pairs) if pr[2] == "diag" and pr[0] == i]
        slots = sorted({i} | {bsr.pairs[k][1] for kind, k, _ in specs if kind == "pair"})
        Jall, offs = _stack_slots(jTs, slots, rc, R)
        recipe = tuple((kind,) + _slab_entry(bsr, kind, key, offs) for kind, key, _ in specs)
        N = int(np.prod(bsr.image_shapes[bsr.slot_images[i]][:-1]))
        agg = oh_setup_products(rT, Jall, bsr.oh_idxs[i], N=N, recipe=recipe)
        scatter_slabs(agg, specs)

    # ---- table-backed slots: one setup pass per base table ---------------
    for base in dict.fromkeys(bsr.row_base):
        specs, slots = [], []
        for i in range(len(bsr.slot_images)):
            if bsr.slot_row[i] == base:
                specs += [("jtr", i, bsr.slot_channels[i]), ("d2", i, bsr.slot_channels[i])]
        for p, pr in enumerate(bsr.pairs):
            if pr[2] != "transpose" and bsr.slot_row[pr[0]] == base:
                specs.append(("pair", p, bsr.slot_channels[pr[0]] * bsr.slot_channels[pr[1]]))
        for kind, key, _ in specs:
            for s in _pair_slots(bsr, kind, key):
                if s not in slots:
                    slots.append(s)
        Jall, offs = _stack_slots(jTs, slots, rc, R)
        agg_specs = [sp for sp in specs
                     if sp[0] != "pair" or bsr.pairs[sp[1]][2] == "diag"]
        if not bsr.full_repeat[base]:
            scatter_slabs(_setup_levels(bsr, base, specs, rT, Jall, offs, blocks, block_dtype),
                          agg_specs, bsr.window(base))
            continue
        N_t, W = bsr.perms[base].shape
        recipe, cross_keys = [], []
        for kind, key, _ in specs:
            ent = _slab_entry(bsr, kind, key, offs)
            if kind != "pair":
                recipe.append((kind,) + ent)
            elif bsr.pairs[key][2] == "diag":
                recipe.append(("diag",) + ent)
            else:
                recipe.append(("cross",) + ent + (len(cross_keys),))
                cross_keys.append(key)
        agg, crosses = fullrepeat_setup(rT, Jall, W=W, N_t=N_t, recipe=tuple(recipe))
        scatter_slabs(agg, agg_specs, bsr.window(base))
        for key, blk in zip(cross_keys, crosses):
            blocks[key] = _stored(blk, block_dtype)
    return jtr_out, d2_out, blocks


def bsr_apply(bsr: GroupBsr, blocks, p):
    """JᵀJ·p for this group from the assembled blocks.  Diagonal pairs are
    a per-element block matvec; each col pair and its transpose partner
    run through one fused kernel launch per level (bf16 cross blocks
    as they are stored: the kernels read them); a col pair without a
    partner gathers p by its col table (its blocks upcast to f32 first).  Overflow levels' row
    contributions are merged into one index_add_ per slot (duplicate ids
    across levels accumulate).  A slot whose row table is a window sums its
    diag and row contributions over the window, its col contributions over
    the whole image, and adds the two at the end.  p: dict image ->
    [*imshape].  Returns dict image -> [*imshape] contribution."""
    pT = {img: p[img].reshape(-1, p[img].shape[-1]).T.contiguous()
          for img in set(bsr.slot_images)}
    partnered = {pr[3] for pr in bsr.pairs if pr[2] == "transpose"}
    acc: Dict[int, torch.Tensor] = {}
    acc_win: Dict[int, torch.Tensor] = {}  # window slots' diag and row contributions
    deferred: Dict[int, list] = {}
    win_of = {i: bsr.window(bsr.slot_row[i]) for i in range(len(bsr.slot_images))
              if not bsr.slot_onehot(i) and bsr.window(bsr.slot_row[i]) is not None}

    def prow_of(i):
        """[Ci, rows of slot i's table]: p at the table's rows."""
        v = pT[bsr.slot_images[i]]
        if i in win_of:
            lo = win_of[i][0]
            v = v[:, lo:lo + bsr.perms[bsr.slot_row[i]].shape[0]]
        return v

    def add(i, v, sel=None, row=True):
        if sel is not None:
            deferred.setdefault(i, []).append((sel, v))
        else:
            a = acc_win if row and i in win_of else acc
            a[i] = a[i] + v if i in a else v

    for p_idx, pr in enumerate(bsr.pairs):
        i, j, kind = pr[0], pr[1], pr[2]
        Ci, Cj = bsr.slot_channels[i], bsr.slot_channels[j]
        if kind == "transpose":
            continue  # computed with its partner col pair
        if kind == "diag":
            B = blocks[p_idx].reshape(Ci, Cj, -1)
            add(i, (B * prow_of(j)[None]).sum(1))
            continue
        ct = bsr.col_gathers[pr[3]][0]
        ids = bsr.cols[ct]
        W, N_t = ids.shape
        sel = bsr.row_sels[bsr.col_row[ct]]
        prow = prow_of(i)
        if sel is not None:
            prow = prow.index_select(1, sel)  # [Ci, N_t]: the overflow elements
        pcol = pT[bsr.slot_images[j]]
        if p_idx in partnered:
            route = fused_pair_route(W, N_t, Ci, Cj, pcol.shape[1],
                                     bf16=blocks[p_idx].dtype == torch.bfloat16,
                                     dtype=pcol.dtype)
            fn = {"fused_pair_apply": fused_pair_apply,
                  "fused_pair_apply_atomics": fused_pair_apply_atomics,
                  "fused_pair_apply_f64": fused_pair_apply_f64,
                  "fused_pair_apply_atomics_f64": fused_pair_apply_atomics_f64,
                  "fused_pair_apply_atomics_thread": fused_pair_apply_atomics_thread,
                  "fused_pair_apply_atomics_thread_f64": fused_pair_apply_atomics_thread_f64,
                  "fused_pair_apply_wloop": fused_pair_apply_wloop,
                  "fused_pair_apply_wloop_chunked": fused_pair_apply_wloop_chunked,
                  "fused_pair_apply_bf16": fused_pair_apply_bf16,
                  "fused_pair_apply_wloop_bf16": fused_pair_apply_wloop_bf16,
                  "fused_pair_apply_atomics_bf16": fused_pair_apply_atomics_bf16}[route]
            rows, cols = fn(ids, blocks[p_idx], pcol, prow.contiguous(), Ci=Ci, Cj=Cj,
                            S=pcol.shape[1])
            add(i, rows, sel)
            add(j, cols, row=False)
            continue
        pg = pcol.index_select(1, ids.reshape(-1)).view(Cj, W, N_t)
        B = blocks[p_idx].view(W, Ci, Cj, N_t).to(pg.dtype)  # bf16 storage: upcast
        add(i, (B * pg.transpose(0, 1)[:, None]).sum((0, 2)), sel)
    out: Dict[str, torch.Tensor] = {}
    for i in dict.fromkeys(list(acc) + list(acc_win) + list(deferred)):
        v = (acc_win if i in win_of else acc).get(i)
        if v is None:
            v = torch.zeros_like(prow_of(i))
        ents = deferred.get(i)
        if ents:
            v = v.index_add(1, torch.cat([s for s, _ in ents]), torch.cat([c for _, c in ents], 1))
        if i in win_of:
            v = _embed(v, win_of[i])
            v = acc[i] + v if i in acc else v
        name = bsr.slot_images[i]
        v = v.T.reshape(bsr.image_shapes[name])
        out[name] = out[name] + v if name in out else v
    return out
