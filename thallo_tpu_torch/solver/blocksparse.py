"""Block-sparse materialized JᵀJ for graph energies (counterpart of
``thallo_tpu/solver/blocksparse.py``), restricted to the two slot kinds
of bundle adjustment:

* **one-hot row mode** for slots over small images (BA cameras: the same
  rule as JAX, ``N <= 1024 and R >= 4*N``).  The name is kept; on the
  GPU their setup aggregation is a segment sum by element id
  (ops/ohsetup.py) and their cross JᵀJ·p term is the transpose of the
  partner pair's blocks, computed by the fused pair kernel;
* **full-repeat row tables** for every other slot: the index array must
  be ``repeat(arange(N), W)`` (a sorted map with W incidences per
  element), so observation ``n*W + w`` is entry (n, w) of the table and
  the setup reads contiguous windows (ops/fullrepeat.py).

The tables (perms, masks, cols, oh_idxs, pairs) equal what JAX's
``build_group_bsr`` builds for such groups.  Not ported yet (they raise
NotImplementedError): rank-keyed row tables with overflow levels (degree
skew, unsorted maps), structured-index plans, the payload-gather setup,
and cross pairs without a transpose partner.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.fullrepeat import fullrepeat_setup
from ..ops.fusedpair import fused_pair_apply
from ..ops.ohsetup import oh_setup_products

ONEHOT_ROWS_MAX = 1024   # one-hot row mode: slot_N <= this and R >= 4*slot_N
TRANSPOSE_ROWS_MAX = 8192


@dataclasses.dataclass
class GroupBsr:
    """Static row/col tables for one lowered group."""

    perms: Tuple[torch.Tensor, ...]      # per row table: [N_t, W_t] int32 into [0, R)
    masks: Tuple[torch.Tensor, ...]      # per row table: [N_t, W_t] float (1 = valid)
    cols: Tuple[torch.Tensor, ...]       # per col table: [W_t, N_t] int32 element ids
    slot_row: Tuple[int, ...]            # slot i -> row table, or -1 for one-hot row mode
    pairs: Tuple[tuple, ...]             # (i, j, "diag") | (i, j, "col", gather_idx)
    #                                      | (i, j, "transpose", partner_pair_idx)
    col_gathers: Tuple[tuple, ...]       # per gather: (col_table, image_name, C)
    slot_images: Tuple[str, ...]         # slot i -> image name
    slot_channels: Tuple[int, ...]       # slot i -> channel count
    image_shapes: dict                   # image name -> full array shape
    col_row: Tuple[int, ...]             # col table -> owning row table
    oh_idxs: Tuple[Optional[torch.Tensor], ...]  # per slot: [R] int32 ids (one-hot) or None

    def slot_onehot(self, i: int) -> bool:
        return self.slot_row[i] < 0


def _repeat_width(idx: np.ndarray, N: int) -> int:
    """W when idx == repeat(arange(N), W), else 0."""
    R = idx.shape[0]
    if N <= 0 or R % N:
        return 0
    W = R // N
    if not np.array_equal(idx.reshape(N, W), np.broadcast_to(np.arange(N)[:, None], (N, W))):
        return 0
    return W


def build_group_bsr(group, idxs: List[np.ndarray], dtype, device) -> GroupBsr:
    """Build the static tables from the slots' concrete flat indices
    (host side, once per init).  idxs[i] is slot i's [R] element index."""
    jslots = group.uslots
    R = group.R
    slot_N = [int(np.prod([d.size for d in s.image.dims])) for s in jslots]
    nslots = len(jslots)

    onehot = [slot_N[i] <= ONEHOT_ROWS_MAX and R >= 4 * slot_N[i] for i in range(nslots)]
    for i in range(nslots):
        for j in range(nslots):
            if i == j or not (onehot[i] and onehot[j]):
                continue
            if slot_N[i] == slot_N[j] and np.array_equal(idxs[i], idxs[j]):
                continue  # diag pair: pure aggregation, no table needed
            k = i if slot_N[i] > slot_N[j] else j  # demote the larger
            onehot[k] = False

    def _transpose_ok(i, j):
        if onehot[i]:
            return True
        if slot_N[i] > TRANSPOSE_ROWS_MAX or onehot[j]:
            return False
        return (slot_N[i], i) < (slot_N[j], j)

    # row tables keyed by the index array's bytes: full-repeat only
    row_of_slot: List[int] = []
    row_tables: List[np.ndarray] = []
    key_to_row: Dict[bytes, int] = {}
    for i, s in enumerate(jslots):
        if onehot[i]:
            row_of_slot.append(-1)
            continue
        key = idxs[i].tobytes()
        if key not in key_to_row:
            W = _repeat_width(idxs[i], slot_N[i])
            if W < 2:
                raise NotImplementedError(
                    f"slot {s!r}: its index array is not a sorted map with the "
                    "same number (>= 2) of incidences per element; rank-keyed "
                    "row tables (degree skew, unsorted maps) are not ported yet")
            key_to_row[key] = len(row_tables)
            row_tables.append(np.arange(R, dtype=np.int32).reshape(slot_N[i], W))
        row_of_slot.append(key_to_row[key])

    pairs: List[tuple] = []
    col_tables: List[np.ndarray] = []
    col_row_of: List[int] = []
    col_key: Dict[tuple, int] = {}
    gathers: List[tuple] = []
    gather_key: Dict[tuple, int] = {}
    partner_pair: Dict[Tuple[int, int], int] = {}
    transpose_todo: List[Tuple[int, int]] = []
    for i in range(nslots):
        for j, sj in enumerate(jslots):
            if slot_N[i] == slot_N[j] and np.array_equal(idxs[i], idxs[j]):
                pairs.append((i, j, "diag"))
                continue
            if _transpose_ok(i, j):
                transpose_todo.append((i, j))
                continue
            t = row_of_slot[i]
            ck = (t, idxs[j].tobytes())
            if ck not in col_key:
                col_key[ck] = len(col_tables)
                col_tables.append(np.ascontiguousarray(idxs[j][row_tables[t]].T))
                col_row_of.append(t)
            gk = (col_key[ck], sj.image.name)
            if gk not in gather_key:
                gather_key[gk] = len(gathers)
                gathers.append((col_key[ck], sj.image.name, sj.image.channels))
            partner_pair[(i, j)] = len(pairs)
            pairs.append((i, j, "col", gather_key[gk]))
    for (i, j) in transpose_todo:
        pairs.append((i, j, "transpose", partner_pair[(j, i)]))
    with_partner = {pr[3] for pr in pairs if pr[2] == "transpose"}
    lone = [pr for p, pr in enumerate(pairs) if pr[2] == "col" and p not in with_partner]
    if lone:
        raise NotImplementedError(
            f"cross pairs {lone} have no transpose partner; only the fused "
            "col+transpose form is ported")

    shapes = {s.image.name: tuple(d.size for d in s.image.dims) + (s.image.channels,)
              for s in jslots}
    # _repeat_width checked that every (n, w) lane of a row table holds an
    # observation of element n, so the masks are all ones and the setup
    # kernel never reads them (thallo_tpu's fused setup does not either)
    masks = [np.ones(p.shape, np.float32) for p in row_tables]
    dev = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(device)  # noqa: E731
    return GroupBsr(
        perms=tuple(dev(p) for p in row_tables),
        masks=tuple(dev(m, dtype) for m in masks),
        cols=tuple(dev(c) for c in col_tables),
        slot_row=tuple(row_of_slot),
        pairs=tuple(pairs),
        col_gathers=tuple(gathers),
        slot_images=tuple(s.image.name for s in jslots),
        slot_channels=tuple(s.image.channels for s in jslots),
        image_shapes=shapes,
        col_row=tuple(col_row_of),
        oh_idxs=tuple(dev(idxs[i].astype(np.int32)) if onehot[i] else None
                      for i in range(nslots)),
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


def bsr_setup(bsr: GroupBsr, rT, jTs):
    """Once per nonlinear iteration: JᵀF, diag(JᵀJ) and every pair's
    blocks.  rT [rc, R], jTs per slot [rc, C, R] (channel-major, as
    point_jacobians_cm makes them).  Returns (jtr, d2, blocks): jtr/d2
    map image -> [*imshape], blocks map pair idx -> [Ci*Cj, N] (diag) or
    [W*Ci*Cj, N_t] w-major (col pairs; transpose pairs store nothing)."""
    rc, R = rT.shape
    rT = rT.contiguous()
    jtr_out: Dict[str, torch.Tensor] = {}
    d2_out: Dict[str, torch.Tensor] = {}
    blocks: Dict[int, torch.Tensor] = {}

    def add(out, name, v):
        out[name] = out[name] + v if name in out else v

    def scatter_slabs(agg, specs):
        off = 0
        for kind, key, width in specs:
            v = agg[off:off + width]
            if kind == "pair":
                blocks[key] = v  # [Ci*Cj, N] diag block
            else:
                name = bsr.slot_images[key]
                add(jtr_out if kind == "jtr" else d2_out, name,
                    v.T.reshape(bsr.image_shapes[name]))
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
        recipe = []
        for kind, key, _ in specs:
            if kind == "pair":
                a, b = bsr.pairs[key][0], bsr.pairs[key][1]
                recipe.append(("pair", offs[a], bsr.slot_channels[a], offs[b], bsr.slot_channels[b]))
            else:
                recipe.append((kind, offs[key], bsr.slot_channels[key]))
        N = int(np.prod(bsr.image_shapes[bsr.slot_images[i]][:-1]))
        agg = oh_setup_products(rT, Jall, bsr.oh_idxs[i], N=N, recipe=tuple(recipe))
        scatter_slabs(agg, specs)

    # ---- full-repeat row tables: one setup pass per table ---------------
    for t, perm in enumerate(bsr.perms):
        N_t, W = perm.shape
        specs, slots = [], []
        for i in range(len(bsr.slot_images)):
            if bsr.slot_row[i] == t:
                specs += [("jtr", i, bsr.slot_channels[i]), ("d2", i, bsr.slot_channels[i])]
        for p, pr in enumerate(bsr.pairs):
            if pr[2] != "transpose" and bsr.slot_row[pr[0]] == t:
                specs.append(("pair", p, bsr.slot_channels[pr[0]] * bsr.slot_channels[pr[1]]))
        for kind, key, _ in specs:
            for s in ((bsr.pairs[key][0], bsr.pairs[key][1]) if kind == "pair" else (key,)):
                if s not in slots:
                    slots.append(s)
        Jall, offs = _stack_slots(jTs, slots, rc, R)
        recipe, agg_specs, cross_keys = [], [], []
        for kind, key, width in specs:
            if kind != "pair":
                recipe.append((kind, offs[key], bsr.slot_channels[key]))
                agg_specs.append((kind, key, width))
                continue
            a, b = bsr.pairs[key][0], bsr.pairs[key][1]
            ab = (offs[a], bsr.slot_channels[a], offs[b], bsr.slot_channels[b])
            if bsr.pairs[key][2] == "diag":
                recipe.append(("diag",) + ab)
                agg_specs.append(("pair", key, width))
            else:
                recipe.append(("cross",) + ab + (len(cross_keys),))
                cross_keys.append(key)
        agg, crosses = fullrepeat_setup(rT, Jall, W=W, N_t=N_t, recipe=tuple(recipe))
        scatter_slabs(agg, agg_specs)
        for key, blk in zip(cross_keys, crosses):
            blocks[key] = blk
    return jtr_out, d2_out, blocks


def bsr_apply(bsr: GroupBsr, blocks, p):
    """JᵀJ·p for this group from the assembled blocks.  Diagonal pairs are
    a per-element block matvec; each col pair and its transpose partner
    run through one fused kernel launch.  p: dict image -> [*imshape].
    Returns dict image -> [*imshape] contribution."""
    pT = {img: p[img].reshape(-1, p[img].shape[-1]).T.contiguous()
          for img in set(bsr.slot_images)}
    acc: Dict[int, torch.Tensor] = {}

    def add(i, v):
        acc[i] = acc[i] + v if i in acc else v

    for p_idx, pr in enumerate(bsr.pairs):
        i, j, kind = pr[0], pr[1], pr[2]
        Ci, Cj = bsr.slot_channels[i], bsr.slot_channels[j]
        if kind == "transpose":
            continue  # computed with its partner col pair
        if kind == "diag":
            B = blocks[p_idx].reshape(Ci, Cj, -1)
            add(i, (B * pT[bsr.slot_images[j]][None]).sum(1))
            continue
        ct = bsr.col_gathers[pr[3]][0]
        img_j = bsr.slot_images[j]
        rows, cols = fused_pair_apply(
            bsr.cols[ct], blocks[p_idx], pT[img_j], pT[bsr.slot_images[i]],
            Ci=Ci, Cj=Cj, S=pT[img_j].shape[1])
        add(i, rows)
        add(j, cols)
    out: Dict[str, torch.Tensor] = {}
    for i, v in acc.items():
        name = bsr.slot_images[i]
        v = v.T.reshape(bsr.image_shapes[name])
        out[name] = out[name] + v if name in out else v
    return out
