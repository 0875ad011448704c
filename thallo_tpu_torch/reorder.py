"""Automatic residual-domain reordering (init-time, host side): a copy of
``thallo_tpu/reorder.py`` (numpy only, over the port's own ``dims.py``
and lowered groups, whose unknown slots are ``uslots``).

Graph energies are sums over an unordered residual domain (edges,
observations): relabeling that domain never changes the energy, only the
memory-access pattern of every kernel that iterates it.  Real scenes
arrive in arbitrary order (BAL files, shuffled edge lists), which forces
the block-sparse setup onto per-index gather paths (~8 cycles/index,
PERF.md "the per-index gather floor").  Sorting the domain by the
highest-traffic sparse map at init turns those gathers into contiguous
run reads (solver/blocksparse.py sorted-run tables) at zero per-step
cost.

The reference gets the same effect from its `coherent` access hint
(Sparse set_coherent, API/src/thallo.t:1950-1989: sorted
edges -> warp-coherent loads) but leaves the sorting to the user;
here the framework proves the relabeling is invisible and applies it.

Safety: a dim D is ORDER-FREE iff relabeling its index space is
unobservable through the problem spec:
  * no unknown image is indexed over D (unknown values are user-visible
    in D's order),
  * no sparse map TARGETS D (its stored indices would dangle),
  * every access component that involves an iteration domain over D is
    the identity (a stencil offset `o+1` or strided access would read
    across the relabeling),
  * no IndexValue over D (the numeric index feeds the energy, e.g.
    optical_flow's pixel coordinates),
  * D is never a contraction domain (blocked contractions slice it).

Arrays and sparse maps indexed BY D are permuted consistently at bind
time, so the residual multiset — and therefore every cost/gradient —
is bit-identical up to float reassociation of the final reductions.
Tests: tests/test_reorder.py pins sorted-vs-shuffled equivalence.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .dims import AffineComp, IndexDomain, SparseComp


def _comp_identity_over(comp: AffineComp, dim_name: str) -> bool:
    """True when `comp` either doesn't involve dim_name at all, or is
    exactly one identity reference to a domain over it (coeff 1, offset
    0, no other terms).  Sparse-map args are checked recursively: the
    map's rows get permuted with the domain, so identity args stay
    consistent."""
    touches = False
    for base, coeff in comp.terms:
        if isinstance(base, IndexDomain):
            if base.dim.name == dim_name:
                touches = True
                if coeff != 1:
                    return False
        elif isinstance(base, SparseComp):
            for arg in base.args:
                if not _comp_identity_over(arg, dim_name):
                    return False
            # the sparse VALUE never equals the in-domain index space of
            # dim_name unless the map targets D (rejected separately)
    if touches:
        return len(comp.terms) == 1 and comp.offset == 0
    return True


def _group_accesses_ok(group, dim_name: str) -> bool:
    col = group.col
    for slot in list(col.uslots.values()) + list(col.cslots.values()) + \
            list(col.mslots.values()):
        for comp in slot.comps:
            if not _comp_identity_over(comp, dim_name):
                return False
    for b in col.bounds.values():
        for comp in b.comps:
            if not _comp_identity_over(comp, dim_name):
                return False
    for iv in col.ivals.values():
        # the numeric value of an index over D is order-sensitive
        for base, _ in iv.comp.terms:
            if isinstance(base, IndexDomain) and base.dim.name == dim_name:
                return False
            if isinstance(base, SparseComp):
                # value of a gathered index is permutation-INVARIANT as
                # long as its args are identity over D (the same rows are
                # read, in permuted order)
                if not all(_comp_identity_over(a, dim_name) for a in base.args):
                    return False
    for d in col.con_domains:
        if d.dim.name == dim_name:
            return False
    return True


def order_free(spec, groups, dim_name: str) -> bool:
    """Is dim `dim_name` safe to relabel for this spec + lowered groups?"""
    for im in spec.unknowns:
        if any(d.name == dim_name for d in im.dims):
            return False
    for sm in spec.sparse_maps:
        if any(d.name == dim_name for d in sm.out_dims):
            return False
        # multi-input-dim maps are stored flattened: permuting one axis
        # of the flattened index storage is ambiguous — don't sort
        if len(sm.in_dims) > 1 and any(d.name == dim_name for d in sm.in_dims):
            return False
    for g in groups:
        if not _group_accesses_ok(g, dim_name):
            return False
        for _, sub, _ in getattr(g, "computed_groups", {}).values():
            if not _group_accesses_ok(sub, dim_name):
                return False
    return True


def choose_sort_keys(spec, groups, inputs, wants_bsr) -> Dict[str, np.ndarray]:
    """Pick, per order-free single-domain residual dim, the sparse map to
    sort by: the map targeting the LARGEST image among the group's
    unknown accesses whose concrete index array is neither sorted nor
    affine-structured (sorted or structured maps already have a zero-
    per-index path; sorting would only destroy affine structure).

    Returns {dim_name: int64 permutation} — empty when nothing gains.
    `groups` here are the lowered jac-groups that will take the BSR path
    (wants_bsr(g) true)."""
    from .ops import structured

    perms: Dict[str, np.ndarray] = {}
    checked_safe: Dict[str, bool] = {}
    # largest-R groups first: they set the traffic
    for g in sorted(groups, key=lambda gg: -gg.R):
        if len(g.ext_domains) != 1:
            continue
        dname = g.ext_domains[0].dim.name
        if dname in perms:
            continue
        if not wants_bsr(g):
            continue
        # the LARGEST-image slot drives the sort: sorting by a smaller
        # side would destroy whatever order the big side already has
        # (e.g. a point-sorted BA scene must not re-sort by camera; the
        # small side has the one-hot/transpose-apply path instead)
        cands = []
        for s in g.uslots:
            try:
                idx = np.asarray(g._slot_flat_indices(s, inputs)).reshape(-1)
            except Exception:  # traced / missing inputs: not concrete
                return {}
            if idx.size != g.R:
                continue
            n = int(np.prod([d.size for d in s.image.dims]))
            cands.append((n, idx))
        if not cands:
            continue
        best_n, best = max(cands, key=lambda t: t[0])
        if np.all(np.diff(best) >= 0):
            continue  # already sorted: zero-cost path exists
        segs = (structured.detect_segments_cached(best)
                if structured.enabled() else None)
        if structured.normalize_segments(segs) is not None:
            continue  # affine-structured: sorting would destroy it
        if dname not in checked_safe:
            # safety must hold across EVERY group touching the dim, not
            # just the BSR candidates (another group might stencil it)
            checked_safe[dname] = order_free(g.spec, groups, dname)
        if not checked_safe[dname]:
            continue
        perms[dname] = np.argsort(best, kind="stable").astype(np.int64)
    return perms


def apply_perms(spec, inputs, perms: Dict[str, np.ndarray]) -> dict:
    """Permute every input indexed over a relabeled dim (leading-dims
    layout: arrays [*, dims..., C] — relabeled dims are always the sole
    leading dim here since only single-domain residual ispaces sort)."""
    if not perms:
        return inputs
    out = dict(inputs)
    for sm in spec.sparse_maps:
        if len(sm.in_dims) == 1 and sm.in_dims[0].name in perms:
            p = perms[sm.in_dims[0].name]
            out[sm.name] = np.asarray(inputs[sm.name])[p]
    for im in spec.arrays:
        if im.name not in inputs:
            continue
        a = None
        for axis, d in enumerate(im.dims):
            if d.name in perms:
                if a is None:
                    a = np.asarray(inputs[im.name])
                    # leading channel-less layouts normalize later; take
                    # along the dim axis works for both since dims lead
                a = np.take(a, perms[d.name], axis=axis)
        if a is not None:
            out[im.name] = a
    return out
