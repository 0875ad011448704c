"""Autoscheduler: choose each residual group's JᵀJ·p schedule (counterpart
of ``thallo_tpu/schedule.py``).

The same energy can apply JᵀJ·p inline, from materialized point
Jacobians, or from a materialized JᵀJ, chosen per residual group.  The
plan's ``use_autoscheduler`` picks how (plan.py):

  1   heuristic: merge same-domain groups, decide each computed array's
      materialization, pick each group's schedule from the bytes-moved
      model below (or from recorded measurements, which take precedence),
      reorder external domains (measured, else the analytic prefix rule),
      record compute_at_output;
  2   clear every directive: LINEARIZE everywhere;
  >=3 exhaustive candidate use_autoscheduler - 3 over merge/split x the
      computed-array powerset x schedule combinations x domain orders.

The model and every decision rule are JAX's, function for function, so a
group gets the same estimate and the same choice in both packages when
both run on the same machine constants.  The constants are the H100's:
each below gives the card it was measured on and the script that
measured it (``scripts/torch_schedule_constants.py``).  A row cost is the
time of one row of the port's gather or scatter at a main-path shape,
expressed as the bytes the card would stream in that time at
HBM_BYTES_PER_S, so that it adds to the traffic model.
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Dict, List

import numpy as np

from .spec import JTJpSchedule

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit), the data sheet's memory
# rate (the bound PERF.md uses for every kernel) and the card's memory
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9

DENSE_JTJ_MAX_UNKNOWNS = 4096  # smaller problems materialize JᵀJ densely

# Row costs of the port's scatter (index_add_ by row of a channel-major
# [C, M] buffer) and gather (index_select of [C, N] at M ids), as
# equivalent streamed bytes at HBM_BYTES_PER_S (time per row x 3.35e12),
# measured by scripts/torch_schedule_constants.py on an NVIDIA H100 80GB
# HBM3 at 700.00 W (power limit).  The model charges one cost per row of
# every gathered unknown slot, whatever its image, so each constant is the
# mean over the graph slots of the two graph workloads at full size, each
# slot weighted alike: index_add_ 1954 B/row at BA 1M's [9, 1M] into 1024
# cameras (0.5833 ms: every row lands on one of 1024 hot rows), 61 at
# [3, 1M] into 250 000 points, 50 and 84 at ARAP 256²'s [3, 261 120] into
# 65 536 vertices (V0, V1) -> 538; index_select 99, 41, 128, 130 -> 99.
# A constant from one slot alone would misprice the others by up to 39x.
SCATTER_ROW_EQ_BYTES = 538
GATHER_ROW_EQ_BYTES = 99

# the rate at which the port's eager elementwise code evaluates expression
# nodes (one torch op over [N] f32 per node): 32 ops over [1M] f32 in
# 0.3776 ms, measured by the same script on the same NVIDIA H100 80GB HBM3
# at 700.00 W; what recomputing an inlined computed array costs per op and
# element
EFFECTIVE_ELEMENTWISE_FLOPS = 8.5e10


def _group_stats(gp, dtype_bytes=4):
    """Traffic building blocks for one lowered group."""
    g = gp.group
    R = g.R
    rc = g.rc
    slot_ch = 0
    gather_bytes = 0
    scatter_slots = 0  # slots needing a real (non-roll) scatter transpose
    pair_ch = 0  # sum over slot pairs of Ci*Cj (block-sparse JᵀJ payload)
    chans = []
    for i, s in enumerate(g.uslots):
        dep = int(np.prod([d.dim.size for d in s.dep_cons])) if s.dep_cons else 1
        slot_ch += dep * s.image.channels
        gather_bytes += R * dep * s.image.channels * dtype_bytes
        if not s.dep_cons and g._rolls[i] is None:
            scatter_slots += 1
        chans.append(s.image.channels)
    for ci in chans:
        for cj in chans:
            pair_ch += ci * cj
    const_bytes = 0
    for s in g.cslots:
        dep = int(np.prod([d.dim.size for d in s.dep_cons])) if s.dep_cons else 1
        const_bytes += R * dep * s.image.channels * dtype_bytes
    res_bytes = R * rc * dtype_bytes
    unknown_elems = sum(
        int(np.prod([d.size for d in s.image.dims])) * s.image.channels
        for s in {id(s.image): s for s in g.uslots}.values()
    )
    return {
        "R": R,
        "rc": rc,
        "slot_ch": slot_ch,
        "gather_bytes": gather_bytes,
        "const_bytes": const_bytes,
        "res_bytes": res_bytes,
        "jblock_bytes": R * rc * slot_ch * dtype_bytes,
        "unknown_elems": unknown_elems,
        "scatter_slots": scatter_slots,
        "pair_block_bytes": R * pair_ch * dtype_bytes,
    }


def estimate_group_cost(gp, schedule: JTJpSchedule, lin_iter_hint: int = 10,
                        dtype_bytes: int = 4):
    """(per_solve_iteration_bytes, resident_bytes).  Per solve iteration:
    the setup's traffic + lin_iter_hint times one PCG iteration's, the
    reference's nonlinear + lin_iter_hint * linear decomposition."""
    st = _group_stats(gp, dtype_bytes)
    # every forward/tangent/cotangent pass pays the per-row gather cost
    # once per non-roll slot access
    fwd = (st["gather_bytes"] + st["const_bytes"] + st["res_bytes"]
           + st["scatter_slots"] * st["R"] * GATHER_ROW_EQ_BYTES)
    # per-apply scatter/gather row costs of graph slots (zero for pure
    # stencil groups, whose transposes are rolls back)
    scat = st["scatter_slots"] * st["R"] * SCATTER_ROW_EQ_BYTES
    gath = st["scatter_slots"] * st["R"] * GATHER_ROW_EQ_BYTES
    setup = 0.0
    resident = 0.0
    if schedule == JTJpSchedule.INLINE:
        # jvp (fwd + tangent) + vjp (fwd + cotangent) every iteration
        per_iter = 4.0 * fwd + scat + gath
    elif schedule == JTJpSchedule.LINEARIZE:
        # the linearization ~ one fwd's intermediates; apply + transpose
        # each touch them plus the slot-aligned tangents
        setup = fwd
        per_iter = 2.0 * fwd + scat + gath
        resident = fwd
    elif schedule in (JTJpSchedule.PRECOMPUTE_J, JTJpSchedule.APPLY_SEPARATELY):
        setup = fwd + st["jblock_bytes"]
        per_iter = 2.0 * (st["jblock_bytes"] + st["gather_bytes"]) + st["res_bytes"] + scat + gath
        resident = st["jblock_bytes"]
    elif schedule in (JTJpSchedule.PRECOMPUTE_JTJ, JTJpSchedule.PRECOMPUTE_J_THEN_JTJ):
        n = st["unknown_elems"]
        if n > DENSE_JTJ_MAX_UNKNOWNS:
            if st["scatter_slots"]:
                # block-sparse JᵀJ (solver/blocksparse.py): the setup
                # assembles the pair-block payload once; each PCG step
                # reads the blocks + col gathers, no scatter
                payload = st["pair_block_bytes"]
                setup = fwd + 3.0 * payload + st["R"] * GATHER_ROW_EQ_BYTES
                per_iter = payload + gath
                resident = payload
            else:
                # stencil group: point Jacobians instead of tables
                setup = fwd + st["jblock_bytes"]
                per_iter = 2.0 * (st["jblock_bytes"] + st["gather_bytes"])
                resident = st["jblock_bytes"]
        else:
            dense = n * n * dtype_bytes
            setup = fwd + st["jblock_bytes"] + dense
            per_iter = dense  # one matrix-vector product per iteration
            resident = dense
    else:
        per_iter = 4.0 * fwd + scat + gath
    return setup + lin_iter_hint * per_iter, resident


CANDIDATES = [
    JTJpSchedule.LINEARIZE,
    JTJpSchedule.INLINE,
    JTJpSchedule.PRECOMPUTE_J,
    JTJpSchedule.PRECOMPUTE_JTJ,
    JTJpSchedule.APPLY_SEPARATELY,
]


def _expr_op_count(exprs):
    """Approximate operation count of an expression DAG (distinct Apply
    and Reduction nodes)."""
    from .expr import Apply, Reduction

    seen = set()
    n = 0
    stack = list(exprs)
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, Apply):
            n += 1
            stack.extend(e.args)
        elif isinstance(e, Reduction):
            n += 1
            stack.append(e.arg)
    return n


def _ca_uses(spec, ca):
    """Distinct access sites of a computed array across all residual
    expressions and the other computed arrays (before inlining)."""
    from .expr import Apply, ImageAccess, Reduction, SampleAccess

    sites = set()
    stack = []
    if spec.energy is not None:
        for nr in spec.energy:
            stack.extend(nr.exprs)
    for other in spec.computed:
        if other is not ca:
            stack.extend(other.expression)
    seen = set()
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, Apply):
            stack.extend(e.args)
        elif isinstance(e, Reduction):
            stack.append(e.arg)
        elif isinstance(e, SampleAccess):
            stack.extend(e.coords)
        elif isinstance(e, ImageAccess) and e.image is ca:
            sites.add(e.comps)
    return len(sites)


def select_ca_materialization(spec, log=None):
    """Greedy materialize-or-inline choice per computed array (the
    reference's select_expressions_to_materialize): materialize when
    recomputing the expression at every access site costs more time than
    writing the array once and reading it at each site.  Sets each computed
    image's .materialize flag; returns name -> decision."""
    decisions = {}
    for ca in spec.computed:
        ops = _expr_op_count(ca.expression)
        uses = _ca_uses(spec, ca)
        dom = 1
        for d in ca.dims:
            dom *= d.size if d.size else 1
        c = ca.channels
        # an inlined array is evaluated again by every derivative pass too
        # (forward + one jvp per slot channel + vjp), hence the 3x
        inline_t = 3.0 * max(uses - 1, 0) * ops * dom * c / EFFECTIVE_ELEMENTWISE_FLOPS
        # written once + read at each use
        mat_t = (1 + uses) * dom * c * 4 / HBM_BYTES_PER_S
        mat = uses >= 2 and inline_t > mat_t
        ca.materialize = mat
        decisions[ca.name] = mat
        if log is not None:
            log.append(
                f"  ca {ca.name}: ops={ops} uses={uses} "
                f"inline_t={inline_t:.3g}s mat_t={mat_t:.3g}s -> "
                f"{'materialize' if mat else 'inline'}"
            )
    return decisions


def measurements_path():
    """The measurement store: THALLO_MEASUREMENTS, as thallo_tpu reads it."""
    return os.environ.get("THALLO_MEASUREMENTS", "schedule_measurements.json")


def group_measure_key(gp, schedule, order=None) -> str:
    """Key of a measured schedule timing: group shape + slots + schedule,
    the same string thallo_tpu builds for the same group.  A non-default
    external-domain order adds an `_ord` suffix; pass `order` to build the
    key a hypothetical reorder would measure under."""
    g = gp.group
    slots = ",".join(
        f"{s.image.channels}ch{'x' + str(len(s.dep_cons)) if s.dep_cons else ''}"
        f"{'roll' if g._rolls[i] is not None else 'gather'}"
        for i, s in enumerate(g.uslots)
    )
    key = f"R{g.R}_rc{g.rc}_[{slots}]"
    if order is None and g.reordered:
        order = g.domain_order
    if order is not None:
        key += "_ord" + ">".join(_domain_labels(order))
    return f"{key}_{schedule.value}"


def _domain_labels(doms):
    """Stable labels for an external-domain order: Dim names, with an
    occurrence rank where one Dim appears twice (rank = declaration order,
    which the source fixes)."""
    by_dim: Dict[str, list] = {}
    for d in doms:
        by_dim.setdefault(d.dim.name, []).append(d)
    labels = []
    for d in doms:
        same = by_dim[d.dim.name]
        if len(same) == 1:
            labels.append(d.dim.name)
        else:
            rank = sorted(same, key=lambda x: x.uid).index(d)
            labels.append(f"{d.dim.name}#{rank}")
    return labels


def _slot_ext_deps(g, slot):
    """External domains a slot's index expressions depend on."""
    deps = []
    for c in slot.comps:
        for d in c.domains():
            if d in g.ext_domains and d not in deps:
                deps.append(d)
    return deps


def _slot_is_sparse(slot):
    """True when any index component routes through a sparse map (an
    AffineComp term whose base is a SparseComp, possibly nested)."""
    from .dims import IndexDomain, SparseComp

    def affine_sparse(c):
        return any(
            isinstance(b, SparseComp)
            or (not isinstance(b, IndexDomain)
                and any(affine_sparse(a) for a in getattr(b, "args", ())))
            for b, _ in c.terms)

    return any(affine_sparse(c) for c in slot.comps)


def analytic_domain_orders(groups, schedules, log=None):
    """Cold-start reorder for the heuristic (the reference's
    reorder_for_coherence): the external order decides the row-major
    flattening of the residual domain, and with a sparse slot's dependent
    domains leading it, the slot's flat index array repeats each id over a
    contiguous block (sorted runs for the segment sum, run-structured
    tables for the block-sparse setup).  Prefer the order where each sparse
    unknown slot's dependent domains form a prefix, weighting slots by
    channel count.  None per group keeps the discovery order."""
    out = []
    for gp, sched in zip(groups, schedules):
        g = gp.group
        doms = list(g.ext_domains)
        choice = None
        if 2 <= len(doms) <= 3 and not g.reordered:
            slots = [s for s in list(g.uslots) + list(g.mslots)
                     if _slot_is_sparse(s)]
            deps = [(set(_slot_ext_deps(g, s)), s.image.channels)
                    for s in slots]

            def cost(order):
                c = 0
                for dset, w in deps:
                    if not dset or len(dset) == len(order):
                        continue  # order-independent
                    if set(order[:len(dset)]) != dset:
                        c += w  # dependent domains not leading
                return c

            base = cost(doms)
            best = base
            for p in itertools.permutations(doms):
                lp = list(p)
                if lp == doms:
                    continue
                cp = cost(lp)
                if cp < best:
                    choice, best = lp, cp
            if log is not None and choice is not None:
                log.append(
                    f"  {gp.name}: analytic reorder "
                    + ">".join(_domain_labels(choice))
                    + f" (sparse-slot prefix score {best} < {base})")
        out.append(choice)
    return out


def choose_compute_at_output(groups, schedules, log=None):
    """The reference's choose_compute_at_output: a matrix-free group
    (INLINE, LINEARIZE) whose every unknown's dims equal the residual's
    full iteration domain iterates over output elements.  Here such a
    group's accesses are grid offsets whose transposes are rolls back, so
    the residual-wise and output-wise forms are the same program; the
    decision is made and recorded (gp.compute_at_output)."""
    for gp, sched in zip(groups, schedules):
        g = gp.group
        cao = sched in (JTJpSchedule.INLINE, JTJpSchedule.LINEARIZE)
        if cao:
            for s in list(g.uslots):
                dims = tuple(im for im in s.image.dims)
                full = tuple(d.dim for d in g.ext_domains)
                if dims != full:
                    cao = False
                    break
        gp.compute_at_output = cao
        if log is not None and cao:
            log.append(f"  {gp.name}: compute_at_output (unknown dims == "
                       "residual domain; lowers to inverse rolls)")
    return [gp.compute_at_output for gp in groups]


def select_measured_domain_orders(groups, schedules, log=None):
    """Measured-feedback reorder for the heuristic: per group, the
    external-domain order whose recorded timing (autotune.py writes them
    over the exhaustive order enumeration) beats the default order's, or
    None to keep the discovery order."""
    measured = load_measurements()
    out = []
    for gp, sched in zip(groups, schedules):
        g = gp.group
        doms = list(g.ext_domains)
        choice = None
        if 2 <= len(doms) <= 3 and not g.reordered:
            base = measured.get(group_measure_key(gp, sched))
            best_t = base
            for p in itertools.permutations(doms):
                if list(p) == doms:
                    continue
                t = measured.get(group_measure_key(gp, sched, order=p))
                if t is not None and (best_t is None or t < best_t):
                    choice, best_t = list(p), t
            if log is not None and choice is not None:
                log.append(
                    f"  {gp.name}: measured reorder "
                    + ">".join(_domain_labels(choice))
                    + f" {best_t * 1e3:.3f}ms beats default"
                    + (f" {base * 1e3:.3f}ms" if base is not None else " (unmeasured)")
                )
        out.append(choice)
    return out


def load_measurements():
    """The measurement store's key -> seconds; {} when it is missing or
    unreadable."""
    p = measurements_path()
    if os.path.exists(p):
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}
    return {}


def record_measurement(key: str, seconds: float):
    """Keep the fastest timing seen under key in the store."""
    data = load_measurements()
    prev = data.get(key)
    data[key] = min(prev, seconds) if prev is not None else seconds
    try:
        with open(measurements_path(), "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
    except OSError:
        pass


def default_schedule(g) -> JTJpSchedule:
    """The default of an unscheduled group: graph groups (any unknown slot
    gathered through a sparse map, no contraction) materialize JᵀJ
    block-sparse, which keeps scatters out of the PCG loop; stencil and
    contraction groups run matrix-free (LINEARIZE)."""
    if (g.uslots and not g.con_domains and all(not s.dep_cons for s in g.uslots)
            and g.has_gathers):
        return JTJpSchedule.PRECOMPUTE_JTJ
    return JTJpSchedule.LINEARIZE


def heuristic_schedule(groups, lin_iter_hint: int = 10, dtype_bytes: int = 4,
                       log=None) -> List[JTJpSchedule]:
    """The cheapest feasible schedule per group (the reference's
    select_jtjp_materialization).  Recorded timings (autotune.py writes
    them, keyed by group shape + schedule) rank a group's candidates ahead
    of the estimate: measured candidates first, by time, then the rest by
    estimated bytes."""
    budget = 0.6 * HBM_BYTES
    measured = load_measurements()
    chosen = []
    for gp in groups:
        best, best_cost = None, float("inf")
        for cand in CANDIDATES:
            cost, resident = estimate_group_cost(gp, cand, lin_iter_hint, dtype_bytes)
            if resident > budget:
                continue
            key = group_measure_key(gp, cand)
            m = measured.get(key)
            if log is not None:
                log.append(
                    f"  {gp.name}: {cand.value} est_bytes={cost:.3g} "
                    f"resident={resident:.3g}"
                    + (f" measured={m * 1e3:.3f}ms" if m is not None else "")
                )
            score = (0, m) if m is not None else (1, cost)
            if best is None or score < best_cost:
                best, best_cost = cand, score
        chosen.append(best or JTJpSchedule.INLINE)
        if log is not None:
            log.append(f"  {gp.name} -> {chosen[-1].value}")
    return chosen


def enumerate_domain_orders(groups, max_per_group: int = 6, max_total: int = 16):
    """Per-group external-domain orders for the exhaustive autoscheduler.
    Entry 0 is all-default (None); only groups with 2-3 external domains
    contribute permutations."""
    per_group = []
    for gp in groups:
        doms = list(gp.group.ext_domains)
        opts = [None]
        if 2 <= len(doms) <= 3:
            for p in itertools.permutations(doms):
                if list(p) != doms and len(opts) < max_per_group:
                    opts.append(list(p))
        per_group.append(opts)
    out = []
    for combo in itertools.product(*per_group):
        out.append(list(combo))
        if len(out) >= max_total:
            break
    return out


def enumerate_schedules(groups, max_candidates: int = 2000, seed: int = 0):
    """Per-group schedule combinations within the memory budget; beyond
    max_candidates, a sample of distinct combination indices drawn by
    numpy's RandomState(seed) (thallo_tpu draws the same), decoded without
    materializing the product."""
    n = len(CANDIDATES)
    G = len(groups)
    total = n ** G if G else 0

    def decode(ix):
        # mixed-radix decode: candidate index -> per-group schedule combo
        combo = []
        for _ in range(G):
            combo.append(CANDIDATES[ix % n])
            ix //= n
        return combo

    if total > max_candidates:
        rng = np.random.RandomState(seed)
        seen = set()
        while len(seen) < max_candidates:
            seen.add(int(rng.randint(0, min(total, 2**62))))
        combos = (decode(i) for i in sorted(seen))
    else:
        combos = (list(c) for c in itertools.product(*[CANDIDATES] * G))
    out = []
    budget = 0.6 * HBM_BYTES
    for combo in combos:
        resident = sum(estimate_group_cost(gp, s)[1] for gp, s in zip(groups, combo))
        if resident <= budget:
            out.append(list(combo))
    return out
