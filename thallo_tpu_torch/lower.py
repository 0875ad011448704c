"""Lowering of residual groups to torch (counterpart of
``thallo_tpu/lower.py``).

A group iterates its external domains (the residual points, R of them)
and, inside each ``Sum``, its contracted domains; every image access
becomes a slot.  A stencil access (a grid offset over the image's own
axes, e.g. ``X(x + 1, y)``) is gathered by ``torch.roll`` of the image
with torus wrap, as the JAX package's ``_roll_plan`` does, and scattered
by the roll back; every other access, and every access over a contracted
domain, gathers by flat element indices evaluated once, on the host,
from the concrete sparse maps.  ``InBounds`` and index values become
[R] (over contracted domains [R, *con]) f32 arrays at ``prepared_consts``
(JAX's barrs and iarrs).  The residual is evaluated CHANNEL-MAJOR: each
unknown slot is ``[C, R]`` (``[C, R, *dep]`` over contracted domains)
and every DAG op runs elementwise over the R residual points, so the
batch axis is written out and no ``vmap`` is needed; a ``Sum`` sums its
contracted axes.  Point Jacobians come from ``torch.func.vjp`` (one
cotangent per residual channel) or ``torch.func.jvp`` (one tangent per
unknown channel, batched by ``torch.func.vmap``), by JAX's rule: reverse
mode where 2 * rc is below the unknown channels, or where a slot runs
over contracted domains.

Sampled images (``SampledImage``, ``SampledImageArray``, the conditional
array sample) sample in the local function (``ops/sampling.py``).
Materialized computed arrays are sub-groups over their own domains whose
values are gathered at each access; their Jacobians compose through the
arrays' gradient arrays (``jac_slots``).  A group whose unblocked fiber
exceeds ``THALLO_CON_BLOCK_BYTES``, or that a ``split(domain, B)``
directive asks to, runs its Sums over blocks of one contracted domain
(``con_block``), one block's fiber at a time, with its derivatives taken
through the Sums' values (``blocked_jtf_diag``, ``blocked_jtjp``).

The schedules that apply JᵀJ·p from stored point Jacobians (PRECOMPUTE_J,
APPLY_SEPARATELY, LINEARIZE) also need the slot gather and its transpose,
the scatter-add of per-point values into the slot's image.
``scatter_slot`` routes a gathered slot as thallo_tpu's ``_scatter`` does
(``lower.py:706-747``): a small image gathered from many points (S <=
1024 and more than 4S values) through a segment sum of a fixed order
(ops/segsum.py, ``fixed_order_plan``) when it has at most
``FIXED_ORDER_MAX_ROWS`` values; else through the destination-tiled
segment sum when ``THALLO_SEGSUM=tiled`` built a plan for the slot at
init; else, for a small image, through ``oh_setup_aggregate``
(ops/ohsetup.py); else through ``index_add_``, the counterpart of
``jax.ops.segment_sum``.
The residual's own gathers of those slots are ``SlotGather``, whose
transpose takes the same route (thallo_tpu's ``gather_with_segsum`` and
``_gather``'s routes, ``lower.py:367-380, 643-690``): the vjp of a graph
residual under INLINE launches the same kernels.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .dims import AffineComp, IndexDomain, SparseComp
from .expr import (
    Apply,
    BoundsAccess,
    Const,
    Exp,
    ImageAccess,
    IndexValue,
    ParamValue,
    Reduction,
    SampleAccess,
)
from .inputs import Image
from .ops.ohsetup import oh_setup_aggregate
from .ops.sampling import (array_bilinear_sample, bilinear_sample, conditional_array_sample,
                           sample_with_deriv_images)
from .ops.segsum import build_plan, segment_sum

ONEHOT_MAX_SEGMENTS = 1024  # thallo_tpu/ops/segsum.py: small-image scatter bound
# a small-image scatter of at most FIXED_ORDER_MAX_ROWS values takes a
# segment-sum plan (ops/segsum.py) whatever THALLO_SEGSUM says: the same
# order of additions every run, where the aggregation kernel's and
# index_add_'s atomics add in another order every run.  The plan sums in
# order (one thread a run, ascending source: the CPU's order, the same
# bits) when no run is longer than IN_ORDER_MAX_RUN values, else in sorted
# runs.  On an H100 the route is within 1 us of index_add_ (its launch
# floor) from [1, 192] -> 4 to [2, 6 400] -> 256 and up to 10x faster at
# 262 144 values; beyond, the aggregation kernel is the fastest
# (scripts/torch_fixed_order_scatter.py; PERF.md)
FIXED_ORDER_MAX_ROWS = 262144
IN_ORDER_MAX_RUN = 32


# ---------------------------------------------------------------------------
# collection: walk the expression DAG (pure Python, as in thallo_tpu)
# ---------------------------------------------------------------------------
class SlotSpec:
    """One distinct (image, index) access in a group: all channels are
    gathered together."""

    def __init__(self, image: Image, comps: Tuple[AffineComp, ...], is_unknown: bool):
        self.image = image
        self.comps = comps
        self.is_unknown = is_unknown
        self.dep_cons: Tuple[IndexDomain, ...] = ()  # filled by finalize

    @property
    def key(self):
        return (id(self.image), self.comps)

    def __repr__(self):
        return f"slot:{self.image.name}({','.join(map(repr, self.comps))})"


class Collection:
    def __init__(self, allow_inline_ca=False):
        # allow_inline_ca: domain discovery over RAW (pre-inlining)
        # expressions — a non-materialized ComputedArray access then
        # contributes its access comps' domains instead of being an
        # error.  Used by expr.get()'s free-domain classification.
        self.allow_inline_ca = allow_inline_ca
        self.ext_domains: List[IndexDomain] = []
        self.con_domains: List[IndexDomain] = []
        self.uslots: Dict = {}  # key -> SlotSpec (unknown images)
        self.cslots: Dict = {}  # key -> SlotSpec (const arrays)
        self.mslots: Dict = {}  # key -> SlotSpec (materialized computed arrays)
        self.bounds: Dict = {}  # key -> BoundsAccess
        self.ivals: Dict = {}  # key -> IndexValue
        self.params: Dict = {}  # name -> Param
        self.sampled: Dict = {}  # name -> SampledImage
        self._seen = set()

    def _domain(self, d: IndexDomain, bound):
        if d in bound:
            if d not in self.con_domains:
                self.con_domains.append(d)
        else:
            if d not in self.ext_domains:
                self.ext_domains.append(d)

    def _comps_domains(self, comps, bound):
        for c in comps:
            for d in c.domains():
                self._domain(d, bound)

    def walk(self, e: Exp, bound: frozenset):
        key = (id(e), bound)
        if key in self._seen:
            return
        self._seen.add(key)
        if isinstance(e, Const):
            return
        if isinstance(e, Apply):
            for a in e.args:
                self.walk(a, bound)
            return
        if isinstance(e, Reduction):
            inner = bound | frozenset(e.domains)
            for d in e.domains:
                if d not in self.con_domains:
                    self.con_domains.append(d)
            self.walk(e.arg, inner)
            return
        if isinstance(e, ImageAccess):
            self._comps_domains(e.comps, bound)
            im = e.image
            if im.kind == "computed":
                if not im.materialize:
                    if self.allow_inline_ca:
                        return  # comps' domains already collected above
                    raise RuntimeError("computed arrays must be inlined before lowering")
                target = self.mslots
            elif im.kind == "unknown":
                target = self.uslots
            else:
                target = self.cslots
            k = (id(im), e.comps)
            if k not in target:
                target[k] = SlotSpec(im, e.comps, im.kind == "unknown")
            return
        if isinstance(e, BoundsAccess):
            self._comps_domains(e.comps, bound)
            k = ("bounds", e.comps, e.dims, e.expand)
            self.bounds.setdefault(k, e)
            return
        if isinstance(e, IndexValue):
            for d in e.comp.domains():
                self._domain(d, bound)
            k = ("ival", e.comp)
            self.ivals.setdefault(k, e)
            return
        if isinstance(e, ParamValue):
            self.params.setdefault(e.param.name, e.param)
            return
        if isinstance(e, SampleAccess):
            for c in e.coords:
                self.walk(c, bound)
            self.sampled.setdefault(e.sampled.name, e.sampled)
            return
        raise TypeError(f"unknown expression node {e!r}")

    def finalize(self):
        conset = set(self.con_domains)
        for slots in (self.uslots, self.cslots, self.mslots):
            for s in slots.values():
                deps = []
                for c in s.comps:
                    for d in c.domains():
                        if d in conset and d not in deps:
                            deps.append(d)
                s.dep_cons = tuple(sorted(deps, key=self.con_domains.index))


# ---------------------------------------------------------------------------
# computed-array inlining (substitution)
# ---------------------------------------------------------------------------
def substitute_index(comp: AffineComp, mapping) -> AffineComp:
    """Affine-compose an index component through a domain substitution."""
    out = AffineComp((), comp.offset)
    for base, coeff in comp.terms:
        if isinstance(base, IndexDomain):
            if base in mapping:
                out = out + coeff * mapping[base]
            else:
                out = out + coeff * AffineComp(((base, 1),), 0)
        else:  # SparseComp: substitute inside args
            new_args = tuple(substitute_index(a, mapping) for a in base.args)
            out = out + coeff * AffineComp(
                ((SparseComp(base.sparse, new_args, base.component), 1),), 0
            )
    return out


def substitute_expr(e: Exp, mapping, cache=None, force_inline=False) -> Exp:
    cache = cache if cache is not None else {}
    if id(e) in cache:
        return cache[id(e)]
    if isinstance(e, Const):
        r = e
    elif isinstance(e, Apply):
        r = Apply(e.op, tuple(substitute_expr(a, mapping, cache, force_inline) for a in e.args))
    elif isinstance(e, Reduction):
        r = Reduction(e.domains, substitute_expr(e.arg, mapping, cache, force_inline))
    elif isinstance(e, ImageAccess):
        comps = tuple(substitute_index(c, mapping) for c in e.comps)
        im = e.image
        if im.kind == "computed" and (force_inline or not im.materialize):
            inner_map = {d: c for d, c in zip(im.domains, comps)}
            r = substitute_expr(im.expression[e.channel], inner_map, {}, force_inline)
        else:
            r = ImageAccess(im, comps, e.channel)
    elif isinstance(e, BoundsAccess):
        r = BoundsAccess(tuple(substitute_index(c, mapping) for c in e.comps), e.dims, e.expand)
    elif isinstance(e, IndexValue):
        r = IndexValue(substitute_index(e.comp, mapping))
    elif isinstance(e, ParamValue):
        r = e
    elif isinstance(e, SampleAccess):
        r = SampleAccess(
            e.sampled, tuple(substitute_expr(c, mapping, cache, force_inline) for c in e.coords),
            e.channel,
        )
    else:
        raise TypeError(f"unknown node {e!r}")
    cache[id(e)] = r
    return r


def inline_computed(exprs: List[Exp], force=False) -> List[Exp]:
    """Expand ComputedArray accesses (all of them when force=True, else
    only the non-materialized ones)."""
    return [substitute_expr(e, {}, {}, force) for e in exprs]


# ---------------------------------------------------------------------------
# op evaluation table (thallo_tpu/lower.py _make_ops, mapped to torch)
# ---------------------------------------------------------------------------
def _as_pred(x):
    return x != 0


def _make_ops(dtype):
    f = lambda b: b.to(dtype)  # noqa: E731
    return {
        "add": torch.add,
        "sub": torch.sub,
        "mul": torch.mul,
        "div": torch.div,
        "pow": torch.pow,
        "neg": torch.neg,
        "abs": torch.abs,
        "sin": torch.sin,
        "cos": torch.cos,
        "tan": torch.tan,
        "asin": torch.asin,
        "acos": torch.acos,
        "atan": torch.atan,
        "sqrt": torch.sqrt,
        "exp": torch.exp,
        "log": torch.log,
        "min": torch.minimum,
        "max": torch.maximum,
        "select": lambda c, a, b: torch.where(_as_pred(c), a, b),
        "eq": lambda a, b: f(a == b),
        "neq": lambda a, b: f(a != b),
        "greater": lambda a, b: f(a > b),
        "greatereq": lambda a, b: f(a >= b),
        "less": lambda a, b: f(a < b),
        "lesseq": lambda a, b: f(a <= b),
        "and": lambda a, b: f(_as_pred(a) & _as_pred(b)),
        "or": lambda a, b: f(_as_pred(a) | _as_pred(b)),
        "not": lambda a: f(~_as_pred(a)),
        "constant": lambda a: a.detach(),
    }


# ---------------------------------------------------------------------------
# index evaluation over a (sub)grid [*ext_shape, *dep_con_shape]
# ---------------------------------------------------------------------------
class _IndexEnv:
    """Evaluates AffineComp/SparseComp index expressions to int32 tensors
    over a grid [*ext_shape, *dep_con_shape] on `device`: the CPU for the
    index tables built once per init from the concrete sparse maps, the
    card for a contraction block's indices (made anew for each block so
    that no table of the whole fiber is kept).  Results broadcast against
    the grid: an axis the expression does not read stays 1.  offsets:
    axis -> first index of a contraction block."""

    def __init__(self, axes: Dict[IndexDomain, int], shape: Tuple[int, ...], sparse_data,
                 offsets=None, device="cpu"):
        self.axes = axes  # domain -> axis position
        self.shape = shape
        self.sparse_data = sparse_data  # name -> [prod(in_dims), n_out] int32 on device
        self.offsets = offsets or {}
        self.device = device

    def _iota(self, axis):
        n = self.shape[axis]
        view = [1] * len(self.shape)
        view[axis] = n
        off = self.offsets.get(axis, 0)
        return torch.arange(off, off + n, dtype=torch.int32, device=self.device).reshape(view)

    def eval(self, comp: AffineComp):
        val = torch.full([1] * len(self.shape), comp.offset, dtype=torch.int32,
                         device=self.device)
        for base, coeff in comp.terms:
            if isinstance(base, IndexDomain):
                val = val + coeff * self._iota(self.axes[base])
            else:
                val = val + coeff * self.eval_sparse(base)
        return val

    def _identity_flat(self, sc: SparseComp) -> bool:
        """True when the composed in-space index is exactly the row-major
        iota over this grid (a plain sparse(e) over the full residual
        domain, e.g. BA's oToC(o)): the map column is then used as is."""
        sm = sc.sparse
        if len(sc.args) != len(self.shape):
            return False
        for k, (a, d_in) in enumerate(zip(sc.args, sm.in_dims)):
            if isinstance(a, SparseComp) or a.offset != 0 or len(a.terms) != 1:
                return False
            (base, coeff) = a.terms[0]
            if coeff != 1 or isinstance(base, SparseComp):
                return False
            ax = self.axes.get(base)
            if ax != k or self.shape[ax] != d_in.size or ax in self.offsets:
                return False
        return True

    def eval_sparse(self, sc: SparseComp):
        sm = sc.sparse
        data = self.sparse_data[sm.name]  # [prod(in_dims), n_out]
        if self._identity_flat(sc):
            return data[:, sc.component].reshape(self.shape)
        in_sizes = [d.size for d in sm.in_dims]
        flat = self.eval(sc.args[0]) % in_sizes[0]
        for a, n in zip(sc.args[1:], in_sizes[1:]):
            flat = flat * n + (self.eval(a) % n)
        return data[:, sc.component].index_select(0, flat.reshape(-1)).reshape(flat.shape)


# ---------------------------------------------------------------------------
# the gather of a graph slot and its transpose (thallo_tpu/lower.py:367-380
# gather_with_segsum and _gather's routes, :643-690)
# ---------------------------------------------------------------------------
class SlotRoute:
    """A gathered slot's flat indices `idx` [M] (long) into its image of N
    elements and the route of its transpose: the segment-sum plan `stable`
    (fixed_order_plan's, or THALLO_SEGSUM=tiled's), else the int32 `ids` of
    a small image for the aggregation kernel, else neither (index_add_).  An opaque object to
    torch.func: a tensor inside a tuple argument of a Function may come
    back wrapped for a transform level (torch 2.11), without the storage a
    kernel reads."""

    __slots__ = ("idx", "stable", "ids", "N")

    def __init__(self, idx, stable, ids, N):
        self.idx, self.stable, self.ids, self.N = idx, stable, ids, N


def fixed_order_plan(flat, S, device):
    """The fixed-order route of a small-image scatter (FIXED_ORDER_MAX_ROWS):
    ids `flat` into S segments, summed in order where no run is longer
    than IN_ORDER_MAX_RUN, else in sorted runs."""
    longest = int(np.bincount(flat, minlength=S).max())
    return build_plan(flat, S, device=device, in_order=longest <= IN_ORDER_MAX_RUN)


def scatter_route(valsT, route: SlotRoute):
    """valsT [F, M] summed by destination route.idx into [F, N], through
    the route's kernel (on a CUDA tensor it launches or raises) or
    index_add_ (the counterpart of jax.ops.segment_sum)."""
    if route.stable is not None:
        return segment_sum(valsT.T, route.stable).T
    if route.ids is not None:
        return oh_setup_aggregate(valsT.contiguous(), route.ids, N=route.N)
    out = torch.zeros((valsT.shape[0], route.N), dtype=valsT.dtype, device=valsT.device)
    return out.index_add_(1, route.idx, valsT)


class SlotGather(torch.autograd.Function):
    """src [C, N] -> src[:, route.idx] [C, M], whose transpose is
    SlotScatter (scatter_route): the vjp of a graph residual (INLINE's Jᵀ)
    sums into the unknowns through the port's kernels instead of
    autograd's index_add_.  The jvp is the gather of the tangent; vmap
    folds its batch axis into the channels (jacfwd's dense J, a vmapped
    cotangent)."""

    @staticmethod
    def forward(src, route):
        return src.index_select(1, route.idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.route = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return SlotScatter.apply(grad, ctx.route), None

    @staticmethod
    def jvp(ctx, t_src, _t_route):
        return SlotGather.apply(t_src, ctx.route)

    @staticmethod
    def vmap(info, in_dims, src, route):
        return _fold_batch(SlotGather, in_dims[0], src, route)


class SlotScatter(torch.autograd.Function):
    """valsT [F, M] -> [F, N] by scatter_route, the transpose of
    SlotGather; a Function of its own, so that under torch.func (grad,
    vmap) the kernels get the unwrapped tensors they read by pointer."""

    @staticmethod
    def forward(valsT, route):
        return scatter_route(valsT, route)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.route = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return SlotGather.apply(grad, ctx.route), None

    @staticmethod
    def jvp(ctx, t_vals, _t_route):
        return SlotScatter.apply(t_vals, ctx.route)

    @staticmethod
    def vmap(info, in_dims, valsT, route):
        return _fold_batch(SlotScatter, in_dims[0], valsT, route)


def _fold_batch(fn, bdim, x, route):
    """fn over a vmapped [B, C, K] operand as one call over [B*C, K]."""
    if bdim is None:
        return fn.apply(x, route), None
    x = x.movedim(bdim, 0)
    B, C, K = x.shape
    return fn.apply(x.reshape(B * C, K), route).reshape(B, C, -1), 0


# ---------------------------------------------------------------------------
# the lowered group
# ---------------------------------------------------------------------------
class LoweredGroup:
    """A residual group compiled against concrete dim sizes.

    Solver-facing API (see solver/gn.py), channel-major:
      residuals_cm(X, inputs, consts)        -> [rc, R]
      point_jacobians_cm(X, inputs, consts)  -> (r [rc, R], [rc, C_j, R, *dep_j]
                                                 per jac slot)
      gather_slot / scatter_slot             -> [C, R, *dep] / image-shaped [*dims, F]
      blocked_jtf_diag / blocked_jtjp        -> a group with a con_block
    and the JAX package's row-major views residuals -> [R, rc],
    point_jacobians -> (r [R, rc], jacs list of [R, rc, *dep, C_j]).
    The jac slots are the unknown slots, then, with materialized computed
    arrays, one composed slot per (computed-array access, unknown slot of
    its expression); gather_slot, scatter_slot and the index tables take
    any jac slot.
    """

    def __init__(self, name: str, exprs: List[Exp], spec, sizes: Dict[str, int], dtype,
                 domain_order=None, con_splits=None):
        self.name = name
        self.dtype = dtype
        self.spec = spec
        exprs = inline_computed(exprs)
        self.exprs = exprs
        col = Collection()
        for e in exprs:
            col.walk(e, frozenset())
        col.finalize()
        self.col = col
        self.ext_domains = list(col.ext_domains)
        discovery = tuple(self.ext_domains)
        if domain_order:
            want = [d for d in domain_order if d in self.ext_domains]
            self.ext_domains = want + [d for d in self.ext_domains if d not in want]
        self.domain_order = tuple(self.ext_domains)
        # a non-default order keys its measurements apart (schedule.py)
        self.reordered = self.domain_order != discovery
        self.con_domains = col.con_domains
        both = set(self.ext_domains) & set(self.con_domains)
        if both:
            raise ValueError(f"domains used both inside and outside Sum: {both}")
        self.ext_shape = tuple(d.dim.size for d in self.ext_domains)
        self.con_shape = tuple(d.dim.size for d in self.con_domains)
        self.R = int(np.prod(self.ext_shape)) if self.ext_shape else 1
        self.uslots: List[SlotSpec] = list(col.uslots.values())
        self.cslots: List[SlotSpec] = list(col.cslots.values())
        self.mslots: List[SlotSpec] = list(col.mslots.values())
        self.rc = len(exprs)
        # static dependence of each InBounds and index value on the
        # contracted domains (JAX's _bdeps_static / _ideps_static)
        self._bdeps = [self._comp_deps(b.comps) for b in col.bounds.values()]
        self._ideps = [self._comp_deps((v.comp,)) for v in col.ivals.values()]
        # one sub-lowering per materialized computed array: a pointwise group
        # over the array's declared domains (thallo_tpu/lower.py:436-456)
        self.computed_groups = {}
        for slot in self.mslots:
            im = slot.image
            if im.name not in self.computed_groups:
                for d in im.dims:
                    if d.size is None:
                        d.size = sizes[d.name]
                sub = LoweredGroup(f"ca_{im.name}", list(im.expression), spec, sizes, dtype)
                if sub.con_domains:
                    raise ValueError(
                        f"materialized computed array {im.name} contains a Sum; "
                        "keep contractions in the residual")
                perm = [sub.ext_domains.index(d) for d in im.domains]
                self.computed_groups[im.name] = (im, sub, perm)
        # composed unknown accesses (thallo_tpu/lower.py:457-484): for each
        # computed-array access m and each unknown slot k of the array's
        # expression, k's comps with the array's domains substituted by m's
        self.comp_slots: List[Tuple[SlotSpec, int, int]] = []
        self.ca_jac_ok = (
            not any(s.dep_cons for s in self.mslots)
            and all(not s.dep_cons for s in self.uslots)
            and all(not sub.mslots and all(not s.dep_cons for s in sub.uslots)
                    for (_, sub, _) in self.computed_groups.values()))
        if self.mslots and self.ca_jac_ok:
            for mi, mslot in enumerate(self.mslots):
                im, sub, _ = self.computed_groups[mslot.image.name]
                mapping = dict(zip(im.domains, mslot.comps))
                for k, s in enumerate(sub.uslots):
                    comps = tuple(substitute_index(c, mapping) for c in s.comps)
                    self.comp_slots.append((SlotSpec(s.image, comps, True), mi, k))
        # stencil slots: gathered by torch.roll of the image (torus wrap);
        # a slot over a contracted domain is a gather, never a roll
        self._rolls = [self._roll_plan(s) for s in self.jac_slots]
        self._crolls = [self._roll_plan(s) for s in self.cslots]
        self._mrolls = [self._roll_plan(s) for s in self.mslots]
        # every jac slot a roll: JAX builds no block-sparse tables for it
        self.pure_stencil = all(rp is not None for rp in self._rolls)
        self._F = self._build_local_fn()
        # contraction blocking (thallo_tpu/lower.py:486-492): the Sums run
        # over blocks of one contracted domain, one block's fiber at a time
        self.con_block = self._plan_con_block(con_splits or {})
        self._split_fns = {}

    # external axis -> first index of this rank's block (shard_view)
    _ext_offsets: Dict[int, int] = {}

    def shard_view(self, axis: int, lo: int, hi: int) -> "LoweredGroup":
        """This group over the block [lo, hi) of its external axis `axis`
        (a rank's residual shard under a mesh): R and the grid shrink to the
        block, index expressions see global indices (the block's offset),
        and every roll becomes a gather by its torus-wrapped flat indices,
        so the slots read the whole (gathered) image.  The lowering, the
        slots and pure_stencil are shared with this group."""
        g = copy.copy(self)
        shape = list(self.ext_shape)
        shape[axis] = hi - lo
        g.ext_shape = tuple(shape)
        g.R = int(np.prod(shape))
        g._ext_offsets = {axis: lo}
        g._rolls = [None] * len(self._rolls)
        g._crolls = [None] * len(self._crolls)
        g._mrolls = [None] * len(self._mrolls)
        g._F = g._build_local_fn()
        g._split_fns = {}
        return g

    @property
    def jac_slots(self) -> List[SlotSpec]:
        """Unknown slots plus, for materialized computed arrays, the
        composed slots (aligned with point_jacobians_cm's jacs)."""
        if self.mslots and self.ca_jac_ok:
            return list(self.uslots) + [cs for cs, _, _ in self.comp_slots]
        return list(self.uslots)

    @property
    def has_materialized(self):
        return bool(self.mslots)

    # -- contraction blocking plan ----------------------------------------------
    def _reduction_nodes(self):
        """Deterministic list of distinct Reduction nodes across exprs."""
        seen, out = set(), []

        def walk(e):
            if id(e) in seen:
                return
            seen.add(id(e))
            if isinstance(e, Reduction):
                out.append(e)
                walk(e.arg)
            elif isinstance(e, Apply):
                for a in e.args:
                    walk(a)

        for e in self.exprs:
            walk(e)
        return out

    def _plan_con_block(self, con_splits):
        """(domain, block, n_blocks) or None (thallo_tpu/lower.py:494-565).
        Eligible when every Reduction covers the full contracted space, none
        nests in another, nothing contracted leaks outside a Reduction, no
        materialized computed array, and no unknown it touches has an
        Exclude.  Activated by a split(domain, B) directive, or when the
        unblocked fiber exceeds THALLO_CON_BLOCK_BYTES (default 128 MiB)."""
        if not self.con_domains or self.mslots:
            return None
        conset = set(self.con_domains)
        rnodes = self._reduction_nodes()
        if not rnodes or any(set(rn.domains) != conset for rn in rnodes):
            return None

        def has_nested(e, inside):
            if isinstance(e, Reduction):
                return inside or has_nested(e.arg, True)
            if isinstance(e, Apply):
                return any(has_nested(a, inside) for a in e.args)
            return False

        def leaks(e, inside):
            if isinstance(e, Reduction):
                return False
            if isinstance(e, (ImageAccess, BoundsAccess, IndexValue)):
                comps = e.comps if not isinstance(e, IndexValue) else (e.comp,)
                return not inside and any(d in conset for c in comps for d in c.domains())
            if isinstance(e, Apply):
                return any(leaks(a, inside) for a in e.args)
            return False

        if any(has_nested(e, False) or leaks(e, False) for e in self.exprs):
            return None
        touched = {s.image.name for s in self.uslots}
        if any(im.exclude_expr is not None for im in self.spec.unknowns if im.name in touched):
            return None
        split_dom = next((d for d in self.con_domains if d in con_splits), None)
        dom = split_dom or max(self.con_domains, key=lambda d: d.dim.size)
        size = dom.dim.size
        width = sum(int(np.prod([d.dim.size for d in sl.dep_cons])) * sl.image.channels
                    for sl in self.uslots + self.cslots if sl.dep_cons)
        fiber_bytes = self.R * max(width, 1) * 4
        budget = int(os.environ.get("THALLO_CON_BLOCK_BYTES", str(1 << 27)))
        if split_dom is not None:
            B = max(1, min(int(con_splits[split_dom]), size))
        elif fiber_bytes > budget:
            B = max(1, int(size * budget / fiber_bytes))
        else:
            return None
        while size % B:
            B -= 1  # the largest divisor at or under the target width
        if B >= size:
            return None
        return (dom, B, size // B)

    # -- slot index machinery ----------------------------------------------
    def _roll_plan(self, slot: SlotSpec):
        """If this slot is a pure grid-offset access over distinct external
        domains matching the image's axes, return (ext_axis_per_image_axis,
        shifts): a stencil access, gathered by a roll of the image and
        scattered by the roll back (thallo_tpu/lower.py:578)."""
        if slot.dep_cons:
            return None
        im = slot.image
        used, shifts = [], []
        for j, c in enumerate(slot.comps):
            so = c.as_single_offset()
            if so is None:
                return None
            d, off = so
            if d not in self.ext_domains or d.dim is not im.dims[j]:
                return None
            used.append(self.ext_domains.index(d))
            shifts.append(off)
        if len(set(used)) != len(used):
            return None
        return used, shifts

    @property
    def has_gathers(self) -> bool:
        """Some unknown slot is a real gather, not a stencil roll (the JAX
        package's default_schedule test)."""
        return any(rp is None for rp in self._rolls[:len(self.uslots)])

    def _comp_deps(self, comps):
        conset = set(self.con_domains)
        deps = []
        for c in comps:
            for d in c.domains():
                if d in conset and d not in deps:
                    deps.append(d)
        return tuple(sorted(deps, key=self.con_domains.index))

    def _dep_shape(self, deps, con_block=None):
        """The contracted part of a value's shape; the blocked domain at its
        block width."""
        return tuple(con_block[2] if con_block is not None and d is con_block[0]
                     else d.dim.size for d in deps)

    def _grid_env(self, deps, sparse, con_block=None, device="cpu"):
        """The index environment over [*ext_shape, *dep_shape] and that shape
        (thallo_tpu's _slot_axes); a shard's external axis starts at its
        block's first index (shard_view)."""
        axes = {d: i for i, d in enumerate(self.ext_domains)}
        offsets = dict(self._ext_offsets)
        for k, d in enumerate(deps):
            axes[d] = len(self.ext_shape) + k
            if con_block is not None and d is con_block[0]:
                offsets[axes[d]] = con_block[1]
        shape = self.ext_shape + self._dep_shape(deps, con_block)
        return _IndexEnv(axes, shape, sparse, offsets, device), shape

    def _sparse_arrays(self, inputs):
        """name -> [prod(in_dims), n_out] int32 CPU tensor of each sparse map."""
        out = {}
        for sm in self.spec.sparse_maps:
            if inputs is not None and sm.name in inputs:
                arr = np.ascontiguousarray(inputs[sm.name], dtype=np.int32)
                out[sm.name] = torch.from_numpy(arr).reshape(-1, len(sm.out_dims))
        return out

    def _flat(self, slot: SlotSpec, sparse, con_block=None, device="cpu"):
        """(flat element indices of the slot's image, broadcastable to the
        grid; the grid's shape).  A stencil slot wraps around the torus as
        its roll does; so does any index, as in thallo_tpu."""
        env, shape = self._grid_env(slot.dep_cons, sparse, con_block, device)
        im = slot.image
        flat = None
        for j, c in enumerate(slot.comps):
            n = im.dims[j].size
            v = env.eval(c) % n
            flat = v if flat is None else flat * n + v
        return flat, shape

    def _slot_flat_indices(self, slot: SlotSpec, inputs):
        """[R * prod(dep_shape)] int32 flat element indices of the slot's
        image (host), grid point-major."""
        flat, shape = self._flat(slot, self._sparse_arrays(inputs))
        return flat.expand(shape).reshape(-1).numpy()

    def _bounds_value(self, b: BoundsAccess, deps, sparse, con_block=None, device="cpu"):
        """[R, *dep_shape] f32 0/1: the InBounds test over the grid."""
        env, shape = self._grid_env(deps, sparse, con_block, device)
        ok = None
        for c, dm in zip(b.comps, b.dims):
            v = env.eval(c)
            cond = (v >= b.expand) & (v < dm.size - b.expand)
            ok = cond if ok is None else (ok & cond)
        return self._on_grid(ok, shape)

    def _ival_value(self, iv: IndexValue, deps, sparse, con_block=None, device="cpu"):
        """[R, *dep_shape] f32: an index expression's value over the grid."""
        env, shape = self._grid_env(deps, sparse, con_block, device)
        return self._on_grid(env.eval(iv.comp), shape)

    def _on_grid(self, v, shape):
        """A broadcastable value as [R, *dep_shape] f32."""
        return v.to(self.dtype).expand(shape).reshape((self.R,) + shape[len(self.ext_shape):])

    def _gather_grid(self, src_cn, flat, shape):
        """[C, N] source at broadcastable flat indices over `shape` ->
        [C, R, *dep] (gathered once per distinct index, then broadcast)."""
        C = src_cn.shape[0]
        v = src_cn.index_select(1, flat.reshape(-1)).reshape((C,) + tuple(flat.shape))
        return v.expand((C,) + tuple(shape)).reshape(
            (C, self.R) + tuple(shape[len(self.ext_shape):]))

    # -- per-solve constants -------------------------------------------------
    def prepared_consts(self, inputs, device, want_bsr=False, onehot_exclude=(),
                        row_windows=None):
        """Everything non-differentiated, computed once per init: index
        tables of the gathered jac slots (host -> device once; None for
        stencil slots and for slots over a blocked contracted domain),
        channel-major const-slot values [C, R, *dep], InBounds and
        index-value arrays ([R, *dep] f32 each, JAX's barrs/iarrs), params,
        sampled images, each materialized computed array's sub-group
        constants and its accesses' tables, and, when the schedule
        materializes JᵀJ, the static block-sparse tables
        (solver/blocksparse.py); without tables (another schedule, or
        tables that build_group_bsr refuses) the scatter route of each
        gathered slot: a segment-sum plan ("stables": fixed_order_plan's
        for a small-image scatter of at most FIXED_ORDER_MAX_ROWS values,
        else with THALLO_SEGSUM=tiled, read here as thallo_tpu reads it)
        or the ids of a small image for the aggregation kernel.  A slot, InBounds or
        index value over the blocked domain of a con_block is made per
        block (_blocked_operands).  onehot_exclude: image names that build
        row tables instead of one-hot rows (an image that schur_dense
        eliminates).  row_windows: image name -> the element range [lo, hi)
        a rank owns, where its row tables may start and end (a shard)."""
        blk = self.con_block[0] if self.con_block is not None else None
        sparse = self._sparse_arrays(inputs)
        jslots = self.jac_slots
        idx = [None if blk in s.dep_cons else self._slot_flat_indices(s, inputs)
               for s in jslots]

        def image(im):
            return inputs[im.name].reshape(tuple(d.size for d in im.dims) + (im.channels,))

        cvals = []
        for s, rp in zip(self.cslots, self._crolls):
            img = image(s.image)
            if blk in s.dep_cons:
                cvals.append(None)
            elif rp is not None:
                cvals.append(self._roll_gather(img.movedim(-1, 0), rp))
            else:
                flat, shape = self._flat(s, sparse)
                cvals.append(self._gather_grid(img.reshape(-1, s.image.channels).T,
                                               flat.to(img.device), shape))
        barrs = [None if blk in deps else self._bounds_value(b, deps, sparse).to(device)
                 for b, deps in zip(self.col.bounds.values(), self._bdeps)]
        iarrs = [None if blk in deps else self._ival_value(v, deps, sparse).to(device)
                 for v, deps in zip(self.col.ivals.values(), self._ideps)]
        params = {p.name: inputs[p.name] for p in self.col.params.values()}
        simgs = {name: [image(si.image)] + [image(d) for d in si.derivs]
                 for name, si in self.col.sampled.items()}
        bsr = None
        stables, agg_ids = {}, {}
        if want_bsr:
            from .solver.blocksparse import build_group_bsr

            bsr = build_group_bsr(self, idx, self.dtype, device, onehot_exclude, row_windows)
        if bsr is None:  # no tables: the group scatters per-point values into its images
            tiled = os.environ.get("THALLO_SEGSUM") == "tiled"
            for i, flat in enumerate(idx):
                if self._rolls[i] is not None or flat is None:
                    continue  # the roll back, or a blocked scatter
                S = self.slot_size(i)
                small = S <= ONEHOT_MAX_SEGMENTS and flat.size > 4 * S
                if small and flat.size <= FIXED_ORDER_MAX_ROWS:
                    plan = fixed_order_plan(flat, S, device)
                else:
                    plan = build_plan(flat, S, device=device) if tiled else None
                if plan is not None:
                    stables[i] = plan
                elif small:
                    agg_ids[i] = torch.from_numpy(flat).to(device)
        out = {
            "device": torch.device(device),
            "bsr": bsr,
            "slot_idx": [None if rp is not None or i is None else
                         torch.from_numpy(i).to(device=device, dtype=torch.long)
                         for i, rp in zip(idx, self._rolls)],
            "cvals": cvals,
            "barrs": barrs,
            "iarrs": iarrs,
            "params": params,
            "simgs": simgs,
            "stables": stables,
            "agg_ids": agg_ids,
        }
        if self.mslots:
            out["ca_consts"] = {name: sub.prepared_consts(inputs, device)
                                for name, (_, sub, _) in self.computed_groups.items()}
            out["mslot_idx"] = [
                None if rp is not None else
                torch.from_numpy(self._slot_flat_indices(s, inputs)).to(device=device,
                                                                       dtype=torch.long)
                for s, rp in zip(self.mslots, self._mrolls)]
        if self.con_block is not None:
            # the blocked slots' sources and the sparse maps, for the
            # per-block index tables made on the device
            out["sparse_dev"] = {k: v.to(device) for k, v in sparse.items()}
            out["cimgs"] = {s.image.name: image(s.image).reshape(-1, s.image.channels).T
                            for s in self.cslots if blk in s.dep_cons}
        return out

    def slot_size(self, i: int) -> int:
        """Element count of jac slot i's image."""
        return int(np.prod([d.size for d in self.jac_slots[i].image.dims]))

    # -- the local function -------------------------------------------------
    def _build_local_fn(self, con_sizes=None, mode="full"):
        """The residual evaluator over channel-major slot values: every
        leaf is an [R] row ([R, *con] in a group with contractions, its
        contracted axes 1 where it does not depend on them), a 0-d
        constant or param; every op is elementwise.  mode (JAX's
        _build_local_fn, thallo_tpu/lower.py:988-1105):
          "full"  -> [rc, R], every Sum reduced over the whole contraction;
          "inner" -> [nRN, R], only the Sums, each over the block con_sizes
                     gives (contraction blocking: partial sums);
          "outer" -> [rc, R], the Sums' values injected (red [nRN, R])."""
        ops = _make_ops(self.dtype)
        ukeys = {s.key: i for i, s in enumerate(self.uslots)}
        ckeys = {s.key: i for i, s in enumerate(self.cslots)}
        mkeys = {s.key: i for i, s in enumerate(self.mslots)}
        bkeys = {k: i for i, k in enumerate(self.col.bounds.keys())}
        ikeys = {k: i for i, k in enumerate(self.col.ivals.keys())}
        exprs = self.exprs
        R = self.R
        ncon = len(self.con_domains)
        con_shape = tuple(con_sizes or self.con_shape)
        rnodes = self._reduction_nodes() if mode in ("inner", "outer") else []
        rindex = {id(rn): k for k, rn in enumerate(rnodes)}
        udeps = [s.dep_cons for s in self.uslots]
        cdeps = [s.dep_cons for s in self.cslots]
        mdeps = [s.dep_cons for s in self.mslots]
        const_cache = {}

        def const(value, device):
            key = (value, device)
            t = const_cache.get(key)
            if t is None:
                t = const_cache[key] = torch.tensor(value, dtype=self.dtype, device=device)
            return t

        def place(v, deps):
            """[R, *dep] -> [R, *con] with 1 at the domains v does not read
            (thallo_tpu's _place_in_con)."""
            if not ncon:
                return v
            pos = {self.con_domains.index(d) for d in deps}
            return v.reshape((v.shape[0],) + tuple(
                con_shape[a] if a in pos else 1 for a in range(ncon)))

        def scalar_per_point(v):
            """A value left after every Sum -> [R] (or 0-d)."""
            if v.ndim > 1:
                if any(n != 1 for n in v.shape[1:]):
                    raise ValueError(
                        f"residual '{self.name}' still depends on contracted "
                        f"domains after reduction (shape {tuple(v.shape)}); wrap the "
                        "contracted part in Sum(...)")
                v = v.reshape(v.shape[0])
            return v

        def F(uvals, consts, mvals=(), red=None, cvals=None, barrs=None, iarrs=None):
            device = consts["device"]
            cvals = consts["cvals"] if cvals is None else cvals
            barrs = consts["barrs"] if barrs is None else barrs
            iarrs = consts["iarrs"] if iarrs is None else iarrs
            cache = {}

            def ev(e: Exp):
                r = cache.get(id(e))
                if r is not None:
                    return r
                if isinstance(e, Const):
                    r = const(e.value, device)
                elif isinstance(e, Apply):
                    r = ops[e.op](*[ev(a) for a in e.args])
                elif isinstance(e, Reduction):
                    if mode == "outer":
                        r = red[rindex[id(e)]].reshape((R,) + (1,) * ncon)
                    else:
                        v = ev(e.arg)
                        if v.ndim < 1 + ncon:
                            v = v.reshape((1,) * (1 + ncon))
                        axes = [1 + self.con_domains.index(d) for d in e.domains]
                        # broadcast the reduced axes to their full extent
                        v = v.expand(tuple(con_shape[a - 1] if a in axes else n
                                           for a, n in enumerate(v.shape)))
                        r = v.sum(dim=axes, keepdim=True)
                elif isinstance(e, ImageAccess):
                    k = (id(e.image), e.comps)
                    if e.image.kind == "unknown":
                        i = ukeys[k]
                        r = place(uvals[i][e.channel], udeps[i])
                    elif e.image.kind == "computed":
                        i = mkeys[k]
                        r = place(mvals[i][e.channel], mdeps[i])
                    else:
                        i = ckeys[k]
                        r = place(cvals[i][e.channel], cdeps[i])
                elif isinstance(e, BoundsAccess):
                    i = bkeys[("bounds", e.comps, e.dims, e.expand)]
                    r = place(barrs[i], self._bdeps[i])
                elif isinstance(e, IndexValue):
                    i = ikeys[("ival", e.comp)]
                    r = place(iarrs[i], self._ideps[i])
                elif isinstance(e, ParamValue):
                    r = consts["params"][e.param.name]
                elif isinstance(e, SampleAccess):
                    coords = [ev(c) for c in e.coords]
                    si = e.sampled
                    imgs = consts["simgs"][si.name]
                    if si.is_array:
                        fn = conditional_array_sample if si.conditional else array_bilinear_sample
                        val = fn(imgs[0], *coords)
                    elif si.derivs:
                        val = sample_with_deriv_images(imgs[0], imgs[1], imgs[2], *coords)
                    else:
                        val = bilinear_sample(imgs[0], *coords)
                    r = val[..., e.channel]
                else:
                    raise TypeError(f"unhandled node {e!r}")
                cache[id(e)] = r
                return r

            if mode == "inner":
                out = torch.stack([scalar_per_point(ev(rn).reshape(-1, *([1] * ncon)))
                                   .expand(R) for rn in rnodes])
            elif not ncon:
                out = torch.stack([ev(e).expand(R) for e in exprs])
            else:
                out = torch.stack([scalar_per_point(ev(e)).expand(R) for e in exprs])
            # ev refers to itself through its closure: without this the cycle
            # keeps every value of this call (slots, intermediates) alive
            # until the garbage collector runs
            del ev
            return out

        return F

    # -- gathers and their transposes -----------------------------------------
    def _roll_gather(self, img_cm, rp):
        """[C, R] values of a stencil slot from its image channel-major,
        img_cm [C, *dims]: roll by -offset along each shifted image axis
        (torus wrap), image axes into external-domain order, broadcast over
        the external axes the slot does not use (thallo_tpu's _apply_roll
        and _place_axes)."""
        used, shifts = rp
        dims = [1 + j for j, off in enumerate(shifts) if off]
        v = torch.roll(img_cm, [-shifts[d - 1] for d in dims], dims) if dims else img_cm
        v = v.permute(0, *[1 + int(a) for a in np.argsort(used)])
        present = set(used)
        for a in range(len(self.ext_shape)):
            if a not in present:
                v = v.unsqueeze(1 + a)
        C = v.shape[0]
        return v.expand((C,) + self.ext_shape).reshape(C, self.R)

    def _roll_scatter(self, valsT, rp):
        """Transpose of _roll_gather: [F, R] -> image-shaped [*dims, F]
        (sum over the unused external axes, image axes back in order, the
        roll back: thallo_tpu's _scatter of a stencil slot)."""
        used, shifts = rp
        nd = len(self.ext_shape)
        v = valsT.reshape((valsT.shape[0],) + self.ext_shape)
        extra = tuple(1 + a for a in range(nd) if a not in used)
        if extra:
            v = v.sum(extra)
        v = v.permute(0, *[1 + int(k) for k in np.argsort(np.argsort(used))])
        dims = [1 + j for j, off in enumerate(shifts) if off]
        if dims:
            v = torch.roll(v, [shifts[d - 1] for d in dims], dims)
        return v.movedim(0, -1)

    def gather_all_cm(self, X, consts):
        """[C_i, R, *dep_i] per unknown slot: stencil slots by rolls of the
        image, laid out channel-major once per image, the others by
        minor-axis gathers of [C, N] sources."""
        out, cm = [], {}
        for i, s in enumerate(self.uslots):
            name = s.image.name
            rp = self._rolls[i]
            if rp is None:
                src = X[name].reshape(-1, s.image.channels).T
                out.append(SlotGather.apply(src, self._route(i, consts))
                           .reshape((s.image.channels, self.R) + self._dep_shape(s.dep_cons)))
                continue
            if name not in cm:
                cm[name] = X[name].movedim(-1, 0).contiguous()
            out.append(self._roll_gather(cm[name], rp))
        return out

    def gather_slot(self, i: int, X, consts):
        """[C, R, *dep] channel-major values of jac slot i (X may be any
        image-shaped tree over the unknowns, e.g. a PCG direction)."""
        slot = self.jac_slots[i]
        img = X[slot.image.name]
        rp = self._rolls[i]
        if rp is not None:
            return self._roll_gather(img.movedim(-1, 0), rp)
        # the array's own channel count: a mask is gathered through an
        # unknown's slot with one channel
        C = img.shape[-1]
        return SlotGather.apply(img.reshape(-1, C).T, self._route(i, consts)).reshape(
            (C, self.R) + self._dep_shape(slot.dep_cons))

    def gather_mask(self, i: int, mask, consts):
        """[R, *dep] values of a channelless mask [*dims] at jac slot i."""
        return self.gather_slot(i, {self.jac_slots[i].image.name: mask[..., None]}, consts)[0]

    def scatter_slot(self, i: int, valsT, consts):
        """Transpose of gather_slot: per-point values [F, R, *dep] summed
        into jac slot i's image, returned image-shaped [*dims, F].  A
        stencil slot rolls back; the others route as thallo_tpu's
        _scatter: segment-sum plan, else the aggregation kernel for a small
        image, else index_add_."""
        rp = self._rolls[i]
        if rp is not None:
            return self._roll_scatter(valsT, rp)
        F = valsT.shape[0]
        out = scatter_route(valsT.reshape(F, -1), self._route(i, consts)).T
        return out.reshape(tuple(d.size for d in self.jac_slots[i].image.dims) + (F,))

    def _route(self, i: int, consts) -> SlotRoute:
        """Gathered jac slot i's gather and the route of its transpose."""
        return SlotRoute(consts["slot_idx"][i], consts["stables"].get(i),
                         consts["agg_ids"].get(i), self.slot_size(i))

    # -- materialized computed arrays -------------------------------------------
    def _ca_image(self, name, valsT):
        """A computed array's sub-group values [F, R_sub] as the array
        [*declared dims, F]."""
        im, sub, perm = self.computed_groups[name]
        arr = valsT.T.reshape(sub.ext_shape + (valsT.shape[0],))
        return arr.permute(*perm, len(perm))

    def ca_values(self, X, consts):
        """Each materialized computed array's value array [*dims, C] from
        the current unknowns (differentiable)."""
        return {name: self._ca_image(name, sub.residuals_cm(X, None, consts["ca_consts"][name]))
                for name, (_, sub, _) in self.computed_groups.items()}

    def _gather_mslot(self, i, img, consts):
        """[C, R] of computed-array access i from an array [*dims, C]."""
        rp = self._mrolls[i]
        if rp is not None:
            return self._roll_gather(img.movedim(-1, 0), rp)
        return img.reshape(-1, img.shape[-1]).T.index_select(1, consts["mslot_idx"][i])

    def gather_mslots(self, arrs, consts):
        """[C, R] per computed-array access, from the arrays [*dims, C]."""
        return [self._gather_mslot(i, arrs[s.image.name], consts)
                for i, s in enumerate(self.mslots)]

    def _ca_vals_and_grads(self, X, consts):
        """Each computed array's values and its gradient arrays, one
        [*dims, Cca * C_k] per unknown slot of its sub-group
        (thallo_tpu/lower.py:1130-1149)."""
        cav, grads = {}, {}
        for name, (im, sub, _) in self.computed_groups.items():
            r_sub, jac_sub = sub.point_jacobians_cm(X, None, consts["ca_consts"][name])
            cav[name] = self._ca_image(name, r_sub)
            grads[name] = [self._ca_image(name, J.reshape(-1, J.shape[-1])) for J in jac_sub]
        return cav, grads

    # -- residuals and point Jacobians ------------------------------------------
    def residuals_cm(self, X, inputs, consts):
        """r(U): [rc, R] channel-major."""
        if self.con_block is not None:
            return self._residuals_blocked(X, consts)
        mvals = self.gather_mslots(self.ca_values(X, consts), consts) if self.mslots else ()
        return self._F(self.gather_all_cm(X, consts), consts, mvals)

    def residuals(self, X, inputs, consts):
        """r(U): [R, rc], thallo_tpu's layout (a view of residuals_cm)."""
        return self.residuals_cm(X, inputs, consts).T

    def _use_rev_mode(self, total_channels: int) -> bool:
        """Forward mode costs one tangent pass per unknown channel, reverse
        one (~2x-priced) cotangent pass per residual channel
        (thallo_tpu/lower.py:1185).  THALLO_JAC_MODE=fwd/rev overrides.  A
        slot over contracted domains takes reverse mode (JAX's vmap(jacrev),
        thallo_tpu/lower.py:1426-1428): a tangent per channel would sum
        over its contraction."""
        if any(s.dep_cons for s in self.uslots):
            return True
        mode = os.environ.get("THALLO_JAC_MODE", "auto")
        if mode == "auto":
            return 2 * self.rc < total_channels
        return mode == "rev"

    def point_jacobians_cm(self, X, inputs, consts):
        """(r [rc, R], jacsT list of [rc, C_j, R, *dep_j] per jac slot).
        Reverse mode (2*rc below the unknown channels, e.g. BA, or a slot
        over contracted domains): one torch.func.vjp cotangent per residual
        channel.  Forward mode (grid energies such as image_warping): one
        torch.func.jvp tangent per unknown channel, the tangents batched by
        torch.func.vmap so the primal runs once.  With materialized computed
        arrays the accesses' values are inputs too, and each composed slot's
        Jacobian is dr/dCA · dCA/du_k, from the arrays' gradient arrays."""
        if self.con_block is not None:
            dom, B, _ = self.con_block
            raise RuntimeError(
                f"group {self.name!r} runs with blocked contractions (split over "
                f"{dom.dim.name}, block {B}): per-point jacobians would materialize "
                "the full fiber; use blocked_jtf_diag / blocked_jtjp")
        uvalsT = [v.contiguous() for v in self.gather_all_cm(X, consts)]
        grads = None
        if self.mslots:
            if not self.ca_jac_ok:
                raise RuntimeError(
                    "point_jacobians on a group whose materialized computed arrays have "
                    "contraction fibers; plan the force-inlined group")
            cav, grads = self._ca_vals_and_grads(X, consts)
            mvals = [v.contiguous() for v in self.gather_mslots(cav, consts)]
        else:
            mvals = []
        nu = len(uvalsT)

        def f(vals):
            return self._F(vals[:nu], consts, vals[nu:])

        vals = uvalsT + mvals
        if self._use_rev_mode(sum(v.shape[0] for v in vals)):
            r, vjp_fn = torch.func.vjp(f, vals)
            rows = []
            for c in range(self.rc):
                ct = torch.zeros_like(r)
                ct[c] = 1.0
                rows.append(vjp_fn(ct)[0])  # list of [C_i, R, *dep]
            jacsT = [torch.stack([rows[c][i] for c in range(self.rc)]) for i in range(len(vals))]
            r = r.detach()
        else:
            chans = [(i, c) for i, v in enumerate(vals) for c in range(v.shape[0])]
            tangents = []
            for i, v in enumerate(vals):
                t = torch.zeros((len(chans),) + tuple(v.shape), dtype=v.dtype, device=v.device)
                for k, (si, c) in enumerate(chans):
                    if si == i:
                        t[k, c] = 1.0
                tangents.append(t)
            cols = torch.func.vmap(lambda t: torch.func.jvp(f, (vals,), (t,))[1])(tangents)
            jacsT, k = [], 0
            for v in vals:
                C = v.shape[0]
                jacsT.append(cols[k:k + C].transpose(0, 1))  # [rc, C, R]
                k += C
            r = f(vals)
        if self.mslots:
            dr_dm = jacsT[nu:]
            jacsT = jacsT[:nu]
            for _, mi, k in self.comp_slots:
                mslot = self.mslots[mi]
                Cca = mslot.image.channels
                g_at = self._gather_mslot(mi, grads[mslot.image.name][k], consts)
                g_at = g_at.reshape(Cca, -1, self.R)  # [Cca, Ck, R]
                jacsT.append((dr_dm[mi][:, :, None] * g_at[None]).sum(1))
        return r, jacsT

    def point_jacobians(self, X, inputs, consts):
        """(r [R, rc], jacs list of [R, rc, *dep, C_j]): thallo_tpu's
        layout."""
        r, jacsT = self.point_jacobians_cm(X, inputs, consts)
        return r.T, [J.movedim(2, 0).movedim(2, -1) for J in jacsT]

    # -- contraction blocking (thallo_tpu/lower.py:1523-1782) --------------------
    # The Sums run over blocks of one contracted domain, a Python loop with
    # one block's fiber [R, B, ...] live at a time.  The expression DAG
    # splits at the Sums: F_inner evaluates each Sum's block-partial value,
    # the partials add up over the blocks, F_outer finishes the residual
    # from the injected sums.  Derivatives follow the chain rule through
    # the Sums' values, block by block: J = dF_outer/du + dF_outer/dred ·
    # dred/du, where dred/du of a slot over the blocked domain lives in its
    # block alone.
    def _fns_for_block(self, B):
        if B not in self._split_fns:
            sizes = tuple(B if d is self.con_block[0] else d.dim.size for d in self.con_domains)
            self._split_fns[B] = (self._build_local_fn(con_sizes=sizes, mode="inner"),
                                  self._build_local_fn(mode="outer"),
                                  len(self._reduction_nodes()))
        return self._split_fns[B]

    def _blocked_split(self):
        """(slots over the blocked domain, the other unknown slots, the
        latter that a Sum reads)."""
        dom = self.con_block[0]
        dom_slots = [i for i, s in enumerate(self.uslots) if dom in s.dep_cons]
        stat = [i for i, s in enumerate(self.uslots) if dom not in s.dep_cons]
        inner = set()
        for rn in self._reduction_nodes():
            col = Collection()
            col.walk(rn.arg, frozenset(self.con_domains))
            inner |= set(col.uslots)
        return dom_slots, stat, [i for i in stat if self.uslots[i].key in inner]

    def _static_uvals(self, X, consts):
        """The unknown slots not over the blocked domain, gathered once."""
        dom = self.con_block[0]
        return [None if dom in s.dep_cons else self.gather_slot(i, X, consts)
                for i, s in enumerate(self.uslots)]

    def _blocked_operands(self, X, consts, b, u_static):
        """(uvals, cvals, barrs, iarrs) of block b: the values over the
        blocked domain gathered for this block (index tables made on the
        device), the others as given."""
        dom, B, _ = self.con_block
        cb = (dom, b * B, B)
        sparse, dev = consts["sparse_dev"], consts["device"]

        def gather(slot, src_cn):
            flat, shape = self._flat(slot, sparse, cb, dev)
            return self._gather_grid(src_cn, flat, shape)

        uv = [u_static[i] if u_static[i] is not None else
              gather(s, X[s.image.name].reshape(-1, s.image.channels).T)
              for i, s in enumerate(self.uslots)]
        cv = [consts["cvals"][i] if consts["cvals"][i] is not None else
              gather(s, consts["cimgs"][s.image.name]) for i, s in enumerate(self.cslots)]
        bv = [consts["barrs"][i] if consts["barrs"][i] is not None else
              self._bounds_value(bb, self._bdeps[i], sparse, cb, dev)
              for i, bb in enumerate(self.col.bounds.values())]
        iv = [consts["iarrs"][i] if consts["iarrs"][i] is not None else
              self._ival_value(v, self._ideps[i], sparse, cb, dev)
              for i, v in enumerate(self.col.ivals.values())]
        return uv, cv, bv, iv

    def _blocked_reductions(self, X, consts, u_static):
        """[nRN, R]: every Sum's value, summed block by block."""
        dom, B, nblk = self.con_block
        F_in, _, _ = self._fns_for_block(B)
        red = None
        for b in range(nblk):
            uv, cv, bv, iv = self._blocked_operands(X, consts, b, u_static)
            part = F_in(uv, consts, cvals=cv, barrs=bv, iarrs=iv)
            red = part if red is None else red + part
            del uv, cv, bv, iv, part  # one block's operands live at a time
        return red

    def _residuals_blocked(self, X, consts):
        u_static = self._static_uvals(X, consts)
        red = self._blocked_reductions(X, consts, u_static)
        _, F_out, _ = self._fns_for_block(self.con_block[1])
        return F_out(u_static, consts, red=red)

    def _scatter_blocked(self, i, vals, consts, b):
        """Sum-scatter a block's values [F, R, B, *odep] of unknown slot i
        into its image [*dims, F] (index_add_ at the block's indices)."""
        dom, B, _ = self.con_block
        slot = self.uslots[i]
        flat, shape = self._flat(slot, consts["sparse_dev"], (dom, b * B, B), consts["device"])
        F = vals.shape[0]
        N = self.slot_size(i)
        out = torch.zeros((F, N), dtype=vals.dtype, device=vals.device)
        out.index_add_(1, flat.expand(shape).reshape(-1), vals.reshape(F, -1))
        return out.T.reshape(tuple(d.size for d in slot.image.dims) + (F,))

    def blocked_jtf_diag(self, X, inputs, consts):
        """(r [rc, R], Jᵀr dict, diag(JᵀJ) dict, store) with the fiber
        memory bounded by one contraction block (thallo_tpu/lower.py:
        1640-1771).  Pass 1 sums the Sums' values over the blocks and,
        for the static slots a Sum reads, dred/du by one vjp per Sum; the
        outer function's vjp per residual channel gives dF_outer/dred and
        dF_outer/du_static; pass 2 takes each block's dred/du of the slots
        over the blocked domain by one vjp per Sum and scatters Jᵀr and
        diag through the block's indices.  store: what blocked_jtjp needs
        at this linearization point."""
        dom, B, nblk = self.con_block
        F_in, F_out, nRN = self._fns_for_block(B)
        dom_slots, stat, inner_stat = self._blocked_split()
        u_static = self._static_uvals(X, consts)

        def merged(uv, idxs, vals):
            out = list(uv)
            for i, v in zip(idxs, vals):
                out[i] = v
            return out

        def basis(n, like):
            e = torch.zeros_like(like)
            e[n] = 1.0
            return e

        red, dstat = None, {}
        for b in range(nblk):
            uv, cv, bv, iv = self._blocked_operands(X, consts, b, u_static)
            ops = dict(cvals=cv, barrs=bv, iarrs=iv)
            if inner_stat:
                part, vjp_fn = torch.func.vjp(
                    lambda us: F_in(merged(uv, inner_stat, us), consts, **ops),
                    [uv[i] for i in inner_stat])
                for n in range(nRN):
                    g = vjp_fn(basis(n, part))[0]
                    for k, i in enumerate(inner_stat):
                        d = dstat.setdefault(i, [None] * nRN)
                        d[n] = g[k] if d[n] is None else d[n] + g[k]
                part = part.detach()
                del vjp_fn, g
            else:
                part = F_in(uv, consts, **ops)
            red = part if red is None else red + part
            del uv, cv, bv, iv, ops, part

        us = [u_static[i] for i in stat]
        r, vjp_o = torch.func.vjp(
            lambda rd, us_: F_out(merged(u_static, stat, us_), consts, red=rd), red, us)
        outs = [vjp_o(basis(c, r)) for c in range(self.rc)]
        r = r.detach()
        do_dred = torch.stack([o[0] for o in outs])  # [rc, nRN, R]
        mjtf, diag, J_stat = {}, {}, {}

        def add(out, name, v):
            out[name] = out[name] + v if name in out else v

        def bcast(t, like):  # [rc, R] against [rc, C, R, *dep]
            return t.reshape(t.shape[:1] + (1,) + t.shape[1:] + (1,) * (like.ndim - 3))

        for k, i in enumerate(stat):
            J = torch.stack([o[1][k] for o in outs])  # [rc, C, R, *odep]
            for n, dn in enumerate(dstat.get(i, ())):
                J = J + bcast(do_dred[:, n], J) * dn[None]
            J_stat[i] = J
            C = J.shape[1]
            both = self.scatter_slot(i, torch.cat([(J * bcast(r, J)).sum(0), (J * J).sum(0)]),
                                     consts)
            add(mjtf, self.uslots[i].image.name, both[..., :C])
            add(diag, self.uslots[i].image.name, both[..., C:])

        if dom_slots:
            w = (do_dred * r[:, None]).sum(0)  # [nRN, R]: dF_outer/dred ᵀ r
            G = (do_dred[:, :, None] * do_dred[:, None, :]).sum(0)  # [nRN, nRN, R]
            for b in range(nblk):
                uv, cv, bv, iv = self._blocked_operands(X, consts, b, u_static)
                part, vjp_d = torch.func.vjp(
                    lambda ud: F_in(merged(uv, dom_slots, ud), consts, cvals=cv, barrs=bv,
                                    iarrs=iv), [uv[i] for i in dom_slots])
                jn = [vjp_d(basis(n, part))[0] for n in range(nRN)]  # dred_n/du
                del part, vjp_d
                for k, i in enumerate(dom_slots):
                    def pw(t, like=jn[0][k]):  # [R] against [C, R, *dep]
                        return t.reshape((1,) + t.shape + (1,) * (like.ndim - 2))
                    jtr = sum(pw(w[n]) * jn[n][k] for n in range(nRN))
                    d2 = sum(pw(G[n, m]) * jn[n][k] * jn[m][k]
                             for n in range(nRN) for m in range(nRN))
                    C = jtr.shape[0]
                    both = self._scatter_blocked(i, torch.cat([jtr, d2]), consts, b)
                    del jtr, d2
                    add(mjtf, self.uslots[i].image.name, both[..., :C])
                    add(diag, self.uslots[i].image.name, both[..., C:])
                del uv, cv, bv, iv, jn
        store = {"X": X, "u_static": u_static, "do_dred": do_dred, "J_stat": J_stat}
        return r, mjtf, diag, store

    def blocked_jtjp(self, store, p, consts):
        """JᵀJ·p of a blocked group at the linearization point of `store`
        (blocked_jtf_diag), block by block: J·p = dF_outer/dred · Σ_b
        jvp(F_inner_b)(p_dom) + Σ_static J_stat·p_static, then Jᵀ(J·p):
        each static slot through its stored J, the slots over the blocked
        domain by one vjp of F_inner per block with the cotangent
        dF_outer/dredᵀ (J·p).  Returns the image-shaped contributions."""
        dom, B, nblk = self.con_block
        F_in, _, _ = self._fns_for_block(B)
        dom_slots, stat, _ = self._blocked_split()
        X, u_static, do_dred = store["X"], store["u_static"], store["do_dred"]

        def merged(uv, vals):
            out = list(uv)
            for i, v in zip(dom_slots, vals):
                out[i] = v
            return out

        def pblock(b):
            cb = (dom, b * B, B)
            out = []
            for i in dom_slots:
                s = self.uslots[i]
                flat, shape = self._flat(s, consts["sparse_dev"], cb, consts["device"])
                out.append(self._gather_grid(p[s.image.name].reshape(-1, s.image.channels).T,
                                             flat, shape))
            return out

        Jp = None
        for i, J in store["J_stat"].items():
            pv = self.gather_slot(i, p, consts)[None]
            term = (J * pv).sum(1)
            term = term.reshape(term.shape[0], self.R, -1).sum(-1)
            Jp = term if Jp is None else Jp + term
        if dom_slots:
            t = None
            for b in range(nblk):
                uv, cv, bv, iv = self._blocked_operands(X, consts, b, u_static)
                _, tb = torch.func.jvp(
                    lambda ud: F_in(merged(uv, ud), consts, cvals=cv, barrs=bv, iarrs=iv),
                    ([uv[i] for i in dom_slots],), (pblock(b),))
                t = tb if t is None else t + tb
                del uv, cv, bv, iv, tb
            term = (do_dred * t[None]).sum(1)
            Jp = term if Jp is None else Jp + term
        out = {}

        def add(name, v):
            out[name] = out[name] + v if name in out else v

        for i, J in store["J_stat"].items():
            jpb = Jp.reshape(Jp.shape[:1] + (1,) + Jp.shape[1:] + (1,) * (J.ndim - 3))
            add(self.uslots[i].image.name, self.scatter_slot(i, (J * jpb).sum(0), consts))
        if dom_slots:
            w = (do_dred * Jp[:, None]).sum(0)  # [nRN, R]
            for b in range(nblk):
                uv, cv, bv, iv = self._blocked_operands(X, consts, b, u_static)
                _, vjp_d = torch.func.vjp(
                    lambda ud: F_in(merged(uv, ud), consts, cvals=cv, barrs=bv, iarrs=iv),
                    [uv[i] for i in dom_slots])
                g = vjp_d(w)[0]
                del vjp_d, uv, cv, bv, iv
                for k, i in enumerate(dom_slots):
                    add(self.uslots[i].image.name, self._scatter_blocked(i, g[k], consts, b))
                del g
        return out


def lower_pointwise(exprs: List[Exp], spec, sizes, dtype, name="expr"):
    """Lower standalone expressions (the Exclude guards) over their own
    external domains (thallo_tpu/lower.py:1785); returns (group,
    evaluate(consts, X) -> [*ext_shape, rc])."""
    g = LoweredGroup(name, exprs, spec, sizes, dtype)
    if g.con_domains:
        raise ValueError("pointwise expression must not contain contractions")

    def evaluate(consts, X=None):
        return g.residuals_cm(X, None, consts).T.reshape(g.ext_shape + (g.rc,))

    return g, evaluate
