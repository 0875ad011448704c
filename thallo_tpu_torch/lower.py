"""Lowering of residual groups to torch (counterpart of
``thallo_tpu/lower.py``).

A group iterates its external domains; every image access becomes a
slot.  A stencil access (a grid offset over the image's own axes, e.g.
``X(x + 1, y)``) is gathered by ``torch.roll`` of the image with torus
wrap, as the JAX package's ``_roll_plan`` does, and scattered by the roll
back; every other access gathers by flat element indices evaluated once,
on the host, from the concrete sparse maps.  ``InBounds`` and index
values become [R] f32 arrays at ``prepared_consts`` (JAX's barrs and
iarrs).  The residual is evaluated CHANNEL-MAJOR: each unknown slot is
``[C, R]`` and every DAG op runs elementwise over the R residual points,
so the batch axis is written out and no ``vmap`` is needed.  Point
Jacobians come from ``torch.func.vjp`` (one cotangent per residual
channel) or ``torch.func.jvp`` (one tangent per unknown channel, batched
by ``torch.func.vmap``), by JAX's rule: reverse mode where 2 * rc is below
the unknown channels.

The materialized-J schedules (PRECOMPUTE_J, APPLY_SEPARATELY) also need the
slot gather and its transpose, the scatter-add of per-point values into
the slot's image.  ``scatter_slot`` routes a gathered slot as thallo_tpu's
``_scatter`` does (``lower.py:706-747``): through the destination-tiled
segment sum (ops/segsum.py) when ``THALLO_SEGSUM=tiled`` built a plan for
the slot at init; else, for a small image gathered from a large domain
(S <= 1024 and R > 4S), through ``oh_setup_aggregate`` (ops/ohsetup.py);
else through ``index_add_``, the counterpart of ``jax.ops.segment_sum``.

Not ported yet (they raise NotImplementedError at plan time, ROADMAP
queue 1, item 6): contractions (``Sum``), materialized computed arrays
and sampled images.
"""
from __future__ import annotations

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
from .ops.segsum import build_plan, segment_sum

ONEHOT_MAX_SEGMENTS = 1024  # thallo_tpu/ops/segsum.py: small-image scatter bound


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
# index evaluation (host, numpy) over the external grid
# ---------------------------------------------------------------------------
class _IndexEnv:
    """Evaluates AffineComp/SparseComp index expressions to int32 numpy
    arrays over the external grid.  Index tables are built once per
    init from the concrete sparse maps, on the host."""

    def __init__(self, axes: Dict[IndexDomain, int], shape: Tuple[int, ...], sparse_data):
        self.axes = axes  # domain -> axis position
        self.shape = shape
        self.sparse_data = sparse_data  # name -> [prod(in_dims), n_out] int32

    def _iota(self, axis):
        n = self.shape[axis]
        view = [1] * len(self.shape)
        view[axis] = n
        return np.broadcast_to(np.arange(n, dtype=np.int32).reshape(view), self.shape)

    def eval(self, comp: AffineComp):
        val = np.full(self.shape, comp.offset, dtype=np.int32)
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
            if ax != k or self.shape[ax] != d_in.size:
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
        return np.take(data[:, sc.component], flat, axis=0)


# ---------------------------------------------------------------------------
# the lowered group
# ---------------------------------------------------------------------------
class LoweredGroup:
    """A residual group compiled against concrete dim sizes.

    Solver-facing API (see solver/gn.py), channel-major:
      residuals_cm(X, inputs, consts)        -> [rc, R]
      point_jacobians_cm(X, inputs, consts)  -> (r [rc, R], [rc, C_i, R] per slot)
      gather_slot / scatter_slot             -> [C, R] / image-shaped [*dims, F]
    and the JAX package's row-major views residuals -> [R, rc],
    point_jacobians -> (r [R, rc], [R, rc, C_i] per slot).
    """

    def __init__(self, name: str, exprs: List[Exp], spec, sizes: Dict[str, int], dtype,
                 domain_order=None):
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
        if domain_order:
            want = [d for d in domain_order if d in self.ext_domains]
            self.ext_domains = want + [d for d in self.ext_domains if d not in want]
        self.con_domains = col.con_domains
        self.ext_shape = tuple(d.dim.size for d in self.ext_domains)
        self.R = int(np.prod(self.ext_shape)) if self.ext_shape else 1
        self.uslots: List[SlotSpec] = list(col.uslots.values())
        self.cslots: List[SlotSpec] = list(col.cslots.values())
        self.mslots: List[SlotSpec] = list(col.mslots.values())
        self.rc = len(exprs)
        missing = [what for what, present in (
            ("contractions (Sum)", self.con_domains),
            ("materialized computed arrays", self.mslots),
            ("sampled images", col.sampled),
        ) if present]
        if missing:
            raise NotImplementedError(
                f"residual group {name!r} uses {', '.join(missing)}, which "
                "thallo_tpu_torch does not lower yet (ROADMAP queue 1, item 6)")
        # stencil slots: gathered by torch.roll of the image (torus wrap)
        self._rolls = [self._roll_plan(s) for s in self.uslots]
        self._crolls = [self._roll_plan(s) for s in self.cslots]
        self._F = self._build_local_fn()

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
        """A graph group: some unknown slot is a real gather, not a stencil
        roll (the JAX package's default_schedule test)."""
        return any(rp is None for rp in self._rolls)

    def _sparse_arrays(self, inputs):
        out = {}
        for sm in self.spec.sparse_maps:
            if inputs is not None and sm.name in inputs:
                arr = np.asarray(inputs[sm.name], dtype=np.int32)
                out[sm.name] = arr.reshape(-1, len(sm.out_dims))
        return out

    def _env(self, inputs):
        axes = {d: i for i, d in enumerate(self.ext_domains)}
        return _IndexEnv(axes, self.ext_shape, self._sparse_arrays(inputs))

    def _slot_flat_indices(self, slot: SlotSpec, inputs):
        """[R] int32 flat element indices of the slot's image (host); a
        stencil slot's wrap around the torus, as its roll does."""
        env = self._env(inputs)
        im = slot.image
        flat = None
        for j, c in enumerate(slot.comps):
            n = im.dims[j].size
            v = env.eval(c) % n
            flat = v if flat is None else flat * n + v
        return np.array(np.broadcast_to(flat, self.ext_shape), dtype=np.int32).reshape(-1)

    def _bounds_value(self, b: BoundsAccess, env):
        """[R] f32 0/1: the InBounds test of every grid point (host)."""
        ok = None
        for c, dm in zip(b.comps, b.dims):
            v = env.eval(c)
            cond = (v >= b.expand) & (v < dm.size - b.expand)
            ok = cond if ok is None else (ok & cond)
        return np.broadcast_to(ok, self.ext_shape).reshape(-1).astype(np.float32)

    def _ival_value(self, iv: IndexValue, env):
        """[R] f32: an index expression's value at every grid point (host)."""
        return np.broadcast_to(env.eval(iv.comp), self.ext_shape).reshape(-1).astype(np.float32)

    # -- per-solve constants -------------------------------------------------
    def prepared_consts(self, inputs, device, want_bsr=False, onehot_exclude=()):
        """Everything non-differentiated, computed once per init: slot
        index tables of the gathered slots (host -> device once; None for
        stencil slots), channel-major const-slot values, InBounds and
        index-value arrays ([R] f32 each, JAX's barrs/iarrs), params, and,
        when the schedule materializes JᵀJ, the static block-sparse tables
        (solver/blocksparse.py); otherwise the scatter route of each
        gathered slot: a segment-sum plan ("stables", with
        THALLO_SEGSUM=tiled, read here as thallo_tpu reads it) or the
        int32 ids of a small image for the aggregation kernel.
        onehot_exclude: image names that build row tables instead of
        one-hot rows (an image that schur_dense eliminates)."""
        idx = [self._slot_flat_indices(s, inputs) for s in self.uslots]
        cvals = []
        for s, rp in zip(self.cslots, self._crolls):
            im = s.image
            img = inputs[im.name].reshape(tuple(d.size for d in im.dims) + (im.channels,))
            if rp is not None:
                cvals.append(self._roll_gather(img.movedim(-1, 0), rp))
                continue
            flat = torch.from_numpy(self._slot_flat_indices(s, inputs)).to(
                device=img.device, dtype=torch.long)
            cvals.append(img.reshape(-1, im.channels).index_select(0, flat).T.contiguous())
        env = self._env(inputs)

        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=self.dtype)

        barrs = [upload(self._bounds_value(b, env)) for b in self.col.bounds.values()]
        iarrs = [upload(self._ival_value(v, env)) for v in self.col.ivals.values()]
        params = {p.name: inputs[p.name] for p in self.col.params.values()}
        bsr = None
        stables, agg_ids = {}, {}
        if want_bsr:
            from .solver.blocksparse import build_group_bsr

            bsr = build_group_bsr(self, idx, self.dtype, device, onehot_exclude)
        else:
            tiled = os.environ.get("THALLO_SEGSUM") == "tiled"
            for i, flat in enumerate(idx):
                if self._rolls[i] is not None:
                    continue  # the roll back, not a segment sum
                S = self.slot_size(i)
                plan = build_plan(flat, S, device=device) if tiled else None
                if plan is not None:
                    stables[i] = plan
                elif S <= ONEHOT_MAX_SEGMENTS and self.R > 4 * S:
                    agg_ids[i] = torch.from_numpy(flat).to(device)
        return {
            "device": torch.device(device),
            "bsr": bsr,
            "slot_idx": [None if rp is not None else
                         torch.from_numpy(i).to(device=device, dtype=torch.long)
                         for i, rp in zip(idx, self._rolls)],
            "cvals": cvals,
            "barrs": barrs,
            "iarrs": iarrs,
            "params": params,
            "stables": stables,
            "agg_ids": agg_ids,
        }

    def slot_size(self, i: int) -> int:
        """Element count of unknown slot i's image."""
        return int(np.prod([d.size for d in self.uslots[i].image.dims]))

    # -- the local function -------------------------------------------------
    def _build_local_fn(self):
        """The residual evaluator over channel-major slot values: every
        leaf is an [R] row (or a 0-d constant/param), every op is
        elementwise, the result is [rc, R]."""
        ops = _make_ops(self.dtype)
        ukeys = {s.key: i for i, s in enumerate(self.uslots)}
        ckeys = {s.key: i for i, s in enumerate(self.cslots)}
        bkeys = {k: i for i, k in enumerate(self.col.bounds.keys())}
        ikeys = {k: i for i, k in enumerate(self.col.ivals.keys())}
        exprs = self.exprs
        R = self.R
        const_cache = {}

        def const(value, device):
            key = (value, device)
            t = const_cache.get(key)
            if t is None:
                t = const_cache[key] = torch.tensor(value, dtype=self.dtype, device=device)
            return t

        def F(uvals, consts):
            cvals, device = consts["cvals"], consts["device"]
            cache = {}

            def ev(e: Exp):
                r = cache.get(id(e))
                if r is not None:
                    return r
                if isinstance(e, Const):
                    r = const(e.value, device)
                elif isinstance(e, Apply):
                    r = ops[e.op](*[ev(a) for a in e.args])
                elif isinstance(e, ImageAccess):
                    k = (id(e.image), e.comps)
                    if e.image.kind == "unknown":
                        r = uvals[ukeys[k]][e.channel]
                    else:
                        r = cvals[ckeys[k]][e.channel]
                elif isinstance(e, BoundsAccess):
                    r = consts["barrs"][bkeys[("bounds", e.comps, e.dims, e.expand)]]
                elif isinstance(e, IndexValue):
                    r = consts["iarrs"][ikeys[("ival", e.comp)]]
                elif isinstance(e, ParamValue):
                    r = consts["params"][e.param.name]
                else:
                    raise TypeError(f"unhandled node {e!r}")
                cache[id(e)] = r
                return r

            return torch.stack([ev(e).expand(R) for e in exprs])

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
        """[C_i, R] per unknown slot: stencil slots by rolls of the image,
        laid out channel-major once per image, the others by minor-axis
        gathers of [C, N] sources."""
        out, cm = [], {}
        for i, s in enumerate(self.uslots):
            name = s.image.name
            rp = self._rolls[i]
            if rp is None:
                src = X[name].reshape(-1, s.image.channels).T
                out.append(src.index_select(1, consts["slot_idx"][i]))
                continue
            if name not in cm:
                cm[name] = X[name].movedim(-1, 0).contiguous()
            out.append(self._roll_gather(cm[name], rp))
        return out

    def gather_slot(self, i: int, X, consts):
        """[C, R] channel-major values of unknown slot i (X may be any
        image-shaped tree over the unknowns, e.g. a PCG direction)."""
        img = X[self.uslots[i].image.name]
        rp = self._rolls[i]
        if rp is not None:
            return self._roll_gather(img.movedim(-1, 0), rp)
        # the array's own channel count: a mask is gathered through an
        # unknown's slot with one channel
        return img.reshape(-1, img.shape[-1]).T.index_select(1, consts["slot_idx"][i])

    def gather_mask(self, i: int, mask, consts):
        """[R] values of a channelless mask [*dims] at unknown slot i."""
        return self.gather_slot(i, {self.uslots[i].image.name: mask[..., None]}, consts)[0]

    def scatter_slot(self, i: int, valsT, consts):
        """Transpose of gather_slot: per-point values [F, R] summed into
        slot i's image, returned image-shaped [*dims, F].  A stencil slot
        rolls back; the others route as thallo_tpu's _scatter: segment-sum
        plan, else the aggregation kernel for a small image, else
        index_add_."""
        rp = self._rolls[i]
        if rp is not None:
            return self._roll_scatter(valsT, rp)
        F = valsT.shape[0]
        N = self.slot_size(i)
        stable = consts["stables"].get(i)
        if stable is not None:
            out = segment_sum(valsT.T, stable)  # [N, F]
        else:
            ids = consts["agg_ids"].get(i)
            if ids is not None:
                outT = oh_setup_aggregate(valsT.contiguous(), ids, N=N)
            else:
                outT = torch.zeros((F, N), dtype=valsT.dtype, device=valsT.device)
                outT.index_add_(1, consts["slot_idx"][i], valsT)
            out = outT.T
        return out.reshape(tuple(d.size for d in self.uslots[i].image.dims) + (F,))

    # -- residuals and point Jacobians ------------------------------------------
    def residuals_cm(self, X, inputs, consts):
        """r(U): [rc, R] channel-major."""
        return self._F(self.gather_all_cm(X, consts), consts)

    def residuals(self, X, inputs, consts):
        """r(U): [R, rc], thallo_tpu's layout (a view of residuals_cm)."""
        return self.residuals_cm(X, inputs, consts).T

    def _use_rev_mode(self, total_channels: int) -> bool:
        """Forward mode costs one tangent pass per unknown channel, reverse
        one (~2x-priced) cotangent pass per residual channel
        (thallo_tpu/lower.py:1185).  THALLO_JAC_MODE=fwd/rev overrides."""
        mode = os.environ.get("THALLO_JAC_MODE", "auto")
        if mode == "auto":
            return 2 * self.rc < total_channels
        return mode == "rev"

    def point_jacobians_cm(self, X, inputs, consts):
        """(r [rc, R], jacsT list of [rc, C_i, R]).  Reverse mode (2*rc
        below the unknown channels, e.g. BA): one torch.func.vjp cotangent
        per residual channel.  Forward mode (grid energies such as
        image_warping): one torch.func.jvp tangent per unknown channel, the
        tangents batched by torch.func.vmap so the primal runs once."""
        uvalsT = self.gather_all_cm(X, consts)

        def f(uv):
            return self._F(uv, consts)

        if self._use_rev_mode(sum(s.image.channels for s in self.uslots)):
            r, vjp_fn = torch.func.vjp(f, uvalsT)
            rows = []
            for c in range(self.rc):
                ct = torch.zeros_like(r)
                ct[c] = 1.0
                rows.append(vjp_fn(ct)[0])  # list of [C_i, R]
            jacsT = [torch.stack([rows[c][i] for c in range(self.rc)])
                     for i in range(len(self.uslots))]
            return r.detach(), jacsT
        chans = [(i, c) for i, s in enumerate(self.uslots) for c in range(s.image.channels)]
        tangents = []
        for i, v in enumerate(uvalsT):
            t = torch.zeros((len(chans),) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, (si, c) in enumerate(chans):
                if si == i:
                    t[k, c] = 1.0
            tangents.append(t)
        cols = torch.func.vmap(lambda t: torch.func.jvp(f, (uvalsT,), (t,))[1])(tangents)
        jacsT, k = [], 0
        for s in self.uslots:
            C = s.image.channels
            jacsT.append(cols[k:k + C].transpose(0, 1))  # [rc, C, R]
            k += C
        return f(uvalsT), jacsT

    def point_jacobians(self, X, inputs, consts):
        """(r [R, rc], jacs list of [R, rc, C_i]): thallo_tpu's layout."""
        r, jacsT = self.point_jacobians_cm(X, inputs, consts)
        return r.T, [J.permute(2, 0, 1) for J in jacsT]


def lower_pointwise(exprs: List[Exp], spec, sizes, dtype, name="expr"):
    """Lower standalone expressions (the Exclude guards) over their own
    external domains (thallo_tpu/lower.py:1785); returns (group,
    evaluate(consts, X) -> [*ext_shape, rc])."""
    g = LoweredGroup(name, exprs, spec, sizes, dtype)

    def evaluate(consts, X=None):
        return g.residuals_cm(X, None, consts).T.reshape(g.ext_shape + (g.rc,))

    return g, evaluate
