"""Lowering of graph residual groups to torch (counterpart of
``thallo_tpu/lower.py``, graph subset).

A group iterates its external domains; every image access becomes a
slot whose flat element indices are evaluated once, on the host, from
the concrete sparse maps.  The residual is evaluated CHANNEL-MAJOR:
each unknown slot is gathered as ``[C, R]`` by ``index_select`` and every
DAG op runs elementwise over the R residual points, so the batch axis is
written out and no ``vmap`` is needed.  Point Jacobians come from
``torch.func.vjp``, one cotangent pass per residual channel.

Not ported yet (they raise NotImplementedError at plan time): grid
stencils (roll plans), contractions (``Sum``), bounds and index-value
leaves, materialized computed arrays and sampled images.
"""
from __future__ import annotations

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
    """A graph residual group compiled against concrete dim sizes.

    Solver-facing API (see solver/gn.py):
      residuals_cm(X, inputs, consts)        -> [rc, R]
      point_jacobians_cm(X, inputs, consts)  -> (r [rc, R], [rc, C_i, R] per slot)
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
            ("bounds checks (InBounds)", col.bounds),
            ("index values", col.ivals),
            ("sampled images", col.sampled),
        ) if present]
        if missing:
            raise NotImplementedError(
                f"residual group {name!r} uses {', '.join(missing)}, which "
                "thallo_tpu_torch does not lower yet")
        self._F = self._build_local_fn()

    # -- slot index machinery ----------------------------------------------
    def _roll_plan(self, slot: SlotSpec):
        """If this slot is a pure grid-offset access over distinct external
        domains matching the image's axes, return (ext_axis_per_image_axis,
        shifts) — a stencil access (the JAX package lowers it to a roll)."""
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
    def supports_cm(self) -> bool:
        """Pure graph group: every unknown access is a real gather (no
        stencil slot), the shape the channel-major pipeline and the
        block-sparse tables accept."""
        return not any(self._roll_plan(s) is not None for s in self.uslots)

    def _sparse_arrays(self, inputs):
        out = {}
        for sm in self.spec.sparse_maps:
            if inputs is not None and sm.name in inputs:
                arr = np.asarray(inputs[sm.name], dtype=np.int32)
                out[sm.name] = arr.reshape(-1, len(sm.out_dims))
        return out

    def _slot_flat_indices(self, slot: SlotSpec, inputs):
        """[R] int32 flat element indices of the slot's image (host)."""
        axes = {d: i for i, d in enumerate(self.ext_domains)}
        env = _IndexEnv(axes, self.ext_shape, self._sparse_arrays(inputs))
        im = slot.image
        flat = None
        for j, c in enumerate(slot.comps):
            n = im.dims[j].size
            v = env.eval(c) % n
            flat = v if flat is None else flat * n + v
        return np.array(np.broadcast_to(flat, self.ext_shape), dtype=np.int32).reshape(-1)

    # -- per-solve constants -------------------------------------------------
    def prepared_consts(self, inputs, device, want_bsr=False):
        """Everything non-differentiated, computed once per init: slot
        index tables (host -> device once), channel-major const-slot
        values, params — and, when the schedule materializes JᵀJ, the
        static block-sparse tables (solver/blocksparse.py)."""
        idx = [self._slot_flat_indices(s, inputs) for s in self.uslots]
        cvals = []
        for s in self.cslots:
            im = s.image
            img = inputs[im.name].reshape(-1, im.channels)
            flat = torch.from_numpy(self._slot_flat_indices(s, inputs)).to(
                device=img.device, dtype=torch.long)
            cvals.append(img.index_select(0, flat).T.contiguous())  # [C, R]
        params = {p.name: inputs[p.name] for p in self.col.params.values()}
        bsr = None
        if want_bsr:
            from .solver.blocksparse import build_group_bsr

            bsr = build_group_bsr(self, idx, self.dtype, device)
        return {
            "bsr": bsr,
            "slot_idx": [torch.from_numpy(i).to(device=device, dtype=torch.long)
                         for i in idx],
            "cvals": cvals,
            "params": params,
        }

    # -- the local function -------------------------------------------------
    def _build_local_fn(self):
        """The residual evaluator over channel-major slot values: every
        leaf is an [R] row (or a 0-d constant/param), every op is
        elementwise, the result is [rc, R]."""
        ops = _make_ops(self.dtype)
        ukeys = {s.key: i for i, s in enumerate(self.uslots)}
        ckeys = {s.key: i for i, s in enumerate(self.cslots)}
        exprs = self.exprs
        R = self.R
        const_cache = {}

        def const(value, device):
            key = (value, device)
            t = const_cache.get(key)
            if t is None:
                t = const_cache[key] = torch.tensor(value, dtype=self.dtype, device=device)
            return t

        def F(uvals, cvals, params, device):
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
                elif isinstance(e, ParamValue):
                    r = params[e.param.name]
                else:
                    raise TypeError(f"unhandled node {e!r}")
                cache[id(e)] = r
                return r

            return torch.stack([ev(e).expand(R) for e in exprs])

        return F

    # -- channel-major evaluation (graph groups) -----------------------------
    def gather_all_cm(self, X, consts):
        """[C_i, R] per unknown slot: minor-axis gathers of [C, N] sources."""
        out = []
        for s, flat in zip(self.uslots, consts["slot_idx"]):
            src = X[s.image.name].reshape(-1, s.image.channels).T
            out.append(src.index_select(1, flat))
        return out

    def _eval_cm(self, uvalsT, consts):
        device = consts["slot_idx"][0].device if consts["slot_idx"] else None
        return self._F(uvalsT, consts["cvals"], consts["params"], device)

    def residuals_cm(self, X, inputs, consts):
        """r(U): [rc, R] channel-major."""
        return self._eval_cm(self.gather_all_cm(X, consts), consts)

    def point_jacobians_cm(self, X, inputs, consts):
        """(r [rc, R], jacsT list of [rc, C_i, R]): one reverse-mode VJP per
        residual channel (the mode JAX picks for BA, 2*rc < unknown channels;
        the other mode computes the same Jacobians)."""
        uvalsT = self.gather_all_cm(X, consts)
        r, vjp_fn = torch.func.vjp(lambda uv: self._eval_cm(uv, consts), uvalsT)
        rows = []
        for c in range(self.rc):
            ct = torch.zeros_like(r)
            ct[c] = 1.0
            rows.append(vjp_fn(ct)[0])  # list of [C_i, R]
        jacsT = [torch.stack([rows[c][i] for c in range(self.rc)])
                 for i in range(len(self.uslots))]
        return r.detach(), jacsT
