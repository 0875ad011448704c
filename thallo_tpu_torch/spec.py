"""Problem specification and scheduling handles.

Mirrors the reference's ProblemSpecAD / Energy / NamedResidual objects and
their user-facing schedule controls (API/src/thallo.t:
4096-4135 `get_schedule`, 5634-5782 reorder/merge/split/set_materialize).

The 5-way JTJp schedule survives intact as a per-residual-group enum:
  INLINE               -> jvp+vjp each PCG step (recompute derivatives)
  PRECOMPUTE_J         -> materialize per-point Jacobian blocks
  PRECOMPUTE_JTJ       -> materialize J^T J (dense when small, else blocks)
  PRECOMPUTE_J_THEN_JTJ-> materialize J then gemm J^T J
  APPLY_SEPARATELY     -> materialize J.p then apply J^T
(reference JTJpSchedule, API/src/ir.t:64-68; the
materialize-flag -> schedule mapping is get_schedule, thallo.t:4100-4134.)
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

from .dims import Dim
from .expr import Exp, channels, toexp
from .inputs import Image, Param, SparseMap
from .typesys import as_vectype


class JTJpSchedule(enum.Enum):
    INLINE = "inline"
    PRECOMPUTE_J = "precompute_j"
    PRECOMPUTE_JTJ = "precompute_jtj"
    PRECOMPUTE_J_THEN_JTJ = "precompute_j_then_jtj"
    APPLY_SEPARATELY = "apply_separately"
    # TPU-first addition: jax.linearize once per nonlinear iteration, then
    # linear apply + transpose per PCG step.  Matrix-free like INLINE but
    # without re-deriving the forward pass every step (XLA stores the
    # linearization residuals).  This is the default for unscheduled
    # groups; the reference's default is INLINE recompute (its GPU kernels
    # are gather-bound, ours are fusion-friendly).
    LINEARIZE = "linearize"


class _MaterializeHandle:
    """r.fit.J / r.fit.JtJ / r.fit.Jp with set_materialize(bool), mirroring
    the reference's schedule API (thallo.t:5761-5772)."""

    def __init__(self, residual: "NamedResidual", which: str):
        self._residual = residual
        self._which = which

    def set_materialize(self, flag: bool = True):
        self._residual._materialize[self._which] = bool(flag)
        return self._residual

    def set_sparse(self, flag: bool = True):
        self._residual._sparse_mat[self._which] = bool(flag)
        return self._residual

    def compute_at_output(self, flag: bool = True):
        # loop-order hint in the reference; a no-op for XLA (it owns layout)
        self._residual._compute_at_output[self._which] = bool(flag)
        return self._residual


class NamedResidual:
    """One named residual term (or list of terms sharing a name)."""

    def __init__(self, name: str, exprs: List[Exp]):
        self.name = name
        self.exprs = exprs  # flattened scalar expressions (channels)
        self._materialize = {"J": False, "JtJ": False, "Jp": False}
        self._sparse_mat = {}
        self._compute_at_output = {}
        self._reorder: Optional[list] = None
        self.JtF = _MaterializeHandle(self, "JtF")

    @property
    def J(self):
        return _MaterializeHandle(self, "J")

    @property
    def JtJ(self):
        return _MaterializeHandle(self, "JtJ")

    @property
    def Jp(self):
        return _MaterializeHandle(self, "Jp")

    def reorder(self, domains):
        """Set this residual group's external iteration order (reference
        thallo.t:5665).  On TPU the order decides the row-major
        flattening of the residual grid: which domain varies fastest in
        every gather/scatter index table and which axis of multi-dim
        intermediates lands in the 128-lane tile (the locality role the
        reference's loop order plays for warp coherence).  The listed
        domains come first; unlisted ones keep discovery order.
        Answer-invariant; enumerated by the exhaustive autoscheduler
        (schedule.enumerate_domain_orders)."""
        self._reorder = list(domains)
        return self

    def split(self, domain, factor):
        """Domain-split hint (reference split/full_split, thallo.t:
        5678-5727: blocks a domain's iteration for GPU tiling).  XLA/
        Mosaic own tiling on TPU; recorded as metadata only."""
        self._splits = getattr(self, "_splits", [])
        self._splits.append((domain, int(factor)))
        return self

    def full_split(self):
        """See split()."""
        self._splits = getattr(self, "_splits", []) + ["full"]
        return self

    def compute_at_output(self, flag=True):
        self._compute_at_output["self"] = bool(flag)
        return self

    def get_schedule(self, default=None) -> JTJpSchedule:
        """The materialize-flag -> 5-way schedule mapping (reference
        get_schedule, thallo.t:4100-4134).  Unscheduled groups default to
        LINEARIZE (TPU-first; pass default=JTJpSchedule.INLINE for the
        reference's recompute behavior)."""
        # set_sparse(X) implies materializing X (the reference's
        # set_sparse acts on already-materialized tensors; alone it would
        # otherwise be silently dropped)
        J, JtJ, Jp = (
            self._materialize["J"] or self._sparse_mat.get("J", False),
            self._materialize["JtJ"] or self._sparse_mat.get("JtJ", False),
            self._materialize["Jp"] or self._sparse_mat.get("Jp", False),
        )
        if J and JtJ:
            return JTJpSchedule.PRECOMPUTE_J_THEN_JTJ
        if J:
            return JTJpSchedule.PRECOMPUTE_J
        if JtJ:
            return JTJpSchedule.PRECOMPUTE_JTJ
        if Jp:
            return JTJpSchedule.APPLY_SEPARATELY
        return default or JTJpSchedule.LINEARIZE

    def __repr__(self):
        return f"residual:{self.name}[{len(self.exprs)}ch]"


class Energy:
    """The named-residual collection returned by Residuals{...} (reference
    Energy, thallo.t:4096).  Attribute access returns NamedResiduals for
    scheduling."""

    def __init__(self, residuals: Dict[str, NamedResidual]):
        self._residuals = dict(residuals)
        self._merges: List[List[str]] = []

    def __getattr__(self, name):
        try:
            return self.__dict__["_residuals"][name]
        except KeyError:
            raise AttributeError(name)

    def __getitem__(self, name):
        return self._residuals[name]

    def __iter__(self):
        return iter(self._residuals.values())

    def names(self):
        return list(self._residuals.keys())

    def merge(self, *rs):
        """Fuse residual groups (reference merge, thallo.t:5678-5727).  On
        TPU this is a grouping hint: merged residuals are lowered into one
        vmapped local function."""
        names = [r.name if isinstance(r, NamedResidual) else str(r) for r in rs]
        self._merges.append(names)
        merged = self._residuals[names[0]]
        return merged


class ProblemSpec:
    """The typed problem specification built by the DSL (analog of
    ProblemSpecAD, API/src/thallo.t:1580-2330)."""

    def __init__(self, double_precision: bool = False):
        self.dims: List[Dim] = []
        self.unknowns: List[Image] = []
        self.arrays: List[Image] = []
        self.computed: List[Image] = []
        self.sparse_maps: List[SparseMap] = []
        self.params: List[Param] = []
        self.energy: Optional[Energy] = None
        self.use_preconditioner = True
        self.double_precision = double_precision
        self._names = {}

    # -- construction ------------------------------------------------------
    def dim(self, name: str, index: Optional[int] = None) -> Dim:
        d = Dim(name, index if index is not None else len(self.dims))
        self.dims.append(d)
        return d

    def Dims(self, *names):
        out = tuple(self.dim(n) for n in names)
        return out if len(out) > 1 else out[0]

    def _register(self, name, obj):
        if name in self._names:
            raise ValueError(f"duplicate input name {name}")
        self._names[name] = obj
        return obj

    def Unknown(self, name, vtype, dims, argpos=None) -> Image:
        im = Image(name, as_vectype(vtype), tuple(dims), "unknown", argpos)
        self.unknowns.append(im)
        return self._register(name, im)

    def Array(self, name, vtype, dims, argpos=None) -> Image:
        im = Image(name, as_vectype(vtype), tuple(dims), "array", argpos)
        self.arrays.append(im)
        return self._register(name, im)

    def Sparse(self, name, in_dims, out_dims, argpos=None) -> SparseMap:
        sm = SparseMap(name, tuple(in_dims), tuple(out_dims), argpos)
        self.sparse_maps.append(sm)
        return self._register(name, sm)

    def Param(self, name, dtype=float, argpos=None) -> Param:
        p = Param(name, dtype, argpos)
        self.params.append(p)
        return self._register(name, p)

    def ComputedArray(self, name, dims, expr, domains=None) -> Image:
        """A named precomputed expression array (reference ComputedArray,
        thallo.t:1777-1822).  Gradients flow through automatically via JAX
        when inlined; when materialized it is recomputed once per nonlinear
        iteration."""
        exprs = channels(expr)
        im = Image(name, as_vectype(len(exprs)), tuple(dims), "computed")
        im.expression = exprs
        im.domains = domains
        self.computed.append(im)
        return self._register(name, im)

    def UsePreconditioner(self, flag: bool):
        self.use_preconditioner = bool(flag)

    def Residuals(self, **named) -> Energy:
        residuals = {}
        for name, val in named.items():
            if isinstance(val, (list, tuple)):
                exprs = []
                for v in val:
                    exprs.extend(channels(v))
            else:
                exprs = channels(val)
            residuals[name] = NamedResidual(name, [toexp(e) for e in exprs])
        self.energy = Energy(residuals)
        return self.energy

    # -- plan --------------------------------------------------------------
    def plan(self, dim_sizes, solver="gauss_newton", **options):
        """Bind dim sizes and compile the solver (analog of
        Thallo_ProblemPlan, API/src/thallo.t:1384-1434)."""
        from .plan import make_plan

        return make_plan(self, dim_sizes, solver, **options)
