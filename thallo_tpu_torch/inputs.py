"""Problem inputs: images (arrays/unknowns), sparse maps, scalar params,
sampled images.

Mirrors the reference's ProblemSpecAD input constructors
(API/src/thallo.t:1610-1683, 1950-1989) and the DSL `Inputs`
dispatcher (API/src/lib.t:568-582).  TPU representation:
every image is a jnp array of shape (*dims, channels); sparse maps are int32
arrays of shape (*in_dims,) per out component.
"""
from __future__ import annotations

from typing import Optional, Tuple

from .dims import AffineComp, Dim, SparseComp, normalize_index
from .expr import BoundsAccess, Exp, ExpVector, ImageAccess, ParamValue, SampleAccess, toexp
from .typesys import VecType, as_vectype


class Image:
    """An N-D array over a tuple of Dims with a channel vector per point.

    kind: "array" (constant input), "unknown" (optimized), "computed"
    (precomputed expression array, reference ComputedArray
    API/src/thallo.t:1777-1822).
    """

    def __init__(
        self,
        name: str,
        vtype: VecType,
        dims: Tuple[Dim, ...],
        kind: str,
        argpos: Optional[int] = None,
    ):
        self.name = name
        self.vtype = as_vectype(vtype)
        self.dims = tuple(dims)
        self.kind = kind
        self.argpos = argpos
        self.exclude_expr = None  # set via Exclude()
        # for computed arrays:
        self.expression = None
        self.domains = None
        self.materialize = False

    def set_materialize(self, flag: bool = True):
        """Computed arrays only: precompute the value array once per
        nonlinear iteration instead of inlining the expression at every
        access (the reference's ComputedArray materialize-vs-inline
        schedule axis, thallo.t:1777-1822, 5192-5231)."""
        if self.kind != "computed":
            raise ValueError("set_materialize applies to computed arrays")
        self.materialize = bool(flag)
        return self

    def set_gradient_materialize(self, flag: bool = True):
        """Recorded hint (reference set_gradient_materialize on
        maybe_computed_arrays, tests/expansive_sparse_materialize): here
        the CA's gradient arrays are materialized exactly when the CA
        itself is (lower.py _ca_vals_and_grads); inline CAs differentiate
        through JAX directly, so a separate gradient-image toggle has no
        execution meaning on TPU."""
        if self.kind != "computed":
            raise ValueError("set_gradient_materialize applies to computed arrays")
        self.gradient_materialize = bool(flag)
        return self

    @property
    def channels(self):
        return self.vtype.channels

    def __call__(self, *idx):
        # trailing-int channel select: Target(n, 0) == Target(n)(0)
        # (reference Image:__call with channel arg, thallo.t:2000-2028)
        channel = None
        flat = []
        for c in idx:
            flat.extend(c) if isinstance(c, tuple) else flat.append(c)
        if len(flat) == len(self.dims) + 1 and isinstance(flat[-1], int):
            channel = flat.pop()
        comps = _normalize_access(tuple(flat), len(self.dims))
        if channel is not None:
            return ImageAccess(self, comps, channel)
        accesses = [ImageAccess(self, comps, c) for c in range(self.channels)]
        if self.channels == 1:
            return accesses[0]
        return ExpVector(accesses)

    def Exclude(self, expr):
        """Freeze unknown points where expr is nonzero (reference
        Image:Exclude, API/src/thallo.t:1993-1997)."""
        if self.kind != "unknown":
            raise ValueError("Exclude is only meaningful on unknowns")
        if self.exclude_expr is None:
            self.exclude_expr = toexp(expr)
        else:
            # multiple excludes OR together
            from .lib_env import Or

            self.exclude_expr = Or(self.exclude_expr, toexp(expr))
        return self

    def __repr__(self):
        return f"{self.kind}:{self.name}{tuple(d.name for d in self.dims)}x{self.channels}"


class SparseMap:
    """A map from an in-space point to an out-space index tuple, backed by
    int32 arrays (reference `Sparse`, API/src/thallo.t:
    1950-1989; C++ side uploads one int32 array per endpoint,
    examples/shared/ThalloGraph.h:19-60)."""

    def __init__(self, name: str, in_dims: Tuple[Dim, ...], out_dims: Tuple[Dim, ...], argpos=None):
        self.name = name
        self.in_dims = tuple(in_dims)
        self.out_dims = tuple(out_dims)
        self.argpos = argpos

    def __call__(self, *idx):
        args = _normalize_access(idx, len(self.in_dims))
        comps = [AffineComp(((SparseComp(self, args, c), 1),), 0) for c in range(len(self.out_dims))]
        if len(comps) == 1:
            return comps[0]
        return tuple(comps)

    def set_coherent(self, flag: bool = True):
        """Memory-coherence hint (reference Sparse:set_coherent, used by
        bundle_adjustment.t): on GPU it steered warp-aggregated scatters;
        on TPU gather/scatter lowering is index-order-agnostic, so this is
        recorded metadata only."""
        self.coherent = bool(flag)
        return self

    def __repr__(self):
        return (
            f"sparse:{self.name}({','.join(d.name for d in self.in_dims)})"
            f"->({','.join(d.name for d in self.out_dims)})"
        )


class Param:
    """A scalar problem parameter (reference `Param`)."""

    def __init__(self, name: str, dtype, argpos=None):
        self.name = name
        self.dtype = dtype
        self.argpos = argpos

    def exp(self) -> Exp:
        return ParamValue(self)

    # allow free arithmetic: params usually used directly as scalars
    def __repr__(self):
        return f"param:{self.name}"


class SampledImage:
    """Bilinear interpolation over a 2-D (or trilinear 3-D) image at traced
    float coordinates, with optional user-supplied derivative images
    (reference SampledImage(Array[, dx, dy]), API/src/
    thallo.t:5784-5923, used by optical_flow.t:11-26).

    If derivative images are not given, the gradient w.r.t. coordinates is
    the analytic derivative of the interpolant itself.
    """

    def __init__(self, image: Image, *derivs: Image, is_array: bool = False,
                 conditional: bool = False):
        self.image = image
        self.derivs = tuple(derivs)
        self.is_array = is_array  # SampledImageArray: (x, y, slice) sampling
        # conditional trilinear semantics (reference thallo.t:931-980):
        # invalid corners (out of bounds / -inf sentinel) are rejected
        # and the interpolation weights renormalized
        self.conditional = conditional
        self.name = f"sampled_{image.name}"

    @property
    def channels(self):
        return self.image.channels

    def __call__(self, *coords):
        coords = tuple(toexp(c) for c in coords)
        if len(coords) != len(self.image.dims):
            raise ValueError("sample coordinate count must match image rank")
        accesses = [SampleAccess(self, coords, c) for c in range(self.channels)]
        if self.channels == 1:
            return accesses[0]
        return ExpVector(accesses)


def _normalize_access(idx, rank):
    # a sparse map over a multi-dim out space returns a tuple of comps; the
    # user passes it straight through: X(v(e)) with v: E -> (N, M)
    flat = []
    for c in idx:
        if isinstance(c, tuple):
            flat.extend(c)
        else:
            flat.append(c)
    if len(flat) != rank:
        raise ValueError(f"access has {len(flat)} index components, image has rank {rank}")
    return tuple(normalize_index(c) for c in flat)


def in_bounds(comps, dims, expand=0) -> Exp:
    return BoundsAccess(tuple(normalize_index(c) for c in comps), dims, expand)
