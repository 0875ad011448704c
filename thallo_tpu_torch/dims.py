"""Dimensions, index domains, and index expressions.

Mirrors the reference's index algebra (API/src/ir.t:17-43:
`Dim`, `IndexSpace`, `IndexDomain`, `IndexComponent{Direct,Sparse,Constant,
BinOp}`) but TPU-first: index components are *affine combinations* of
iteration domains plus sparse-map gathers.  At lowering time each component
evaluates to an int32 index array over the residual grid; grid-offset
accesses specialize to `jnp.roll` (torus wrap semantics, matching the
reference's `IndexSpace:indextype().wrap()` API/src/
thallo.t:609-738), everything else becomes a vectorized gather.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

_uid_counter = itertools.count()


class Dim:
    """A named problem dimension, bound to a concrete size at plan() time
    (the reference binds dims from the C `dimensions` array at plan time,
    API/src/thallo.t:577-584)."""

    def __init__(self, name: str, index: Optional[int] = None):
        self.name = name
        self.index = index
        self.size = None  # bound at plan() time
        self.uid = next(_uid_counter)

    def __call__(self) -> "IndexDomain":
        """Create a fresh iteration domain over this dim (`x = W()`)."""
        return IndexDomain(self)

    def __repr__(self):
        return f"Dim({self.name})"


class IndexDomain:
    """One iteration variable over a Dim.  Two calls of W() give distinct
    domains (needed for cross-product residual spaces, e.g. the reference's
    procrustes N x U energies)."""

    def __init__(self, dim: Dim, name: Optional[str] = None):
        self.dim = dim
        self.uid = next(_uid_counter)
        self.name = name or f"{dim.name}_{self.uid}"

    # -- index arithmetic -> AffineComp ------------------------------------
    def _affine(self) -> "AffineComp":
        return AffineComp(((self, 1),), 0)

    def __add__(self, other):
        return self._affine() + other

    def __radd__(self, other):
        return self._affine() + other

    def __sub__(self, other):
        return self._affine() - other

    def __rsub__(self, other):
        return (-1 * self._affine()) + other

    def __neg__(self):
        return -1 * self._affine()

    def __mul__(self, k):
        return self._affine() * k

    def __rmul__(self, k):
        return self._affine() * k

    def asvalue(self):
        """The index value as a float expression (reference `x:asvalue()`,
        IndexValue VarDef API/src/ir.t:39-43)."""
        from .expr import IndexValue

        return IndexValue(self._affine())

    def __repr__(self):
        return self.name


class AffineComp:
    """offset + sum(coeff * base) where base is an IndexDomain or a
    SparseComp (a gathered index)."""

    __slots__ = ("terms", "offset", "_hash")

    def __init__(self, terms: Tuple[Tuple[object, int], ...], offset: int):
        # canonical order by uid for structural equality
        terms = tuple(sorted((t for t in terms if t[1] != 0), key=lambda t: _base_uid(t[0])))
        self.terms = terms
        self.offset = int(offset)
        self._hash = hash((self.terms, self.offset))

    def __add__(self, other):
        other = normalize_index(other)
        if isinstance(other, AffineComp):
            return _affine_sum(self, other, 1)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        other = normalize_index(other)
        if isinstance(other, AffineComp):
            return _affine_sum(self, other, -1)
        return NotImplemented

    def __rsub__(self, other):
        return (self * -1) + other

    def __neg__(self):
        return self * -1

    def __mul__(self, k):
        if not isinstance(k, int):
            return NotImplemented
        return AffineComp(tuple((b, c * k) for b, c in self.terms), self.offset * k)

    __rmul__ = __mul__

    def domains(self):
        """All IndexDomains reachable (including through sparse args)."""
        out = []
        for b, _ in self.terms:
            if isinstance(b, IndexDomain):
                out.append(b)
            else:
                out.extend(b.domains())
        return out

    def asvalue(self):
        from .expr import IndexValue

        return IndexValue(self)

    def __eq__(self, other):
        return (
            isinstance(other, AffineComp)
            and self.terms == other.terms
            and self.offset == other.offset
        )

    def __hash__(self):
        return self._hash

    def __repr__(self):
        parts = [f"{c}*{b}" if c != 1 else f"{b}" for b, c in self.terms]
        if self.offset or not parts:
            parts.append(str(self.offset))
        return "+".join(parts)

    # Pure single-domain offset access (the roll-able fast path)?
    def as_single_offset(self):
        if len(self.terms) == 1:
            b, c = self.terms[0]
            if isinstance(b, IndexDomain) and c == 1:
                return b, self.offset
        return None


class SparseComp:
    """One output component of a sparse-map gather, e.g. `v0(e)` (reference
    `Sparse` problem param, API/src/thallo.t:1950-1989: a map
    from an in-space point to an out-space index tuple, stored as int32
    arrays)."""

    __slots__ = ("sparse", "args", "component", "uid", "_hash")

    def __init__(self, sparse, args: Tuple[AffineComp, ...], component: int):
        self.sparse = sparse
        self.args = args
        self.component = component
        self.uid = next(_uid_counter)
        self._hash = hash((id(sparse), args, component))

    def domains(self):
        out = []
        for a in self.args:
            out.extend(a.domains())
        return out

    def _affine(self):
        return AffineComp(((self, 1),), 0)

    def __add__(self, other):
        return self._affine() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._affine() - other

    def __rsub__(self, other):
        return (-1 * self._affine()) + other

    def __mul__(self, k):
        return self._affine() * k

    __rmul__ = __mul__

    def asvalue(self):
        from .expr import IndexValue

        return IndexValue(self._affine())

    def __eq__(self, other):
        return (
            isinstance(other, SparseComp)
            and self.sparse is other.sparse
            and self.args == other.args
            and self.component == other.component
        )

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"{self.sparse.name}[{self.component}]({','.join(map(repr, self.args))})"


def _base_uid(b):
    return b.uid


def _affine_sum(a: AffineComp, b: AffineComp, sign: int) -> AffineComp:
    terms: Dict[object, int] = {}
    for base, c in a.terms:
        terms[base] = terms.get(base, 0) + c
    for base, c in b.terms:
        terms[base] = terms.get(base, 0) + sign * c
    return AffineComp(tuple(terms.items()), a.offset + sign * b.offset)


def normalize_index(comp) -> AffineComp:
    """Coerce a user-written index component into an AffineComp."""
    if isinstance(comp, AffineComp):
        return comp
    if isinstance(comp, IndexDomain):
        return comp._affine()
    if isinstance(comp, SparseComp):
        return comp._affine()
    if isinstance(comp, int):
        return AffineComp((), comp)
    raise TypeError(f"cannot use {comp!r} as an index component")
