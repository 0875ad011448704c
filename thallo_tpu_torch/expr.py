"""Scalar expression DAG and channel vectors.

This is the analog of the reference's hash-consed autodiff expression graph
(API/src/ad.t:23-311 `Exp = Var|Apply|Const`, `ExpVector`)
with one deliberate architectural difference: we do NOT implement symbolic
differentiation.  The DAG only records *what* the user wrote; it is lowered
to a pure JAX function (see lower.py) and all derivatives (J.p, J^T.q,
per-point Jacobian blocks, diag(J^T J)) come from jax.jvp/vjp/jacrev.  XLA
then fuses and schedules the result for the TPU's VPU/MXU, replacing the
reference's Terra->PTX kernel codegen.

Boolean semantics follow the reference (API/src/ad.t:818-829):
comparisons evaluate to 0/1 floats so guards compose with `*` and `Select`.
"""
from __future__ import annotations

from typing import Tuple

from .dims import AffineComp


class Exp:
    """Base scalar expression node."""

    __slots__ = ()

    # -- operator overloads ------------------------------------------------
    def __add__(self, o):
        return _binop("add", self, o)

    def __radd__(self, o):
        return _binop("add", o, self)

    def __sub__(self, o):
        return _binop("sub", self, o)

    def __rsub__(self, o):
        return _binop("sub", o, self)

    def __mul__(self, o):
        return _binop("mul", self, o)

    def __rmul__(self, o):
        return _binop("mul", o, self)

    def __truediv__(self, o):
        return _binop("div", self, o)

    def __rtruediv__(self, o):
        return _binop("div", o, self)

    def __pow__(self, o):
        return _binop("pow", self, o)

    def __neg__(self):
        return Apply("neg", (self,))

    def __abs__(self):
        return Apply("abs", (self,))

    # channel-select compatibility: scalar behaves as a 1-vector
    def __call__(self, i):
        if i != 0:
            raise IndexError("scalar expression only has channel 0")
        return self

    def dot(self, other):
        other = toexp(other)
        return self * other

    def sum(self):
        return self

    def get(self, *idx):
        """Materialization hint: treat this expression as an implicit
        computed array over its domains, accessed at `idx` (reference
        `exp:get(...)` -> maybe_computed_array, API/src/
        thallo.t:1868-1893).  Inline by default — the access substitutes
        indices into the expression; a schedule may choose to materialize."""
        return _make_get(channels_of(self), idx)

    @property
    def nchannels(self):
        return 1


class Const(Exp):
    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = float(value)

    def __repr__(self):
        return repr(self.value)


class Apply(Exp):
    __slots__ = ("op", "args")

    def __init__(self, op: str, args: Tuple[Exp, ...]):
        self.op = op
        self.args = tuple(toexp(a) for a in args)

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.args))})"


class ImageAccess(Exp):
    """One channel of an image access X(i, j)(c) (reference `ImageAccess`
    VarDef, API/src/ir.t:39-43)."""

    __slots__ = ("image", "comps", "channel")

    def __init__(self, image, comps: Tuple[AffineComp, ...], channel: int):
        self.image = image
        self.comps = comps
        self.channel = channel

    def __repr__(self):
        return f"{self.image.name}({','.join(map(repr, self.comps))})[{self.channel}]"


    def set_materialize(self, flag: bool = True):
        """Schedule hint on a get()/ComputedArray access: materialize the
        underlying computed image (reference exp:get(...):set_materialize)."""
        self.image.set_materialize(flag)
        return self

    def set_gradient_materialize(self, flag: bool = True):
        self.image.set_gradient_materialize(flag)
        return self

class ParamValue(Exp):
    """A scalar problem parameter (reference `ParamValue`)."""

    __slots__ = ("param",)

    def __init__(self, param):
        self.param = param

    def __repr__(self):
        return f"param:{self.param.name}"


class IndexValue(Exp):
    """The numeric value of an index expression (reference `IndexValue`,
    `x:asvalue()` used e.g. by optical_flow.t:11-26)."""

    __slots__ = ("comp",)

    def __init__(self, comp: AffineComp):
        self.comp = comp

    def __repr__(self):
        return f"val({self.comp})"


class BoundsAccess(Exp):
    """0/1 guard: are the *unwrapped* indices within their dim extents
    (reference `BoundsAccess` built by InBounds/InBoundsExpanded,
    API/src/thallo.t:2091-2112)."""

    __slots__ = ("comps", "dims", "expand")

    def __init__(self, comps: Tuple[AffineComp, ...], dims, expand: int = 0):
        self.comps = comps
        self.dims = tuple(dims)
        self.expand = expand

    def __repr__(self):
        return f"inbounds({','.join(map(repr, self.comps))})"


class Reduction(Exp):
    """Sum over contracted iteration domains (reference `TensorContraction`
    / `Sum`, API/src/thallo.t:5821-5884).  The contracted
    domains become extra grid axes of the residual group; lowering reduces
    over them inside the local function."""

    __slots__ = ("domains", "arg")

    def __init__(self, domains, arg: Exp):
        self.domains = tuple(domains)
        self.arg = toexp(arg)

    def __repr__(self):
        return f"sum({[d.name for d in self.domains]}, {self.arg!r})"


class SampleAccess(Exp):
    """One channel of a bilinearly-sampled image at traced (possibly
    unknown-dependent) coordinates, with user-suppliable derivative images
    (reference SampledImage, API/src/thallo.t:5784-5923)."""

    __slots__ = ("sampled", "coords", "channel")

    def __init__(self, sampled, coords: Tuple[Exp, ...], channel: int):
        self.sampled = sampled
        self.coords = tuple(toexp(c) for c in coords)
        self.channel = channel

    def __repr__(self):
        return f"sample:{self.sampled.name}[{self.channel}]"


def toexp(v) -> Exp:
    if isinstance(v, Exp):
        return v
    if isinstance(v, (int, float)):
        return Const(v)
    if isinstance(v, ExpVector):
        raise TypeError("expected scalar expression, got vector; select a channel")
    # index expressions used as values
    from .dims import IndexDomain, SparseComp

    if isinstance(v, (IndexDomain, AffineComp, SparseComp)):
        return v.asvalue()
    raise TypeError(f"cannot convert {v!r} to an expression")


def _binop(op, a, b):
    av, bv = _isvec(a), _isvec(b)
    if av or bv:
        return ExpVector._broadcast_binop(op, a, b)
    return Apply(op, (toexp(a), toexp(b)))


def _isvec(v):
    return isinstance(v, ExpVector)


class ExpVector:
    """Channel vector of scalar expressions (reference ExpVector,
    API/src/ad.t:273-311)."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = [toexp(d) for d in data]

    # -- channel access ----------------------------------------------------
    def __call__(self, i):
        return self.data[i]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ExpVector(self.data[i])
        return self.data[i]

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    @property
    def nchannels(self):
        return len(self.data)

    def slice(self, a, b):
        """vec:slice(a,b) -> channels [a,b) (reference Vector slice used by
        bundle_adjustment.t `camera:slice(0,3)`)."""
        return ExpVector(self.data[a:b])

    # -- elementwise arithmetic (with scalar broadcast) --------------------
    @staticmethod
    def _broadcast_binop(op, a, b):
        an = len(a) if _isvec(a) else None
        bn = len(b) if _isvec(b) else None
        if an is not None and bn is not None:
            if an != bn:
                raise ValueError(f"channel mismatch: {an} vs {bn}")
            return ExpVector([Apply(op, (a.data[i], b.data[i])) for i in range(an)])
        if an is not None:
            bs = toexp(b)
            return ExpVector([Apply(op, (a.data[i], bs)) for i in range(an)])
        as_ = toexp(a)
        return ExpVector([Apply(op, (as_, b.data[i])) for i in range(bn)])

    def __add__(self, o):
        return self._broadcast_binop("add", self, o)

    def __radd__(self, o):
        return self._broadcast_binop("add", o, self)

    def __sub__(self, o):
        return self._broadcast_binop("sub", self, o)

    def __rsub__(self, o):
        return self._broadcast_binop("sub", o, self)

    def __mul__(self, o):
        return self._broadcast_binop("mul", self, o)

    def __rmul__(self, o):
        return self._broadcast_binop("mul", o, self)

    def __truediv__(self, o):
        return self._broadcast_binop("div", self, o)

    def __rtruediv__(self, o):
        return self._broadcast_binop("div", o, self)

    def __neg__(self):
        return ExpVector([-d for d in self.data])

    def __abs__(self):
        return ExpVector([abs(d) for d in self.data])

    def dot(self, other):
        if not _isvec(other):
            raise TypeError("dot expects a vector")
        if len(other) != len(self):
            raise ValueError("channel mismatch in dot")
        s = self.data[0] * other.data[0]
        for i in range(1, len(self)):
            s = s + self.data[i] * other.data[i]
        return s

    def sum(self):
        s = self.data[0]
        for d in self.data[1:]:
            s = s + d
        return s

    def get(self, *idx):
        """See Exp.get."""
        return _make_get(list(self.data), idx)

    def __repr__(self):
        return f"Vector({', '.join(map(repr, self.data))})"

    def set_materialize(self, flag: bool = True):
        """Delegate to the accessed computed image (all channels of a
        get() share one image)."""
        self.data[0].set_materialize(flag)
        return self

    def set_gradient_materialize(self, flag: bool = True):
        self.data[0].set_gradient_materialize(flag)
        return self


def channels_of(v):
    if isinstance(v, ExpVector):
        return list(v.data)
    return [toexp(v)]


_get_cache = {}


def _make_get(exprs, idx):
    """Build an implicit computed-array access.  The computed array's
    declared domains are the EXPRESSION's free domains (like the reference,
    which classifies the expression first, thallo.t:1868-1893); index
    arguments map to them by primary domain when the argument mentions one
    of them (e.g. B_I.get(x+1, y)), else positionally (e.g. accessing a
    per-frame transform at a sparse index, transform.get(corr_i(c))).
    Memoized per expression so repeated gets share one computed image
    (the reference's maybe_computed_array hash-consing)."""
    from .dims import normalize_index
    from .inputs import Image
    from .typesys import VecType

    comps = tuple(normalize_index(c) for c in idx)
    ckey = tuple(id(e) for e in exprs)
    if ckey in _get_cache:
        im = _get_cache[ckey][0]
        accesses = [ImageAccess(im, comps, c) for c in range(len(exprs))]
        return accesses[0] if len(exprs) == 1 else ExpVector(accesses)

    # free domains of the expression, ordered by first appearance
    from .lower import Collection

    col = Collection(allow_inline_ca=True)
    for e in exprs:
        col.walk(e, frozenset())
    expr_domains = list(col.ext_domains)
    if len(expr_domains) != len(comps):
        raise ValueError(
            f"get() has {len(comps)} index args but the expression has "
            f"{len(expr_domains)} free domains"
        )
    # match by primary domain where possible
    order = [None] * len(comps)
    used = set()
    for k, c in enumerate(comps):
        ds = c.domains()
        if ds and ds[0] in expr_domains and ds[0] not in used:
            order[k] = ds[0]
            used.add(ds[0])
    rest = [d for d in expr_domains if d not in used]
    for k in range(len(comps)):
        if order[k] is None:
            order[k] = rest.pop(0)
    domains = order

    im = Image(
        f"_get{id(exprs[0])}", VecType(len(exprs)),
        tuple(d.dim for d in domains), "computed",
    )
    im.expression = exprs
    im.domains = tuple(domains)
    # keep the exprs alive so id()-keyed memoization stays valid
    _get_cache[ckey] = (im, exprs)
    accesses = [ImageAccess(im, comps, c) for c in range(len(exprs))]
    if len(exprs) == 1:
        return accesses[0]
    return ExpVector(accesses)


def channels(v):
    """Flatten a scalar/vector expression into a list of scalar exprs."""
    if isinstance(v, ExpVector):
        return list(v.data)
    return [toexp(v)]


def map_channels(fn, *vs):
    ns = [v.nchannels if isinstance(v, ExpVector) else None for v in vs]
    n = max((x for x in ns if x is not None), default=None)
    if n is None:
        return fn(*[toexp(v) for v in vs])
    out = []
    for i in range(n):
        args = []
        for v, vn in zip(vs, ns):
            if vn is None:
                args.append(toexp(v))
            else:
                if vn != n:
                    raise ValueError("channel mismatch")
                args.append(v.data[i])
        out.append(fn(*args))
    return ExpVector(out)
