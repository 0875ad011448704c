"""The energy-DSL environment: the functions available inside an energy file.

Mirrors the reference's per-problem DSL stdlib (API/src/
lib.t — Dims/Inputs/Residuals/Select/InBounds/Stencil and the Ceres-derived
geometry helpers lib.t:123-379).  Energy files are plain Python executed in
this environment (the analog of Lua `setfenv`, lib.t:12,584-591), so ported
energies read nearly line-for-line like the reference's `.t` files.

JAX-specific care: helpers that branch around singularities (AngleAxis,
PoseToMatrix) use the "double-where" guard so vjp does not leak NaN from the
untaken branch — the symbolic-AD reference does not need this, JAX does.
"""
from __future__ import annotations

import math as _math

from .dims import AffineComp, IndexDomain, normalize_index
from .expr import (
    Apply,
    BoundsAccess,
    Exp,
    ExpVector,
    Reduction,
    channels,
    map_channels,
    toexp,
)
from .inputs import SampledImage as _SampledImage
from .spec import ProblemSpec
from . import typesys


# ---------------------------------------------------------------------------
# scalar math ops (elementwise-broadcast over channel vectors)
# ---------------------------------------------------------------------------
def _unop(op):
    def f(v):
        return map_channels(lambda s: Apply(op, (s,)), v)

    return f


sin = _unop("sin")
cos = _unop("cos")
tan = _unop("tan")
asin = _unop("asin")
acos = _unop("acos")
atan = _unop("atan")
sqrt = _unop("sqrt")
Sqrt = sqrt
exp = _unop("exp")
log = _unop("log")


def abs_(v):
    return map_channels(lambda s: Apply("abs", (s,)), v)


def pow(a, b):
    return map_channels(lambda x, y: Apply("pow", (x, y)), a, b)


def _cmp(op):
    def f(a, b):
        return map_channels(lambda x, y: Apply(op, (x, y)), a, b)

    return f


eq = _cmp("eq")
neq = _cmp("neq")
greater = _cmp("greater")
greatereq = _cmp("greatereq")
less = _cmp("less")
lesseq = _cmp("lesseq")


def and_(a, b):
    return map_channels(lambda x, y: Apply("and", (x, y)), a, b)


def or_(a, b):
    return map_channels(lambda x, y: Apply("or", (x, y)), a, b)


def not_(a):
    return map_channels(lambda x: Apply("not", (x,)), a)


Not = not_


def And(*args):
    r = toexp(1.0)
    for a in args:
        r = and_(r, a)
    return r


def Or(*args):
    r = toexp(0.0)
    for a in args:
        r = or_(r, a)
    return r


def Select(cond, a, b):
    """ad.select: evaluates both branches, picks by cond != 0 (reference
    ad.t:799-809)."""
    cond = toexp(cond) if not isinstance(cond, ExpVector) else cond
    return map_channels(lambda c, x, y: Apply("select", (c, x, y)), cond, a, b)


def SelectOnAll(pList, val, default):
    assert len(pList) > 0
    result = Select(pList[-1], val, default)
    for p in reversed(pList[:-1]):
        result = Select(p, result, default)
    return result


def Max(a, b):
    return map_channels(lambda x, y: Apply("max", (x, y)), a, b)


def Min(a, b):
    return map_channels(lambda x, y: Apply("min", (x, y)), a, b)


def Constant(v):
    """ad.constant — treat subexpression as a constant under
    differentiation (reference ad.t:836).  Lowers to lax.stop_gradient."""
    return map_channels(lambda s: Apply("constant", (s,)), v)


def All(v):
    if not isinstance(v, ExpVector):
        return toexp(v)
    r = v(0)
    for i in range(1, len(v)):
        r = r * v(i)
    return r


def Vector(*args):
    return ExpVector(list(args))


def Stencil(lst):
    """Offset iterator (reference lib.t:559-566); usable as
    `for dx,dy in Stencil([[1,0],[-1,0]])`."""
    return [tuple(e) for e in lst]


# ---------------------------------------------------------------------------
# bounds guards
# ---------------------------------------------------------------------------
def _comp_dim(comp: AffineComp):
    ds = comp.domains()
    if not ds:
        raise ValueError("InBounds component has no iteration domain")
    return ds[0].dim


def InBounds(*comps):
    cs = tuple(normalize_index(c) for c in comps)
    dims = tuple(_comp_dim(c) for c in cs)
    return BoundsAccess(cs, dims, 0)


def InBoundsExpanded(*args):
    """InBoundsExpanded(x, y, ..., expand): bounds check shrunk inward by
    `expand` on every side (reference thallo.t:2091-2112)."""
    *comps, expand = args
    cs = tuple(normalize_index(c) for c in comps)
    dims = tuple(_comp_dim(c) for c in cs)
    return BoundsAccess(cs, dims, int(expand))


# ---------------------------------------------------------------------------
# vector/matrix helpers (channel vectors as flattened row-major matrices)
# ---------------------------------------------------------------------------
def dot(v0, v1):
    if isinstance(v0, ExpVector):
        return v0.dot(v1)
    return toexp(v0) * toexp(v1)


def normalize(v):
    return v / sqrt(dot(v, v))


def length(v0, v1):
    d = v0 - v1
    return sqrt(dot(d, d))


def cross(a, b):
    return Vector(
        a(1) * b(2) - a(2) * b(1),
        a(2) * b(0) - a(0) * b(2),
        a(0) * b(1) - a(1) * b(0),
    )


def gemv(matrix, v):
    col = len(v)
    rows = len(matrix) // col
    out = []
    for r in range(rows):
        val = matrix(r * col) * v(0)
        for c in range(1, col):
            val = val + matrix(r * col + c) * v(c)
        out.append(val)
    return ExpVector(out)


def matmul(a, b):
    dim = int(_math.isqrt(len(a)))
    assert dim * dim == len(a) == len(b), "matmul: square matrices only"
    out = []
    for i in range(dim):
        for j in range(dim):
            c = toexp(0.0)
            for k in range(dim):
                c = c + a(i * dim + k) * b(k * dim + j)
            out.append(c)
    return ExpVector(out)


def transpose(M):
    dim = int(_math.isqrt(len(M)))
    assert dim * dim == len(M)
    return ExpVector([M(j * dim + i) for i in range(dim) for j in range(dim)])


def Matrix4(*a):
    assert len(a) == 16
    return Vector(*a)


def Vec4(*a):
    assert len(a) == 4
    return Vector(*a)


def Vec3(v):
    return Vector(v(0), v(1), v(2))


def Slice(im, s, e):
    """Channel-slice view of an image (reference lib.t:109-121)."""

    class _S:
        def __call__(self, *ind):
            val = im(*ind)
            if s + 1 == e:
                return val(s)
            return ExpVector([val(i) for i in range(s, e)])

    return _S()


def L_2_norm(v):
    if isinstance(v, ExpVector) and len(v) > 1:
        return sqrt(v.dot(v))
    return v


def L_1_norm(v):
    if isinstance(v, ExpVector) and len(v) > 1:
        r = toexp(0.0)
        for i in range(len(v)):
            r = r + abs_(v(i))
        return r
    return abs_(v)


def L_p(val, p, domains=None):
    dist = L_2_norm(val)
    eps = 1e-7
    C = pow(dist + eps, p - 2)
    sqrtC = sqrt(C)
    return Constant(sqrtC) * val


def L_1(val, domains=None):
    dist = L_1_norm(val)
    eps = 1e-7
    C = pow(dist + eps, -1)
    sqrtC = sqrt(C)
    return Constant(sqrtC) * dist


# ---------------------------------------------------------------------------
# rotations / rigid transforms (Ceres-derived, reference lib.t:123-379)
# ---------------------------------------------------------------------------
def Rotate2D(angle, v):
    ca, sa = cos(angle), sin(angle)
    return Vector(ca * v(0) - sa * v(1), sa * v(0) + ca * v(1))


def Rotate3D(a, v):
    alpha, beta, gamma = a(0), a(1), a(2)
    CosAlpha, CosBeta, CosGamma = cos(alpha), cos(beta), cos(gamma)
    SinAlpha, SinBeta, SinGamma = sin(alpha), sin(beta), sin(gamma)
    matrix = Vector(
        CosGamma * CosBeta,
        -SinGamma * CosAlpha + CosGamma * SinBeta * SinAlpha,
        SinGamma * SinAlpha + CosGamma * SinBeta * CosAlpha,
        SinGamma * CosBeta,
        CosGamma * CosAlpha + SinGamma * SinBeta * SinAlpha,
        -CosGamma * SinAlpha + SinGamma * SinBeta * CosAlpha,
        -SinBeta,
        CosBeta * SinAlpha,
        CosBeta * CosAlpha,
    )
    return gemv(matrix, v)


def RodriguesSO3Exp(w, A, B):
    wx2, wy2, wz2 = w(0) * w(0), w(1) * w(1), w(2) * w(2)
    R00 = 1.0 - B * (wy2 + wz2)
    R11 = 1.0 - B * (wx2 + wz2)
    R22 = 1.0 - B * (wx2 + wy2)
    a, b = A * w(2), B * (w(0) * w(1))
    R01, R10 = b - a, b + a
    a, b = A * w(1), B * (w(0) * w(2))
    R02, R20 = b + a, b - a
    a, b = A * w(0), B * (w(1) * w(2))
    R12, R21 = b - a, b + a
    return Vector(R00, R01, R02, R10, R11, R12, R20, R21, R22)


def AngleAxisRotatePoint(angle_axis, pt):
    """Ceres rotation.h port (reference lib.t:514-555) with double-where
    guards so JAX vjp stays NaN-free at the origin."""
    theta2 = dot(angle_axis, angle_axis)
    large_axis = greater(theta2, 1e-8)
    # guard: evaluate sqrt/divide on a safe value in the small branch
    theta2_safe = Select(large_axis, theta2, 1.0)
    theta = sqrt(theta2_safe)
    costheta = cos(theta)
    sintheta = sin(theta)
    theta_inverse = 1.0 / theta
    w = angle_axis * theta_inverse
    w_cross_pt = cross(w, pt)
    tmp = dot(w, pt) * (1.0 - costheta)
    large_result = pt * costheta + w_cross_pt * sintheta + w * tmp
    small_result = pt + cross(angle_axis, pt)
    return Select(large_axis, large_result, small_result)


def RotationMatrixAndTranslationToMat4(r, t):
    return Vector(
        r(0), r(1), r(2), t(0),
        r(3), r(4), r(5), t(1),
        r(6), r(7), r(8), t(2),
        0.0, 0.0, 0.0, 1.0,
    )


def Mat4ToRigidTransform(m):
    return ExpVector([m(i) for i in range(12)])


def RigidTransformToMat4(m):
    return ExpVector([m(i) for i in range(12)] + [toexp(0.0), toexp(0.0), toexp(0.0), toexp(1.0)])


def rotationFromMat4(t):
    return Vector(t(0), t(1), t(2), t(4), t(5), t(6), t(8), t(9), t(10))


def translationFromMat4(t):
    return Vector(t(3), t(7), t(11))


def InvertRigidTransform(transform):
    R = rotationFromMat4(transform)
    t = translationFromMat4(transform)
    Rt = transpose(R)
    newT = gemv(-Rt, t)
    return Matrix4(
        Rt(0), Rt(1), Rt(2), newT(0),
        Rt(3), Rt(4), Rt(5), newT(1),
        Rt(6), Rt(7), Rt(8), newT(2),
        0, 0, 0, 1,
    )


def rigid_trans(M, v):
    return Vec3(gemv(M, Vector(v(0), v(1), v(2), 1.0)))


def PoseToMatrix(rot, trans):
    """SE(3) exp map (reference lib.t:467-500) with NaN-safe guards."""
    theta_sq = dot(rot, rot)
    smallAngle = less(theta_sq, 1e-8)
    midAngle = less(theta_sq, 1e-6)
    theta_sq_safe = Select(smallAngle, 1.0, theta_sq)
    theta = sqrt(theta_sq_safe)

    cr = cross(rot, trans)
    ONE_SIXTH = 1.0 / 6.0
    ONE_TWENTIETH = 1.0 / 20.0

    A_s = 1.0 - ONE_SIXTH * theta_sq
    translation_s = trans + 0.5 * cr

    C_m = ONE_SIXTH * (1.0 - ONE_TWENTIETH * theta_sq)
    A_m = 1.0 - theta_sq * C_m
    B_m = 0.5 - (0.25 * ONE_SIXTH * theta_sq)
    inv_theta = 1.0 / theta
    A_l = sin(theta) * inv_theta
    B_l = (1.0 - cos(theta)) * (inv_theta * inv_theta)
    C_l = (1.0 - A_l) * (inv_theta * inv_theta)
    w_cross = cross(rot, cr)

    translation_m = trans + B_m * cr + C_m * w_cross
    translation_l = trans + B_l * cr + C_l * w_cross

    translation = Select(smallAngle, translation_s, Select(midAngle, translation_m, translation_l))
    A = Select(smallAngle, A_s, Select(midAngle, A_m, A_l))
    B = Select(smallAngle, 0.5, Select(midAngle, B_m, B_l))
    rotationMatrix = RodriguesSO3Exp(rot, A, B)
    return RotationMatrixAndTranslationToMat4(rotationMatrix, translation)


def Reduce(fn, init):
    """Variadic fold builder (reference lib.t:63-74; And/Or are built on
    it)."""

    def folded(*args):
        r = toexp(init)
        for a in args:
            r = fn(r, a)
        return r

    return folded


def InverseMatrix4(m):
    """Cofactor inverse of a 4x4 (16-channel row-major) matrix
    (reference lib.t:305-379)."""
    e = [m(i) for i in range(16)]
    inv = [None] * 16
    inv[0] = e[5]*e[10]*e[15] - e[5]*e[11]*e[14] - e[9]*e[6]*e[15] + e[9]*e[7]*e[14] + e[13]*e[6]*e[11] - e[13]*e[7]*e[10]
    inv[4] = -e[4]*e[10]*e[15] + e[4]*e[11]*e[14] + e[8]*e[6]*e[15] - e[8]*e[7]*e[14] - e[12]*e[6]*e[11] + e[12]*e[7]*e[10]
    inv[8] = e[4]*e[9]*e[15] - e[4]*e[11]*e[13] - e[8]*e[5]*e[15] + e[8]*e[7]*e[13] + e[12]*e[5]*e[11] - e[12]*e[7]*e[9]
    inv[12] = -e[4]*e[9]*e[14] + e[4]*e[10]*e[13] + e[8]*e[5]*e[14] - e[8]*e[6]*e[13] - e[12]*e[5]*e[10] + e[12]*e[6]*e[9]
    inv[1] = -e[1]*e[10]*e[15] + e[1]*e[11]*e[14] + e[9]*e[2]*e[15] - e[9]*e[3]*e[14] - e[13]*e[2]*e[11] + e[13]*e[3]*e[10]
    inv[5] = e[0]*e[10]*e[15] - e[0]*e[11]*e[14] - e[8]*e[2]*e[15] + e[8]*e[3]*e[14] + e[12]*e[2]*e[11] - e[12]*e[3]*e[10]
    inv[9] = -e[0]*e[9]*e[15] + e[0]*e[11]*e[13] + e[8]*e[1]*e[15] - e[8]*e[3]*e[13] - e[12]*e[1]*e[11] + e[12]*e[3]*e[9]
    inv[13] = e[0]*e[9]*e[14] - e[0]*e[10]*e[13] - e[8]*e[1]*e[14] + e[8]*e[2]*e[13] + e[12]*e[1]*e[10] - e[12]*e[2]*e[9]
    inv[2] = e[1]*e[6]*e[15] - e[1]*e[7]*e[14] - e[5]*e[2]*e[15] + e[5]*e[3]*e[14] + e[13]*e[2]*e[7] - e[13]*e[3]*e[6]
    inv[6] = -e[0]*e[6]*e[15] + e[0]*e[7]*e[14] + e[4]*e[2]*e[15] - e[4]*e[3]*e[14] - e[12]*e[2]*e[7] + e[12]*e[3]*e[6]
    inv[10] = e[0]*e[5]*e[15] - e[0]*e[7]*e[13] - e[4]*e[1]*e[15] + e[4]*e[3]*e[13] + e[12]*e[1]*e[7] - e[12]*e[3]*e[5]
    inv[14] = -e[0]*e[5]*e[14] + e[0]*e[6]*e[13] + e[4]*e[1]*e[14] - e[4]*e[2]*e[13] - e[12]*e[1]*e[6] + e[12]*e[2]*e[5]
    inv[3] = -e[1]*e[6]*e[11] + e[1]*e[7]*e[10] + e[5]*e[2]*e[11] - e[5]*e[3]*e[10] - e[9]*e[2]*e[7] + e[9]*e[3]*e[6]
    inv[7] = e[0]*e[6]*e[11] - e[0]*e[7]*e[10] - e[4]*e[2]*e[11] + e[4]*e[3]*e[10] + e[8]*e[2]*e[7] - e[8]*e[3]*e[6]
    inv[11] = -e[0]*e[5]*e[11] + e[0]*e[7]*e[9] + e[4]*e[1]*e[11] - e[4]*e[3]*e[9] - e[8]*e[1]*e[7] + e[8]*e[3]*e[5]
    inv[15] = e[0]*e[5]*e[10] - e[0]*e[6]*e[9] - e[4]*e[1]*e[10] + e[4]*e[2]*e[9] + e[8]*e[1]*e[6] - e[8]*e[2]*e[5]
    det = e[0]*inv[0] + e[1]*inv[4] + e[2]*inv[8] + e[3]*inv[12]
    d_r = 1.0 / det
    return ExpVector([v * d_r for v in inv])


def CameraToDepth(fx, fy, cx, cy, pos):
    return Vector(pos(0) * fx / pos(2) + cx, pos(1) * fy / pos(2) + cy)


# ---------------------------------------------------------------------------
# environment construction (the analog of lib.t's setfenv environment)
# ---------------------------------------------------------------------------
class _Decl:
    def __init__(self, kind, args):
        self.kind = kind
        self.args = args


def _decl(kind):
    def f(*args):
        return _Decl(kind, args)

    return f


def make_env(spec: ProblemSpec):
    """Build the globals dict for executing an energy file against `spec`."""
    env = {}

    def Dims(*names):
        return spec.Dims(*names)

    def Inputs(**decls):
        # order by explicit argpos when given (mirrors the reference's
        # index-ordered void** marshalling, util.t:609-643)
        items = list(decls.items())

        def argpos(kv):
            d = kv[1]
            return d.args[-1] if isinstance(d.args[-1], int) else 1 << 30

        items.sort(key=argpos)
        for name, d in items:
            if not isinstance(d, _Decl):
                raise TypeError(f"Inputs entry {name} is not a declaration")
            a = list(d.args)
            pos = a.pop() if a and isinstance(a[-1], int) else None
            if d.kind == "Unknown":
                vtype, dims = a
                obj = spec.Unknown(name, vtype, dims, pos)
            elif d.kind == "Array":
                vtype, dims = a
                obj = spec.Array(name, vtype, dims, pos)
            elif d.kind == "Sparse":
                in_dims, out_dims = a
                obj = spec.Sparse(name, in_dims, out_dims, pos)
            elif d.kind == "Param":
                (dtype,) = a
                obj = spec.Param(name, dtype, pos).exp()
            else:
                raise ValueError(d.kind)
            env[name] = obj

    def Residuals(**named):
        return spec.Residuals(**named)

    def Schedule(name, jtjp_schedule, compute_at_output=False,
                 sparse_matrices=False, compute_lanes=None):
        """Deprecated declarative schedule setter (reference lib.t:37-40,
        'old style scheduling'): maps a JTJpSchedule name onto the
        materialize flags of the named residual."""
        from .spec import JTJpSchedule

        nr = spec.energy[name]
        sched = JTJpSchedule(jtjp_schedule) if not isinstance(
            jtjp_schedule, JTJpSchedule) else jtjp_schedule
        nr._materialize["J"] = sched in (
            JTJpSchedule.PRECOMPUTE_J, JTJpSchedule.PRECOMPUTE_J_THEN_JTJ)
        nr._materialize["JtJ"] = sched in (
            JTJpSchedule.PRECOMPUTE_JTJ, JTJpSchedule.PRECOMPUTE_J_THEN_JTJ)
        nr._materialize["Jp"] = sched == JTJpSchedule.APPLY_SEPARATELY
        if compute_at_output:
            nr.compute_at_output(True)
        if sparse_matrices:
            nr.J.set_sparse(True)
        return nr

    def Sum(domains, value):
        if isinstance(domains, (IndexDomain,)):
            domains = [domains]
        return map_channels(lambda s: Reduction(tuple(domains), s), value)

    def ComputedArray(name, domains, expr):
        """ComputedArray(name, [x, y], expr): a named precomputed
        expression array over iteration domains (reference thallo.t:
        1777-1822)."""
        domains = list(domains)
        dims = tuple(d.dim for d in domains)
        return spec.ComputedArray(name, dims, expr, domains=domains)

    def SampledImage(image, *derivs):
        return _SampledImage(image, *derivs)

    def SampledImageArray(image):
        """3-D image array sampled bilinearly within slice round(t)
        (reference SampledImageArray, bundle_fusion_solve.t:28-29)."""
        return _SampledImage(image, is_array=True)

    def ConditionalSampledImageArray(image):
        """3-D image array with the reference's CONDITIONAL sampling
        (thallo.t:931-980): out-of-bounds / -inf-sentinel corners are
        dropped and the bilinear weights renormalized (BundleFusion
        missing-depth semantics)."""
        return _SampledImage(image, is_array=True, conditional=True)

    env.update(
        Dims=Dims,
        Inputs=Inputs,
        Residuals=Residuals,
        Schedule=Schedule,
        Unknown=_decl("Unknown"),
        Array=_decl("Array"),
        Image=_decl("Array"),
        Sparse=_decl("Sparse"),
        Param=_decl("Param"),
        UsePreconditioner=spec.UsePreconditioner,
        Sum=Sum,
        ComputedArray=ComputedArray,
        SampledImage=SampledImage,
        SampledImageArray=SampledImageArray,
        ConditionalSampledImageArray=ConditionalSampledImageArray,
    )
    # math / helpers
    env.update(
        Select=Select,
        SelectOnAll=SelectOnAll,
        All=All,
        And=And,
        Or=Or,
        Not=Not,
        InBounds=InBounds,
        InBoundsExpanded=InBoundsExpanded,
        Vector=Vector,
        Stencil=Stencil,
        Constant=Constant,
        Max=Max,
        Min=Min,
        abs=abs_,
        sin=sin,
        cos=cos,
        tan=tan,
        asin=asin,
        acos=acos,
        atan=atan,
        sqrt=sqrt,
        Sqrt=sqrt,
        exp=exp,
        log=log,
        pow=pow,
        eq=eq,
        neq=neq,
        greater=greater,
        greatereq=greatereq,
        less=less,
        lesseq=lesseq,
        and_=and_,
        or_=or_,
        not_=not_,
        dot=dot,
        cross=cross,
        normalize=normalize,
        length=length,
        gemv=gemv,
        matmul=matmul,
        transpose=transpose,
        Matrix4=Matrix4,
        Vec4=Vec4,
        Vec3=Vec3,
        Slice=Slice,
        L_2_norm=L_2_norm,
        L_1_norm=L_1_norm,
        L_p=L_p,
        L_1=L_1,
        Rotate2D=Rotate2D,
        Rotate3D=Rotate3D,
        RodriguesSO3Exp=RodriguesSO3Exp,
        AngleAxisRotatePoint=AngleAxisRotatePoint,
        PoseToMatrix=PoseToMatrix,
        InvertRigidTransform=InvertRigidTransform,
        RotationMatrixAndTranslationToMat4=RotationMatrixAndTranslationToMat4,
        Mat4ToRigidTransform=Mat4ToRigidTransform,
        RigidTransformToMat4=RigidTransformToMat4,
        rotationFromMat4=rotationFromMat4,
        translationFromMat4=translationFromMat4,
        rigid_trans=rigid_trans,
        Reduce=Reduce,
        InverseMatrix4=InverseMatrix4,
        CameraToDepth=CameraToDepth,
    )
    # channel types
    for n in list(typesys._BY_NAME):
        env[n] = typesys._BY_NAME[n]
    env["float"] = typesys.float1
    return env


def load_energy(source: str, spec: ProblemSpec = None, filename: str = "<energy>") -> ProblemSpec:
    """Execute a Python energy file and return its ProblemSpec (analog of
    problemSpecFromFile, API/src/thallo.t:1359-1373)."""
    spec = spec or ProblemSpec()
    env = make_env(spec)
    code = compile(source, filename, "exec")
    exec(code, env)
    return spec


def load_energy_file(path: str, spec: ProblemSpec = None) -> ProblemSpec:
    with open(path) as f:
        src = f.read()
    return load_energy(src, spec, path)
