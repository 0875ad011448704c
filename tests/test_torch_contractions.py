"""The port's contractions (Sum), contraction blocking and materialized
computed arrays against the JAX package on the CPU.  They mirror
tests/test_conblock.py, tests/test_features.py's contraction tests and
tests/test_computed_arrays.py: the same energies and seeded numpy inputs
through both packages; the cost, -JᵀF, diag(JᵀJ) and JᵀJ·p of a seeded
p at the initial unknowns, then the solves.  f32 on both sides, sums in
another order: the linear parts agree within LINEAR_TOL·max|ref| (measured:
at most 2.8e-7), the costs within COST_RTOL.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from tests import test_computed_arrays as tca  # noqa: E402
from tests import test_conblock as tcb  # noqa: E402
from tests import test_features as tfe  # noqa: E402

LINEAR_TOL = 1e-5
COST_RTOL = 1e-4


def _plan(pkg, text, dims, inputs, solver="gauss_newton", **params):
    p = pkg.load_energy(text).plan(dims, solver=solver,
                                   **({"device": "cpu"} if pkg is tt else {}))
    for k, v in params.items():
        p.set_solver_parameter(k, v)
    c0 = p.init({k: np.copy(v) for k, v in inputs.items()})
    return p, float(c0)


def _linear_parts(p, seed=3):
    """(-JᵀF, diag(JᵀJ), JᵀJ·p) as numpy dicts at the plan's unknowns."""
    comp, U, ins, consts = p.compiled, p._U, p._step_inputs(), p._prep["consts"]
    masks = comp.masks(ins, U)
    mjtf, diag, store = comp.jtf_and_diag(U, ins, consts, masks, {})
    rng = np.random.RandomState(seed)
    pv = {k: rng.randn(*tuple(v.shape)).astype(np.float32) for k, v in U.items()}
    conv = torch.from_numpy if isinstance(next(iter(U.values())), torch.Tensor) else jnp.asarray
    Ap = comp.make_jtjp(U, ins, consts, masks, store)({k: conv(v) for k, v in pv.items()})
    return [{k: np.asarray(v) for k, v in t.items()} for t in (mjtf, diag, Ap)]


def _assert_parts(got, want, tol=LINEAR_TOL):
    for g, w in zip(got, want):
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= tol * np.abs(w[k]).max(), k


def _both(text, dims, inputs, solver="gauss_newton", **params):
    """(JAX plan, c0), (port plan, c0) on the same text and inputs."""
    return [_plan(pkg, text, dims, inputs, solver, **params) for pkg in (tl, tt)]


def _con_group(p):
    return next(gp.group for gp in p.compiled.groups if gp.group.con_domains)


# ---------------------------------------------------------------------------
# contraction blocking (tests/test_conblock.py)
# ---------------------------------------------------------------------------
def _conblock(directive="", W=12, Kd=5):
    return tcb.ENERGY.format(directive=directive), {"W": W, "H": W, "Kd": Kd, "Kc": 2}


def test_split_directive_blocks_and_matches():
    """split(k_0, 1): five blocks of one k_0, as JAX's; the blocked and the
    unblocked port and JAX agree on the initial cost, the linear parts and
    the GN solve."""
    ins = tcb._inputs(12, 12)
    (pju, cju), (ptu, ctu) = _both(*_conblock(), ins)
    (pjb, cjb), (ptb, ctb) = _both(*_conblock("r.conv.split(k_0, 1)"), ins)
    assert _con_group(ptu).con_block is None
    dom, B, nblk = _con_group(ptb).con_block
    jdom, jB, jn = _con_group(pjb).con_block
    assert (dom.dim.name, B, nblk) == (jdom.dim.name, jB, jn) == ("Kd", 1, 5)
    for c in (ctu, ctb, cjb):
        assert abs(c - cju) <= COST_RTOL * cju
    want = _linear_parts(pju)
    for p in (ptu, ptb, pjb):
        _assert_parts(_linear_parts(p), want)
    fj = pju.solve()
    for p in (ptu, ptb):
        assert abs(float(p.solve()) - fj) <= 1e-3 * fj + 1e-7


def test_split_with_an_unblocked_slot_inside_the_sum():
    """A Sum that also reads unknown slots not over the blocked domain
    (X(x, y), and X(x, y - k_1 + 2) over k_1 alone): their dred/du summed
    over the blocks in pass 1.  The blocked port against JAX's blocked run:
    the cost and the linear parts, then the GN solve."""
    text = tcb.ENERGY.replace(
        "kx = Sum([k_0, k_1], K(k_0, k_1, c) * X(x - k_0 + 2, y - k_1 + 2))",
        "kx = Sum([k_0, k_1], K(k_0, k_1, c) * X(x - k_0 + 2, y - k_1 + 2) * X(x, y)"
        " + 0.1 * K(k_0, k_1, c) * X(x, y - k_1 + 2))")
    dims = {"W": 10, "H": 10, "Kd": 5, "Kc": 2}
    (pj, cj), (pt, ct) = _both(text.format(directive="r.conv.split(k_0, 1)"), dims,
                               tcb._inputs(10, 10))
    g = _con_group(pt)
    assert g.con_block[1:] == (1, 5) and len(g._blocked_split()[2]) == 2
    assert abs(ct - cj) <= COST_RTOL * cj
    _assert_parts(_linear_parts(pt), _linear_parts(pj))
    fj = float(pj.solve())
    assert abs(float(pt.solve()) - fj) <= 1e-3 * fj + 1e-7


def test_auto_blocking_over_budget(monkeypatch):
    """Without a directive, a fiber over THALLO_CON_BLOCK_BYTES blocks in
    both packages alike, and the solve falls below half its initial
    cost, with JAX's."""
    monkeypatch.setenv("THALLO_CON_BLOCK_BYTES", "4096")
    (pj, cj), (pt, ct) = _both(*_conblock(), tcb._inputs(12, 12))
    got, want = _con_group(pt).con_block, _con_group(pj).con_block
    assert got[1:] == want[1:] and got[2] > 1
    ft, fj = float(pt.solve()), float(pj.solve())
    assert ft < 0.5 * ct and abs(ft - fj) <= 1e-3 * fj + 1e-7


def test_deconvolution_512_blocks_as_jax():
    """deconvolution at 512² with the reference's 15 x 15 kernel (plan
    only): the fiber of X and K over 225 taps (472 MB) exceeds the 128 MiB
    default budget; the port blocks as JAX does, (Kd, 3, 5)."""
    from thallo_tpu.models import deconvolution as jd
    from thallo_tpu_torch.models import deconvolution as td

    dims = {"W": 512, "H": 512, "Kd": 15}
    got = _con_group(td.make_spec(k_half=7).plan(dims, device="cpu")).con_block
    want = _con_group(jd.make_spec(k_half=7).plan(dims)).con_block
    assert (got[0].dim.name, got[1], got[2]) == (want[0].dim.name, want[1], want[2]) \
        == ("Kd", 3, 5)


def test_blocked_fiber_memory_is_bounded():
    """tests/test_conblock.py:124's bound in the port: at 128² x 9 x 9 with
    split(k_0, 1), no op of the residual evaluation, the blocked -JᵀF and
    diag, or the blocked JᵀJ·p creates a tensor of R x K elements, the
    unblocked cross-product (a TorchDispatchMode records every op's
    outputs); the blocked parts agree with the unblocked port's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    W, Kd = 128, 9
    ins = tcb._inputs(W, W, Kd=Kd)
    pb, _ = _plan(tt, *_conblock("r.conv.split(k_0, 1)", W, Kd), ins)
    g = _con_group(pb)
    assert g.con_block[1] == 1
    comp, U, I, consts = pb.compiled, pb._U, pb._step_inputs(), pb._prep["consts"]
    gi = next(i for i, gp in enumerate(comp.groups) if gp.group is g)
    rng = np.random.RandomState(3)
    pv = {k: torch.from_numpy(rng.randn(*tuple(v.shape)).astype(np.float32)) for k, v in U.items()}
    with Largest() as mode:
        r = g.residuals_cm(U, I, consts[gi])
        mjtf, diag, store = comp.jtf_and_diag(U, I, consts, {}, {})
        Ap = comp.make_jtjp(U, I, consts, {}, store)(pv)
    assert mode.numel < W * W * Kd * Kd, (mode.numel, W * W * Kd * Kd)
    assert torch.isfinite(r).all()
    pu, _ = _plan(tt, *_conblock("", W, Kd), ins)
    assert _con_group(pu).con_block is None
    want = _linear_parts(pu)
    _assert_parts([{k: v.numpy() for k, v in t.items()} for t in (mjtf, diag, Ap)], want)


# ---------------------------------------------------------------------------
# contractions (tests/test_features.py:77-160)
# ---------------------------------------------------------------------------
def test_contraction_matvec_fit_matches_jax():
    """minimal_fitting: Sum([m], S(n, m) * W(m)) under APPLY_SEPARATELY;
    the linear parts against JAX, and the solve recovers w (cost < 1e-6)."""
    nN, nM = 20, 6
    rng = np.random.RandomState(5)
    S = rng.randn(nN, nM).astype(np.float32)
    w_true = rng.randn(nM).astype(np.float32)
    ins = {"W": np.zeros(nM, np.float32), "S": S, "T": S @ w_true}
    (pj, cj), (pt, ct) = _both(tfe.FITTING, {"N": nN, "M": nM}, ins,
                               nIterations=5, lIterations=40)
    assert abs(ct - cj) <= COST_RTOL * cj
    _assert_parts(_linear_parts(pt), _linear_parts(pj))
    assert float(pt.solve()) < 1e-6
    np.testing.assert_allclose(pt.get_unknown("W").numpy(), w_true, rtol=1e-2, atol=1e-2)


def test_contraction_jtf_matches_dense():
    """-JᵀF and diag(JᵀJ) of the contraction against the dense Jacobian of
    T - S w (tests/test_features.py:104)."""
    nN, nM = 10, 4
    rng = np.random.RandomState(7)
    S = rng.randn(nN, nM).astype(np.float32)
    T = rng.randn(nN).astype(np.float32)
    w0 = rng.randn(nM).astype(np.float32)
    pt, _ = _plan(tt, tfe.FITTING, {"N": nN, "M": nM}, {"W": w0, "S": S, "T": T})
    mjtf, diag, _ = _linear_parts(pt)
    r = T - S @ w0
    J = -S.astype(np.float64)
    np.testing.assert_allclose(mjtf["W"].ravel(), -(J.T @ r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(diag["W"].ravel(), (J * J).sum(0), rtol=1e-4, atol=1e-5)


def test_convolution_recovers_kernel_as_jax():
    """convolution: Sum([k], R(n - k + 2) * C(k)) with InBoundsExpanded;
    the linear parts against JAX, the solve recovers the kernel."""
    nN, nK = 64, 5
    rng = np.random.RandomState(11)
    R = rng.randn(nN).astype(np.float32)
    c_true = np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
    T = sum(np.roll(R, k - 2) * c_true[k] for k in range(nK)).astype(np.float32)
    ins = {"C": np.zeros(nK, np.float32), "R": R, "T": T}
    (pj, _), (pt, _) = _both(tfe.CONV, {"N": nN, "K": nK}, ins, nIterations=5, lIterations=60)
    _assert_parts(_linear_parts(pt), _linear_parts(pj))
    assert float(pt.solve()) < 1e-4
    np.testing.assert_allclose(pt.get_unknown("C").numpy(), c_true, atol=5e-2)


def test_contracted_domain_outside_its_sum_raises_as_jax():
    """A contracted domain read outside its Sum: both packages refuse the
    group with JAX's error text."""
    text = tfe.FITTING.replace("r = Residuals(fit=T(n) - result)",
                               "r = Residuals(fit=T(n) - result + S(n, m))")
    msgs = []
    for pkg, kw in ((tl, {}), (tt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="domains used both inside and outside Sum") as e:
            pkg.load_energy(text).plan({"N": 4, "M": 3}, **kw)
        msgs.append(str(e.value).split(":")[0])
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# materialized computed arrays (tests/test_computed_arrays.py)
# ---------------------------------------------------------------------------
CA_MAT = tca.ENERGY_TMPL.format(mat="shade.set_materialize(True)")


@pytest.mark.parametrize("solver", ["gauss_newton", "levenberg_marquardt"])
def test_materialized_ca_matches_inline_and_jax(solver):
    """shade materialized vs inlined: the same 8-step solve in the port,
    each within COST_RTOL of JAX's materialized solve, the unknowns within
    1e-4 of max|X|."""
    n = 12
    t = np.random.RandomState(0).rand(n, n).astype(np.float32)
    ins = {"X": t.copy(), "A": t}
    kw = dict(nIterations=8, lIterations=25)
    pm, _ = _plan(tt, CA_MAT, {"W": n, "H": n}, ins, solver, **kw)
    pi, _ = _plan(tt, tca.ENERGY_TMPL.format(mat=""), {"W": n, "H": n}, ins, solver, **kw)
    pj, _ = _plan(tl, CA_MAT, {"W": n, "H": n}, ins, solver, **kw)
    assert any(gp.group.has_materialized for gp in pm.compiled.groups)
    fm, fi, fj = float(pm.solve()), float(pi.solve()), float(pj.solve())
    assert abs(fm - fj) <= COST_RTOL * fj and abs(fi - fj) <= COST_RTOL * fj
    xj = np.asarray(pj.get_unknown("X"))
    for p in (pm, pi):
        assert np.abs(p.get_unknown("X").numpy() - xj).max() <= 1e-4 * np.abs(xj).max()


def test_ca_gradient_arrays_match_jax():
    """The composed slots (jac_slots) carry the computed array's chain
    rule: -JᵀF, diag and JᵀJ·p against JAX's gradient-array path."""
    rng = np.random.RandomState(3)
    n = 8
    ins = {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}
    (pj, _), (pt, _) = _both(CA_MAT, {"W": n, "H": n}, ins)
    g = next(gp.group for gp in pt.compiled.groups if gp.group.has_materialized)
    assert g.ca_jac_ok and len(g.jac_slots) > len(g.uslots)
    _assert_parts(_linear_parts(pt), _linear_parts(pj))


def test_ca_gradient_arrays_graph_access_match_jax():
    """A computed array over nodes read through sparse edge maps (a group
    of composed slots alone): the linear parts against JAX, and the solve
    lowers the cost as JAX's."""
    src = open(tca.__file__).read().split('    src = """')[1].split('"""')[0]
    rng = np.random.RandomState(5)
    Nn, Ee = 12, 30
    v0 = rng.randint(0, Nn, size=Ee).astype(np.int32)
    v1 = ((v0 + 1 + rng.randint(0, Nn - 1, size=Ee)) % Nn).astype(np.int32)
    ins = {"X": rng.rand(Nn, 2).astype(np.float32), "A": rng.rand(Nn, 2).astype(np.float32),
           "v0": v0, "v1": v1}
    (pj, cj), (pt, ct) = _both(src, {"N": Nn, "E": Ee}, ins, nIterations=6)
    edge = next(gp.group for gp in pt.compiled.groups if gp.group.has_materialized)
    assert not edge.uslots and edge.jac_slots
    _assert_parts(_linear_parts(pt), _linear_parts(pj))
    ft, fj = float(pt.solve()), float(pj.solve())
    assert ft < ct and abs(ft - fj) <= COST_RTOL * fj


def test_get_materialize_roundtrip():
    """exp.get() (tests/test_computed_arrays.py:170): the port's solve
    lowers the cost as JAX's."""
    src = open(tca.__file__).read().split('    src = """')[2].split('"""')[0]
    rng = np.random.RandomState(1)
    t = rng.rand(10, 10).astype(np.float32)
    (pj, _), (pt, ct) = _both(src, {"W": 10, "H": 10}, {"X": t * 0.5, "A": t}, nIterations=5)
    ft, fj = float(pt.solve()), float(pj.solve())
    assert ft < ct and abs(ft - fj) <= COST_RTOL * fj
