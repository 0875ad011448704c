"""``block_dtype="bf16"`` in the port against the JAX package: the
block-sparse cross blocks stored as bf16, read by the fused-pair kernels
(their plain version on the CPU) and upcast everywhere else.

Scenes: ``synthetic_inputs(16, 1400, 4)`` (the full-repeat point table:
``fullrepeat_setup``'s crosses) and ``skewed_inputs(16, 1400, 5600)``
(rank-keyed level tables: the crosses of ``_setup_levels``).  Both
packages build their plans from the same energy text and numpy inputs
and run on the CPU, where JAX casts every bf16 block back to f32 before
use (its fused Pallas kernel runs on the TPU only), as the port's plain
versions do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import bundle_adjustment as ba  # noqa: E402
from tests.torch_cases import close  # noqa: E402

# the f32 parity bounds of test_torch_ba_slice.py: diag blocks, -JᵀF,
# diag(JᵀJ) and JᵀJ·p (the cross blocks read as the same bf16 values,
# up to the rare entries below) agree to f32 summation order (measured
# <= 3.2e-6 of max|ref|), the block-Jacobi inverses to the camera
# blocks' condition (measured 2.8e-4 uniform, 8.1e-4 skewed)
SETUP_TOL = 1e-4  # x max|ref|
PRECOND_TOL = 1e-3
# Cross blocks.  Both packages round f32 blocks that differ only by f32
# summation order, so an entry whose f32 value lies near a rounding
# boundary may round one bf16 step apart: one step of |ref| is 2^-8 to
# 2^-7 of it (2^(floor(log2 |ref|) - 7)).  Entries near zero by
# cancellation carry the f32 sums' own noise on top, held to
# CROSS_NOISE x max|ref| (measured 3.4e-10: 0.0491 vs 0.0508 beside a max
# of 5.0e6).  Rounding by another rule (truncation, say) would move about
# half the entries by a step, so at most CROSS_DIFFER_SHARE of them may
# differ at all (measured 8 of 151 200 uniform, 3 of 302 400 skewed).
CROSS_NOISE = 1e-6
CROSS_DIFFER_SHARE = 1e-3
# LM steps.  The first step agrees at test_torch_ba_slice.py's f32 bounds
# for the cost (measured 2.0e-4 relative); its unknowns differ by up to
# 2.5e-5 of max|U| (f32 blocks: 2.5e-6), since the few cross entries that
# round a step apart feed the 10 PCG iterations, so they are held to
# BF16_STEP_U_TOL.
STEP_COST_RTOL = 5e-3
BF16_STEP_U_TOL = 2e-4  # x max|U| per image
# At the default trust region radius (1e4) the LM damping, 1e-4 of
# diag(JᵀJ), lies below bf16's rounding of the crosses (up to 2^-9 of each
# entry): the damped bf16 JᵀJ is indefinite along BA's gauge directions,
# and the PCG step from step 2 on depends on f32 summation order far
# beyond any fixed bound.  Measured from JAX's own state after step 1:
# JAX's model cost 49.2, the port's 68.5, the port fed JAX's exact bf16
# blocks 89.5, from a cost of 19.58 (the packages' steps are all rejected;
# at step 3 the port's is accepted and JAX's not, 16.67 against 19.58).
# So steps 1-3 are held at a radius of 1e2 (damping 1e-2 of the
# diagonal, above the rounding), where the bf16 steps are well posed:
# measured <= 8.5e-4 relative in the cost and <= 5.7e-5 of max|U|.
DAMPED_RADIUS = 1e2
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread for the port's ops (see test_torch_ba_slice.py: MKL's
    VML on worker threads was seen to perturb sqrt/sin/cos)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(kind):
    if kind == "uniform":
        inputs, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    else:
        inputs, _ = ba.skewed_inputs(16, 1400, 5600)
    return inputs, {"C": 16, "P": 1400, "O": len(inputs["oToC"])}


def _np(t):
    return {k: np.asarray(v.detach().float() if torch.is_tensor(v) else v, np.float64)
            for k, v in t.items()}


def _plans(kind, radius=None, **kw):
    """(JAX plan, port plan) of the scene, both initialized."""
    inputs, dims = _scene(kind)
    plans = (tl.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", **kw),
             tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device="cpu",
                                            **kw))
    for plan in plans:
        if radius is not None:
            plan.set_solver_parameter("trust_region_radius", radius)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
    return plans


def _setup(plan, p):
    """The setup state's quantities: -JᵀF, diag(JᵀJ), the diag blocks, JᵀJ·p,
    the preconditioner on p, and the stored blocks."""
    comp, prep = plan.compiled, plan._prep
    state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
    jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], state["masks"],
                          state["jac_store"], prep["twin_consts"])
    return {"mjtf": _np(state["r0"]), "diag": _np(state["rawdiag"]),
            "diag_blocks": _np(comp._diag_pair_blocks(prep["consts"], state["jac_store"])),
            "jtjp": _np(jtjp(p)), "precond": _np(comp.precond_apply(state, p)),
            "blocks": state["jac_store"]["0"]["bsr"], "bsr": prep["consts"][0]["bsr"]}


@pytest.fixture(scope="module", params=["uniform", "skewed"])
def setups(request):
    """(JAX's setup, the port's setup) under block_dtype="bf16", with p
    drawn from a seed."""
    pj, pt = _plans(request.param, block_dtype="bf16")
    rng = np.random.default_rng(3)
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in pj._U.items()}
    return (_setup(pj, {k: jnp.asarray(v) for k, v in p.items()}),
            _setup(pt, {k: torch.from_numpy(v) for k, v in p.items()}))


def _jax_cross_wmajor(blk, W, F):
    """JAX's cross block in the port's layout: on the CPU (no fused pair)
    JAX stores it channel-major [F*W, N], f*W + w; the port w-major
    [W*F, N], w*F + f."""
    N = blk.shape[-1]
    return np.asarray(blk.astype(jnp.float32)).reshape(F, W, N).transpose(1, 0, 2).reshape(
        W * F, N)


def test_bf16_cross_blocks_match_jax(setups):
    jax_s, port_s = setups
    assert not jax_s["blocks"].fused  # JAX's CPU path: every block channel-major
    bsr = port_s["bsr"]
    crosses = 0
    for key, pr in enumerate(bsr.pairs):
        blk = port_s["blocks"][key] if pr[2] != "transpose" else None
        if pr[2] == "diag":
            assert blk.dtype == torch.float32  # diag blocks stay f32
        if pr[2] != "col":
            continue
        crosses += 1
        assert blk.dtype == torch.bfloat16
        W, N = bsr.cols[bsr.col_gathers[pr[3]][0]].shape
        F = bsr.slot_channels[pr[0]] * bsr.slot_channels[pr[1]]
        ref = _jax_cross_wmajor(jax_s["blocks"].blocks[key], W, F)
        got = blk.float().numpy()
        assert got.shape == ref.shape
        mag = np.abs(ref)
        step = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7) * (mag > 0)
        diff = np.abs(got.astype(np.float64) - ref)
        assert (diff <= step + CROSS_NOISE * mag.max()).all(), float((diff - step).max())
        assert (diff > 0).mean() <= CROSS_DIFFER_SHARE, int((diff > 0).sum())
    assert crosses >= 1


@pytest.mark.parametrize("what", ["mjtf", "diag", "diag_blocks", "jtjp", "precond"])
def test_bf16_setup_matches_jax(setups, what):
    jax_s, port_s = setups
    ref, got = jax_s[what], port_s[what]
    assert sorted(got) == sorted(ref)
    for name in ref:
        close(got[name], ref[name], PRECOND_TOL if what == "precond" else SETUP_TOL)


def _check_steps(pj, pt, n):
    for k in range(n):
        pj.step()
        pt.step()
        cj, ct = pj.cost(), pt.cost()
        assert np.isfinite(ct) and abs(ct - cj) <= STEP_COST_RTOL * abs(cj), (k, ct, cj)
        ref = {name: np.asarray(v) for name, v in pj._U.items()}
        for name, v in _np(pt.unknowns()).items():
            close(v, ref[name], BF16_STEP_U_TOL)


def test_bf16_first_lm_step_matches_jax():
    """The default solver parameters: step 1 (see DAMPED_RADIUS for why
    not the steps after it)."""
    _check_steps(*_plans("uniform", block_dtype="bf16"), 1)


def test_bf16_lm_steps_match_jax_damped():
    _check_steps(*_plans("uniform", radius=DAMPED_RADIUS, block_dtype="bf16"), STEPS)


def test_bf16_option_spellings():
    """"bf16" and "bfloat16" store the same bf16 crosses; None keeps f32."""
    inputs, dims = _scene("uniform")
    blocks = {}
    for opt in (None, "bf16", "bfloat16"):
        plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device="cpu",
                                              block_dtype=opt)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        state = plan.compiled.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(),
                                          plan._prep)
        blocks[opt] = state["jac_store"]["0"]["bsr"][1]
    assert blocks[None].dtype == torch.float32
    assert blocks["bf16"].dtype == torch.bfloat16
    assert torch.equal(blocks["bf16"], blocks["bfloat16"])
    assert torch.equal(blocks["bf16"], blocks[None].to(torch.bfloat16))


@pytest.mark.parametrize("value", ["fp8", "float16", "f32"])
def test_block_dtype_rejects_other_values(value):
    _, dims = _scene("uniform")
    with pytest.raises(ValueError, match="block_dtype"):
        tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device="cpu",
                                       block_dtype=value)
