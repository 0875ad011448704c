"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here needs an NVIDIA GPU: they carry the `cuda` marker
and skip without one.  No JAX: the card's machine runs the port alone
(`python -m pytest tests/test_torch_cuda.py -m cuda`)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from thallo_tpu_torch.ops import fullrepeat, fusedpair, loopfloor, ohsetup, segsum  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    AGG_SHAPES, CI, CJ, FR_RECIPE, FR_RECIPE2, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES,
    SEG_SHAPES, WLOOP_SHAPES, agg_inputs, bf16_round, close, fr_inputs, fused_inputs,
    hot_ids, oh_inputs, seg_inputs, seg_maps)

# f32 on both sides; only the order of (atomic) sums differs
CUDA_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_cuda_matches_plain(cuda, W, N, S):
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    n0 = fusedpair.fused_pair_apply.launches
    rows, cols = fusedpair.fused_pair_apply(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fusedpair.fused_pair_apply.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


# ragged N; an accumulator above 48 KB (opt-in shared memory); one above
# the persistent kernel's limit (the atomics route)
PAIR_SHAPES = FUSED_SHAPES + [(4, 1002, 64), (2, 1003, 64), (3, 5000, 3000), (3, 600, 3200)]


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_rows_floor_bf16_cuda_matches_plain(cuda, W, N, S):
    """The bf16 persistent kernel without its cols side (a measurement)."""
    args = _bf16_args(cuda, *fused_inputs(W, N, S))
    rows = fusedpair.fused_pair_rows_floor(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    r_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)[0]
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_pair_apply_atomics", "fused_pair_rows_floor"])
@pytest.mark.parametrize("W,N,S", PAIR_SHAPES)
def test_fused_pair_other_kernels_cuda_match_plain(cuda, name, W, N, S):
    """The kept global-atomics body at every shape, and the persistent
    kernel without its cols side wherever fused_pair_route sends it."""
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    fn = getattr(fusedpair, name)
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    if name == "fused_pair_rows_floor" and not fusedpair.persistent_fits(CI, CJ, S):
        with pytest.raises(ValueError, match="no persistent kernel"):
            fn(*args, Ci=CI, Cj=CJ, S=S)
        return
    n0 = fn.launches
    out = fn(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    if name == "fused_pair_rows_floor":
        close(out.cpu(), r_ref.cpu(), CUDA_TOL)
        return
    close(out[0].cpu(), r_ref.cpu(), CUDA_TOL)
    close(out[1].cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,S", PAIR_SHAPES[2:])
def test_fused_pair_routes_cuda_match_plain(cuda, W, N, S):
    """fused_pair_apply launches the persistent kernel where the pair and
    its accumulator fit it (its own count), else the atomics body (that
    wrapper's count), and agrees with the plain version."""
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    counted = (fusedpair.fused_pair_apply if fusedpair.persistent_fits(CI, CJ, S)
               else fusedpair.fused_pair_apply_atomics)
    n0 = counted.launches
    rows, cols = fusedpair.fused_pair_apply(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert counted.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_pair_apply", "fused_pair_apply_atomics"])
@pytest.mark.parametrize("share", [1.0, 0.5, 0.1])
@pytest.mark.parametrize("W,N,S", [(4, 4096, 64), (3, 777, 500)])
def test_fused_pair_duplicate_ids_cuda_match_plain(cuda, name, share, W, N, S):
    """`share` of all entries carry one id (a hot camera): every lane of a
    warp, half of them, or a few.  The hot id's sums hold up to W*N terms,
    so each cols output is held to 4 x 2^-24 sqrt(n) x the sum of its
    terms' magnitudes (chip_smoke.py's rule for the skewed scene)."""
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    args = [torch.from_numpy(a).to(cuda) for a in (hot_ids(ids, share), blocks, pcol, prow)]
    rows, cols = getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    r_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)[0]
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    _close_hot_cols(cols, args, S)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", OH_SHAPES)
def test_oh_products_cuda_matches_plain(cuda, R, N):
    args = [torch.from_numpy(a).to(cuda) for a in oh_inputs(R, N)]
    out = ohsetup.oh_setup_products(*args, N=N, recipe=OH_RECIPE)
    torch.cuda.synchronize()
    ref = ohsetup.oh_setup_products_reference(*args, N=N, recipe=OH_RECIPE)
    close(out.cpu(), ref.cpu(), CUDA_TOL)


def _close_products(out, args, N):
    """Each output within 4 x 2^-24 sqrt(n) x the sum of its n terms'
    magnitudes (a hot id sums half the rows; chip_smoke.py's rule)."""
    ref = ohsetup.oh_setup_products_reference(*args, N=N, recipe=OH_RECIPE)
    mags = ohsetup.oh_setup_products_reference(args[0].abs(), args[1].abs(), args[2], N=N,
                                               recipe=OH_RECIPE)
    n = ohsetup.oh_setup_products_reference(torch.ones_like(args[0]), torch.ones_like(args[1]),
                                            args[2], N=N, recipe=OH_RECIPE)
    assert out.shape == ref.shape
    assert bool(((out - ref).abs() <= 4 * 2.0 ** -24 * n.sqrt() * mags).all())


# OH_RECIPE has a symmetric pair (mirrored) and a cross pair (not): 90
# channels, several chunks of at most 32; N = 3000 leaves room for only a
# few channels a block, 40000 for none (the atomics route); ids:
# out-of-range ones, and `share` of the rows on one id
@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("R,N", OH_SHAPES + [(20000, 3000)])
def test_oh_products_forms_cuda_match_plain(cuda, share, R, N):
    rT, Jall, ids = oh_inputs(R, N)
    args = [torch.from_numpy(a).to(cuda) for a in (rT, Jall, hot_ids(ids, share))]
    plan = ohsetup.products_plan(OH_RECIPE, 2, Jall.shape[0], N, ohsetup.PRODUCTS_THREADS,
                                 ohsetup.PRODUCTS_SMEM)
    assert plan.n_chunks > 1 and (plan.chunk < 16) == (N == 3000)
    n0 = ohsetup.oh_setup_products.launches
    out = ohsetup.oh_setup_products(*args, N=N, recipe=OH_RECIPE)
    torch.cuda.synchronize()
    assert ohsetup.oh_setup_products.launches == n0 + 1
    _close_products(out, args, N)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", OH_SHAPES + [(20000, 40000)])
def test_oh_products_atomics_cuda_matches_plain(cuda, R, N):
    """The first body, directly and where oh_setup_products routes to it
    (one channel row of N = 40000 does not fit the shared memory)."""
    rT, Jall, ids = oh_inputs(R, N)
    args = [torch.from_numpy(a).to(cuda) for a in (rT, Jall, hot_ids(ids, 0.5))]
    routed = ohsetup.products_plan(OH_RECIPE, 2, Jall.shape[0], N, ohsetup.PRODUCTS_THREADS,
                                   ohsetup.PRODUCTS_SMEM) is None
    assert routed == (N == 40000)
    fn = ohsetup.oh_setup_products if routed else ohsetup.oh_setup_products_atomics
    n0 = (ohsetup.oh_setup_products.launches, ohsetup.oh_setup_products_atomics.launches)
    out = fn(*args, N=N, recipe=OH_RECIPE)
    torch.cuda.synchronize()
    assert (ohsetup.oh_setup_products.launches, ohsetup.oh_setup_products_atomics.launches) \
        == (n0[0], n0[1] + 1)
    _close_products(out, args, N)


# N_t not a multiple of the tile, W 2-8 (the tile kernel) and W 9 (the
# first body); a level of many tiles per block; rc 8, Kall 128, W 8: one
# window at a time (no room for two)
FR_CUDA_SHAPES = FR_SHAPES + [(1000, 2), (77, 8), (130, 9), (100_003, 4)]


def _fr_case(N_t, W, recipe, rc=2):
    extra = 2 if recipe == FR_RECIPE2 else 0
    if rc == 8:  # Kall 128: a further slot of 4 channels (FR_RECIPE2's pair on it)
        extra = 4
        recipe = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 24, 9, 0), ("diag", 0, 3, 0, 3)) \
            + ((("cross", 0, 3, 96, 4, 1), ("jtr", 96, 4)) if recipe == FR_RECIPE2 else ())
    return recipe, [torch.from_numpy(a).cuda() for a in fr_inputs(N_t, W, rc=rc, extra=extra)]


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", [FR_RECIPE, FR_RECIPE2], ids=["one_cross", "two_cross"])
@pytest.mark.parametrize("N_t,W,rc", [s + (2,) for s in FR_CUDA_SHAPES] + [(301, 8, 8)])
def test_fullrepeat_cuda_matches_plain(cuda, recipe, N_t, W, rc):
    """fullrepeat_setup launches the tile kernel where fullrepeat_plan has
    a plan (its own count), else the first body (that wrapper's count),
    and agrees with the plain version."""
    recipe, (rT, Jall) = _fr_case(N_t, W, recipe, rc)
    plan = fullrepeat.fullrepeat_plan(recipe, W, Jall.shape[0], rc)
    assert (plan is None) == (W > 8)
    if rc == 8:
        assert plan.stages == 1
    counted = fullrepeat.fullrepeat_setup_thread if plan is None else fullrepeat.fullrepeat_setup
    n0 = counted.launches
    agg, crosses = fullrepeat.fullrepeat_setup(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    torch.cuda.synchronize()
    assert counted.launches == n0 + 1
    ragg, rcross = fullrepeat.fullrepeat_setup_reference(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    assert len(crosses) == len(rcross)
    for got, ref in zip([agg, *crosses], [ragg, *rcross]):
        close(got.cpu(), ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N_t,W", FR_CUDA_SHAPES[:-1])
def test_fullrepeat_thread_cuda_matches_plain(cuda, N_t, W):
    """The first body, kept for the shapes the tile kernel does not take."""
    recipe, (rT, Jall) = _fr_case(N_t, W, FR_RECIPE2)
    n0 = fullrepeat.fullrepeat_setup_thread.launches
    agg, crosses = fullrepeat.fullrepeat_setup_thread(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    torch.cuda.synchronize()
    assert fullrepeat.fullrepeat_setup_thread.launches == n0 + 1
    ragg, rcross = fullrepeat.fullrepeat_setup_reference(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    for got, ref in zip([agg, *crosses], [ragg, *rcross]):
        close(got.cpu(), ref.cpu(), CUDA_TOL)


def _close_aggregate(out, parts, ids, N):
    """Each output within 4 x 2^-24 sqrt(n) x the sum of its n terms'
    magnitudes (a hot id sums up to half the rows; chip_smoke.py's rule),
    and every output within CUDA_TOL x max|ref|."""
    ref = ohsetup.oh_setup_aggregate_reference(parts, ids, N=N)
    mags = ohsetup.oh_setup_aggregate_reference(parts.abs(), ids, N=N)
    n = ohsetup.oh_setup_aggregate_reference(torch.ones_like(parts), ids, N=N)
    assert out.shape == ref.shape
    bound = torch.clamp(4 * 2.0 ** -24 * n.sqrt() * mags, min=CUDA_TOL * float(ref.abs().max()))
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", AGG_SHAPES)
def test_oh_aggregate_cuda_matches_plain(cuda, R, N):
    parts, ids = [torch.from_numpy(a).to(cuda) for a in agg_inputs(R, N)]
    n0 = ohsetup.oh_setup_aggregate.launches
    out = ohsetup.oh_setup_aggregate(parts, ids, N=N)
    torch.cuda.synchronize()
    assert ohsetup.oh_setup_aggregate.launches == n0 + 1
    close(out.cpu(), ohsetup.oh_setup_aggregate_reference(parts, ids, N=N).cpu(), CUDA_TOL)


# R not a multiple of 4 (6161, 4099), out-of-range ids (agg_inputs), one id
# with `share` of the rows, and F = 56 at N = 1024: two channel chunks
@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("F,R,N", [(13, 6161, 300), (9, 200_000, 1024), (56, 4099, 1024),
                                   (18, 20_000, 64)])
def test_oh_aggregate_forms_cuda_match_plain(cuda, share, F, R, N):
    parts, ids = agg_inputs(R, N, F=F)
    parts = torch.from_numpy(parts).to(cuda)
    ids = torch.from_numpy(hot_ids(ids, share)).to(cuda)
    assert ohsetup.aggregate_plan(F, N).n_chunks == (2 if F == 56 else 1)
    n0 = ohsetup.oh_setup_aggregate.launches
    out = ohsetup.oh_setup_aggregate(parts, ids, N=N)
    torch.cuda.synchronize()
    assert ohsetup.oh_setup_aggregate.launches == n0 + 1
    _close_aggregate(out, parts, ids, N)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", AGG_SHAPES + [(5003, 7000)])
def test_oh_aggregate_atomics_cuda_matches_plain(cuda, R, N):
    """The first body, directly and where oh_setup_aggregate routes to it
    (N = 7000: not one batch of channel rows fits the shared memory)."""
    parts, ids = agg_inputs(R, N)
    parts = torch.from_numpy(parts).to(cuda)
    ids = torch.from_numpy(hot_ids(ids, 0.5)).to(cuda)
    routed = ohsetup.aggregate_plan(parts.shape[0], N) is None
    assert routed == (N == 7000)
    fn = ohsetup.oh_setup_aggregate if routed else ohsetup.oh_setup_aggregate_atomics
    n0 = (ohsetup.oh_setup_aggregate.launches, ohsetup.oh_setup_aggregate_atomics.launches)
    out = fn(parts, ids, N=N)
    torch.cuda.synchronize()
    assert (ohsetup.oh_setup_aggregate.launches, ohsetup.oh_setup_aggregate_atomics.launches) \
        == (n0[0], n0[1] + 1)
    _close_aggregate(out, parts, ids, N)


@pytest.mark.cuda
def test_block_jacobi_step_makes_no_host_sync(cuda):
    """One LM step of the small BA scene under block-Jacobi (9x9 camera
    blocks inverted by inv_ex) with torch.cuda.set_sync_debug_mode("error"):
    compiled.nonlinear_step reads nothing back from the card (plan.step
    reads the stop flag after it).  A first step runs outside the mode: it
    uploads the kernels' recipe tables once."""
    _step_makes_no_host_sync(cuda)


@pytest.mark.cuda
def test_bf16_step_makes_no_host_sync(cuda):
    """The same under block_dtype="bf16": the bf16 cross blocks through the
    bf16 W-loop kernel (the point level (4, 1400) is short), no host read."""
    n0 = fusedpair.fused_pair_apply_wloop_bf16.launches
    _step_makes_no_host_sync(cuda, block_dtype="bf16")
    assert fusedpair.fused_pair_apply_wloop_bf16.launches > n0


@pytest.mark.cuda
@pytest.mark.parametrize("linear_solver", ["schur_pcg", "schur_dense"])
def test_schur_step_makes_no_host_sync(cuda, linear_solver):
    """The same under the Schur solves: the reduced PCG (two damped
    block-sparse applies an iteration through the fused-pair kernel), or
    the assembled 144 x 144 camera system and its solve_ex, read nothing
    back from the card."""
    n0 = fusedpair.fused_pair_apply_wloop.launches + fusedpair.fused_pair_apply.launches
    _step_makes_no_host_sync(cuda, linear_solver=linear_solver)
    assert fusedpair.fused_pair_apply_wloop.launches + fusedpair.fused_pair_apply.launches > n0


def _step_makes_no_host_sync(cuda, double=False, **options):
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    spec = tt.load_energy(ba.ENERGY, tt.ProblemSpec(double_precision=double))
    plan = spec.plan(dims, solver="levenberg_marquardt", device=cuda, **options)
    plan.init({k: np.copy(v) for k, v in ins.items()})
    plan.step()
    comp = plan.compiled
    state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), plan._prep)
    assert state["pre_block"]["cameras"].shape == (81, 16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        U, lm, stop, cost = comp.nonlinear_step(plan._U, plan._lm, plan._step_inputs(),
                                                plan._sp(), plan._prep)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(cost)) and all(bool(torch.isfinite(u).all()) for u in U.values())


@pytest.mark.cuda
@pytest.mark.parametrize("M,S,C", SEG_SHAPES)
def test_segsum_cuda_matches_plain(cuda, M, S, C):
    """Row-major and transposed (strided) data; plans whose lanes are
    reordered within each tile (reversed; and interleaved in blocks of 8
    from the two halves of the tile, so one destination's lanes meet a
    warp in separate runs); a NaN row reaches only its own segment."""
    data, ids = seg_inputs(M, S, C)
    plan = segsum.build_plan(ids, S, device=cuda)
    d = torch.from_numpy(data).to(cuda)
    n0 = segsum.segment_sum.launches
    out = segsum.segment_sum(d, plan)
    strided = segsum.segment_sum(d.T.contiguous().T, plan)
    TE = plan.rel.shape[1]
    h = TE // 16 * 8
    halves = np.stack([np.arange(h).reshape(-1, 8), np.arange(h, 2 * h).reshape(-1, 8)], 1)
    orders = [np.arange(TE)[::-1], np.concatenate([halves.reshape(-1), np.arange(2 * h, TE)])]
    reordered = []
    for order in orders:
        o = torch.from_numpy(order.copy()).to(cuda)
        reordered.append(segsum.segment_sum(d, segsum.SegSumPlan(
            plan.gather_idx[:, o].contiguous(), plan.rel[:, o].contiguous(),
            plan.mask[:, o].contiguous(), plan.tile_n, plan.num_segments)))
    torch.cuda.synchronize()
    assert segsum.segment_sum.launches == n0 + 4
    ref = segsum.segment_sum_reference(d, plan).cpu()
    for got in [out, strided] + reordered:
        close(got.cpu(), ref, CUDA_TOL)
    d[7] = float("nan")
    got = segsum.segment_sum(d, plan).cpu().numpy()
    bad = np.zeros(S, bool)
    bad[ids[7]] = True
    assert np.isnan(got[bad]).all() and np.isfinite(got[~bad]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name,ids,S", seg_maps(), ids=[m[0] for m in seg_maps()])
def test_segsum_maps_cuda_match_plain(cuda, name, ids, S):
    """Every pairing of level kernels choose_modes picks (one level and
    two; empty segments; one segment with half the rows), on row-major and
    on transposed channel-major data (the staged kernel where the plan has
    the staged form), each twice with the same bits."""
    C = 9 if name in ("uniform1", "skew", "cams") else 3
    data = np.random.default_rng(10).normal(size=(len(ids), C)).astype(np.float32)
    plan = segsum.build_plan(ids, S, device=cuda)
    d = torch.from_numpy(data).to(cuda)
    n0 = segsum.segment_sum.launches
    cm = d.T.contiguous().T
    out = segsum.segment_sum(d, plan)
    strided = segsum.segment_sum(cm, plan)
    torch.cuda.synchronize()
    assert segsum.segment_sum.launches == n0 + 2
    assert torch.equal(out, segsum.segment_sum(d, plan))
    assert torch.equal(strided, segsum.segment_sum(cm, plan))
    ref = segsum.segment_sum_reference(d, plan)
    n = torch.bincount(torch.from_numpy(ids).long().to(cuda), minlength=S)[:, None]
    bound = 4 * 2.0 ** -24 * n.sqrt() * segsum.segment_sum_reference(d.abs(), plan)
    bound = torch.clamp(bound, min=CUDA_TOL * float(ref.abs().max()))
    assert bool(((out - ref).abs() <= bound).all())
    assert bool(((strided - ref).abs() <= bound).all())
    close(out.cpu(), segsum.segment_sum_compact_reference(d, plan).cpu(), CUDA_TOL)
    if plan.local is not None:
        close(strided.cpu(), segsum.segment_sum_staged_reference(d, plan).cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,S", WLOOP_SHAPES + FUSED_SHAPES)
def test_fused_pair_wloop_cuda_matches_plain(cuda, W, N, S):
    """The W-loop wrapper at wide levels, at narrow ones, and where the
    [Cj, S] accumulator is beyond the persistent kernel (S = 5000: the
    chunked body, whose accumulator runs as several channel chunks)."""
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    counted = (fusedpair.fused_pair_apply_wloop if fusedpair.persistent_fits(CI, CJ, S)
               else fusedpair.fused_pair_apply_wloop_chunked)
    n0 = counted.launches
    rows, cols = fusedpair.fused_pair_apply_wloop(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert counted.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.fixture
def wloop_min_item():
    kept = fusedpair.WLOOP_MIN_ITEM
    yield
    fusedpair.WLOOP_MIN_ITEM = kept


# min_item 1: items split w (rows by global atomics); 64: every item
# covers its elements' whole level (rows stored); a ragged N, a level of
# one tile, out-of-range ids (fused_inputs)
WLOOP_CASES = WLOOP_SHAPES[:2] + [(9, 1001, 1024), (100, 17, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("min_item", [1, 64])
@pytest.mark.parametrize("W,N,S", WLOOP_CASES)
def test_fused_pair_wloop_forms_cuda_match_plain(cuda, wloop_min_item, min_item, W, N, S):
    """The persistent W-loop kernel with its rows stored and added."""
    fusedpair.WLOOP_MIN_ITEM = min_item
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    n0 = fusedpair.fused_pair_apply_wloop.launches
    rows, cols = fusedpair.fused_pair_apply_wloop(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fusedpair.fused_pair_apply_wloop.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,S", WLOOP_SHAPES + FUSED_SHAPES)
def test_fused_pair_wloop_chunked_cuda_matches_plain(cuda, W, N, S):
    """The first W-loop body, kept for the shapes the persistent one does
    not take."""
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    n0 = fusedpair.fused_pair_apply_wloop_chunked.launches
    rows, cols = fusedpair.fused_pair_apply_wloop_chunked(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fusedpair.fused_pair_apply_wloop_chunked.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


def _close_hot_cols(cols, args, S):
    """Each cols output within 4 x 2^-24 sqrt(n) x the sum of its n terms'
    magnitudes: a hot id sums up to W*N terms, and an f32 sum of n terms
    in another order moves by about 2^-24 sqrt(n/3) x that sum
    (chip_smoke.py's rule for the skewed scene)."""
    c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)[1]
    mags = fusedpair.fused_pair_apply_reference(args[0], *(a.abs() for a in args[1:]),
                                                Ci=CI, Cj=CJ, S=S)[1]
    n = fusedpair.fused_pair_apply_reference(args[0], *(torch.ones_like(a) for a in args[1:]),
                                             Ci=CI, Cj=CJ, S=S)[1]
    assert bool(((cols - c_ref).abs() <= 4 * 2.0 ** -24 * n.sqrt() * mags).all())


@pytest.mark.cuda
@pytest.mark.parametrize("min_item", [1, 64])
@pytest.mark.parametrize("share", [1.0, 0.5, 0.1])
@pytest.mark.parametrize("W,N,S", WLOOP_SHAPES[:2])
def test_fused_pair_wloop_duplicate_ids_cuda_match_plain(cuda, wloop_min_item, min_item, share,
                                                        W, N, S):
    """`share` of all entries carry one id (a hot camera): every lane of a
    warp, half of them, or a few; rows to CUDA_TOL, cols to the sum rule."""
    fusedpair.WLOOP_MIN_ITEM = min_item
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    args = [torch.from_numpy(a).to(cuda) for a in (hot_ids(ids, share), blocks, pcol, prow)]
    rows, cols = fusedpair.fused_pair_apply_wloop(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    close(rows.cpu(), fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)[0].cpu(),
          CUDA_TOL)
    _close_hot_cols(cols, args, S)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_pair_bf16", "fused_pair_v1_rows",
                                  "fused_pair_v2_smem", "fused_pair_v3_partials",
                                  "fused_pair_bf16_atomics"])
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_bf16_cuda_matches_plain(cuda, name, W, N, S):
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    args = [torch.from_numpy(ids).to(cuda), torch.from_numpy(bf16_round(blocks)).to(cuda).bfloat16(),
            torch.from_numpy(pcol).to(cuda), torch.from_numpy(prow).to(cuda)]
    fn = getattr(fusedpair, name)
    n0 = fn.launches
    out = fn(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    if name == "fused_pair_v1_rows":
        close(out.cpu(), r_ref.cpu(), CUDA_TOL)
        return
    close(out[0].cpu(), r_ref.cpu(), CUDA_TOL)
    close(out[1].cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1024, 65536])
def test_loop_floor_cuda_matches_plain(cuda, L):
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(8, L)).astype(np.float32)).to(cuda)
    n0 = loopfloor.add_one.launches
    out = loopfloor.add_one(x, tiles=L // 1024)
    torch.cuda.synchronize()
    assert loopfloor.add_one.launches == n0 + 1
    assert torch.equal(out, loopfloor.add_one_reference(x))


@pytest.mark.cuda
def test_loop_floor_cuda_odd_length(cuda):
    """L % 4 != 0 (7 tiles of 143): the kernel reads the [8, L] array as
    8 * L floats, a multiple of 4, so every value lies in some float4; a
    view that is not 16-byte aligned raises."""
    L = 1001
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(8, L)).astype(np.float32)).to(cuda)
    n0 = loopfloor.add_one.launches
    out = loopfloor.add_one(x, tiles=7)
    torch.cuda.synchronize()
    assert loopfloor.add_one.launches == n0 + 1
    assert torch.equal(out, loopfloor.add_one_reference(x))
    shifted = torch.zeros(8 * L + 1, device=cuda)[1:].view(8, L)
    with pytest.raises(ValueError, match="aligned"):
        loopfloor.add_one(shifted)


# ---------------------------------------------------------------------------
# bf16 blocks: the bf16 instantiations of the persistent kernels
# ---------------------------------------------------------------------------
# (kernel, BF16_ELEMS): the persistent kernel at one and two elements a
# thread (odd N takes one either way); the W-loop kernel has one a lane
BF16_PAIR_FORMS = [("fused_pair_apply_bf16", 1), ("fused_pair_apply_bf16", 2),
                   ("fused_pair_apply_wloop_bf16", 1)]


@pytest.fixture
def bf16_elems():
    kept = (fusedpair.BF16_ELEMS, fusedpair.WLOOP_MIN_ITEM)
    yield
    fusedpair.BF16_ELEMS, fusedpair.WLOOP_MIN_ITEM = kept


def _bf16_args(cuda, ids, blocks, pcol, prow):
    """The operands on the card, blocks as bf16 (values rounded first, so
    the plain version reads the same values)."""
    return [torch.from_numpy(ids).to(cuda),
            torch.from_numpy(bf16_round(blocks)).to(cuda).bfloat16(),
            torch.from_numpy(pcol).to(cuda), torch.from_numpy(prow).to(cuda)]


# ragged N, even (2 elements a thread) and odd (1); wide levels; a level
# of one W-loop tile; out-of-range and negative ids (fused_inputs)
BF16_SHAPES = FUSED_SHAPES + WLOOP_SHAPES[:2] + [(9, 1001, 1024), (100, 18, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,elems", BF16_PAIR_FORMS)
@pytest.mark.parametrize("W,N,S", BF16_SHAPES)
def test_fused_pair_bf16_instantiations_cuda_match_plain(cuda, bf16_elems, name, elems, W, N, S):
    """Each bf16 persistent kernel, reached through the f32 wrappers'
    dtype dispatch, against the plain version on the same bf16 values: f32
    arithmetic on both sides, only the order of (atomic) sums differs."""
    fusedpair.BF16_ELEMS = elems
    args = _bf16_args(cuda, *fused_inputs(W, N, S))
    fn = getattr(fusedpair, name)
    entry = fusedpair.fused_pair_apply if name == "fused_pair_apply_bf16" \
        else fusedpair.fused_pair_apply_wloop
    n0 = fn.launches
    rows, cols = entry(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("min_item", [1, 64])
@pytest.mark.parametrize("W,N,S", WLOOP_SHAPES[:2] + [(100, 18, 64)])
def test_fused_pair_wloop_bf16_forms_cuda_match_plain(cuda, bf16_elems, min_item, W, N, S):
    """The bf16 W-loop kernel with its rows stored (items cover the whole
    level) and added (w split)."""
    fusedpair.WLOOP_MIN_ITEM = min_item
    args = _bf16_args(cuda, *fused_inputs(W, N, S))
    rows, cols = fusedpair.fused_pair_apply_wloop_bf16(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,elems", BF16_PAIR_FORMS)
@pytest.mark.parametrize("share", [1.0, 0.5, 0.1])
@pytest.mark.parametrize("W,N,S", [(4, 4096, 64), (24, 334, 300)])
def test_fused_pair_bf16_duplicate_ids_cuda_match_plain(cuda, bf16_elems, name, elems, share, W,
                                                        N, S):
    """`share` of all entries on one id (a hot camera): rows to CUDA_TOL,
    cols to the hot-camera sqrt(n) rule."""
    fusedpair.BF16_ELEMS = elems
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    args = _bf16_args(cuda, hot_ids(ids, share), blocks, pcol, prow)
    rows, cols = getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    close(rows.cpu(), fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)[0].cpu(),
          CUDA_TOL)
    _close_hot_cols(cols, args, S)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["fused_pair_apply", "fused_pair_apply_wloop"])
@pytest.mark.parametrize("Ci,Cj,W,N,S", [(3, 9, 3, 600, 3200), (2, 5, 4, 1001, 300),
                                         (3, 9, 24, 333, 3200)])
def test_fused_pair_bf16_atomics_route_cuda_matches_plain(cuda, entry, Ci, Cj, W, N, S):
    """bf16 shapes the persistent kernels do not take (a [9, S] accumulator
    beyond PERSISTENT_MAX_SMEM, a pair other than 3 x 9) go to the bf16
    atomics route's slots kernel, fused_pair_apply_atomics_bf16, from both
    entry points."""
    rng = np.random.default_rng(8)
    ids = rng.integers(-2, S + 3, (W, N)).astype(np.int32)
    args = _bf16_args(cuda, ids, rng.normal(size=(W * Ci * Cj, N)).astype(np.float32),
                      rng.normal(size=(Cj, S)).astype(np.float32),
                      rng.normal(size=(Ci, N)).astype(np.float32))
    assert not fusedpair.persistent_fits(Ci, Cj, S)
    n0 = fusedpair.fused_pair_apply_atomics_bf16.launches
    rows, cols = getattr(fusedpair, entry)(*args, Ci=Ci, Cj=Cj, S=S)
    torch.cuda.synchronize()
    assert fusedpair.fused_pair_apply_atomics_bf16.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
def test_skewed_setup_and_apply_cuda_matches_cpu(cuda):
    """The level tables on the card: skewed_inputs(16, 1400, 5600) (point
    levels (8, 1400), (24, 62), (273, 13); the residual sort) gives the
    same -JᵀF, diag and JᵀJ·p on the card as on the CPU, each level
    through the kernel fused_pair_route names for it."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.skewed_inputs(16, 1400, 5600)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    rng = np.random.default_rng(3)
    out = {}
    names = ("fused_pair_apply", "fused_pair_apply_wloop")
    n0 = [getattr(fusedpair, n).launches for n in names]
    for device in ("cuda", "cpu"):
        plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device=device)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        comp, consts = plan.compiled, plan._prep["consts"]
        p = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)).to(device)
             for k, v in plan._U.items()}
        rng = np.random.default_rng(3)
        mjtf, diag, store = comp.jtf_and_diag(plan._U, plan._step_inputs(), consts, None, {})
        jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), consts, None, store)(p)
        out[device] = [{k: v.cpu() for k, v in t.items()} for t in (mjtf, diag, jtjp)]
    torch.cuda.synchronize()
    # one launch per level, of the kernel fused_pair_route names for it:
    # (8, 1400) the persistent kernel, (24, 62) and (273, 13) the W-loop one
    routes = [fusedpair.fused_pair_route(W, N_t, CI, CJ, 16)
              for W, N_t in ((8, 1400), (24, 62), (273, 13))]
    assert [getattr(fusedpair, n).launches - k for n, k in zip(names, n0)] \
        == [routes.count(n) for n in names]
    for got, ref in zip(out["cuda"], out["cpu"]):
        for k in ref:
            close(got[k], ref[k], 1e-4)


# ---------------------------------------------------------------------------
# the variants v2 and v3 of scripts/tpu_fused_variants.py: the cluster
# kernel (csrc/fused_pair_cluster.cu) and their first bodies (_generic)
# ---------------------------------------------------------------------------
VARIANTS = ["fused_pair_v2_smem", "fused_pair_v3_partials"]
VARIANT_ROUTES = VARIANTS + [n + "_generic" for n in VARIANTS]
# every wrapper whose count the variants' tests watch
V1_ROUTES = ["fused_pair_v1_rows", "fused_pair_v1_rows_generic"]
WATCHED = VARIANT_ROUTES + V1_ROUTES + ["fused_pair_cluster_noflush", "fused_pair_bf16",
                                        "fused_pair_bf16_atomics", "fused_pair_apply",
                                        "fused_pair_apply_bf16", "fused_pair_apply_atomics_bf16"]
# FUSED_SHAPES (ragged N, odd and even), the uniform 1M BA shape and the
# JAX script's skew_level_w8
VARIANT_SHAPES = FUSED_SHAPES + [(4, 250_000, 1024), (8, 16384, 256)]


def _launched(n0):
    """The watched wrappers' launches since the counts n0."""
    return {n: getattr(fusedpair, n).launches - k for n, k in zip(WATCHED, n0)}


def _counts():
    return [getattr(fusedpair, n).launches for n in WATCHED]


@pytest.mark.cuda
@pytest.mark.parametrize("name", VARIANT_ROUTES)
@pytest.mark.parametrize("W,N,S", VARIANT_SHAPES)
def test_fused_pair_variants_cuda_match_plain(cuda, name, W, N, S):
    """The cluster kernel (v2: a global atomic per nonzero entry per
    cluster; v3: a slab per cluster, summed by torch.sum) and both first
    bodies against the plain version on the same bf16 values: f32 on both
    sides, only the order of sums differs.  Exactly one launch, of the
    wrapper called."""
    args = _bf16_args(cuda, *fused_inputs(W, N, S))
    n0 = _counts()
    rows, cols = getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert _launched(n0) == {n: int(n == name) for n in WATCHED}
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,S", VARIANT_SHAPES)
def test_fused_pair_cluster_noflush_cuda_matches_plain(cuda, W, N, S):
    """The cluster kernel without its cross-cluster step (a measurement):
    its rows, one launch."""
    args = _bf16_args(cuda, *fused_inputs(W, N, S))
    n0 = _counts()
    rows = fusedpair.fused_pair_cluster_noflush(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert _launched(n0) == {n: int(n == "fused_pair_cluster_noflush") for n in WATCHED}
    close(rows.cpu(), fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)[0].cpu(),
          CUDA_TOL)


@pytest.fixture
def cluster_size():
    kept = fusedpair.CLUSTER_SIZE
    yield
    fusedpair.CLUSTER_SIZE = kept


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 8, 16])
@pytest.mark.parametrize("name", VARIANTS)
def test_fused_pair_variants_cluster_sizes_cuda_match_plain(cuda, cluster_size, C, name):
    """Other cluster sizes (1: each block its own cluster, a per-block
    flush; 16: a non-portable size, which the H100 grants), at a ragged
    odd N."""
    fusedpair.CLUSTER_SIZE = C
    args = _bf16_args(cuda, *fused_inputs(3, 4097, 500))
    rows, cols = getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=500)
    torch.cuda.synchronize()
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=500)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("Ci,Cj,W,N,S", [(2, 5, 4, 1001, 300), (8, 16, 3, 777, 1024)])
def test_fused_pair_variants_generic_route_cuda_matches_plain(cuda, name, Ci, Cj, W, N, S):
    """Pairs the cluster kernel is not specialised for go to the variant's
    first body (its count moves, the cluster kernel's does not); a 3 x 9
    accumulator beyond both kernels' shared memory raises."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-2, S + 3, (W, N)).astype(np.int32)
    args = _bf16_args(cuda, ids, rng.normal(size=(W * Ci * Cj, N)).astype(np.float32),
                      rng.normal(size=(Cj, S)).astype(np.float32),
                      rng.normal(size=(Ci, N)).astype(np.float32))
    assert fusedpair.variant_route(name, Ci, Cj, S) == name + "_generic"
    n0 = _counts()
    rows, cols = getattr(fusedpair, name)(*args, Ci=Ci, Cj=Cj, S=S)
    torch.cuda.synchronize()
    assert _launched(n0) == {n: int(n == name + "_generic") for n in WATCHED}
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)
    big = _bf16_args(cuda, *fused_inputs(2, 100, 3200))
    with pytest.raises(ValueError, match="no kernel"):
        getattr(fusedpair, name)(*big, Ci=CI, Cj=CJ, S=3200)


@pytest.fixture(scope="module")
def skew_1m_tables():
    """The skewed 1M BA scene's level-0 and widest col tables (ids [W, N_t]
    on the card, after the residual sort), as its plan builds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.skewed_inputs(n_cameras=1024, n_points=250_000, target_obs=1_000_000, seed=0)
    plan = tt.load_energy(ba.ENERGY).plan({"C": 1024, "P": 250_000, "O": len(ins["oToC"])},
                                          solver="levenberg_marquardt", device="cuda")
    plan.init(ins)
    bsr = plan._prep["consts"][0]["bsr"]
    cols = [bsr.cols[bsr.col_gathers[pr[3]][0]] for pr in bsr.pairs if pr[2] == "col"]
    return {"level0": cols[0], "widest": cols[-1]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", VARIANT_ROUTES)
@pytest.mark.parametrize("level", ["level0", "widest"])
def test_fused_pair_variants_skew_1m_cuda_match_plain(cuda, skew_1m_tables, name, level):
    """The skewed 1M scene's tables, where the hot camera sums ~1e6 terms
    into one output: rows to CUDA_TOL, cols to 4 x 2^-24 sqrt(n) x the sum
    of each output's terms' magnitudes (_close_hot_cols)."""
    ids = skew_1m_tables[level]
    W, N = ids.shape
    rng = np.random.default_rng(10)
    args = _bf16_args(cuda, ids.cpu().numpy(),
                      rng.normal(size=(W * CI * CJ, N)).astype(np.float32),
                      rng.normal(size=(CJ, 1024)).astype(np.float32),
                      rng.normal(size=(CI, N)).astype(np.float32))
    n0 = _counts()
    rows, cols = getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=1024)
    torch.cuda.synchronize()
    assert _launched(n0) == {n: int(n == name) for n in WATCHED}
    close(rows.cpu(), fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=1024)[0].cpu(),
          CUDA_TOL)
    _close_hot_cols(cols, args, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,counted,dtype", [
    ("fused_pair_apply", "fused_pair_apply", torch.float32),
    ("fused_pair_apply", "fused_pair_apply_bf16", torch.bfloat16),
    ("fused_pair_apply_bf16", "fused_pair_apply_bf16", torch.bfloat16)])
def test_solver_fused_pair_keeps_its_kernel(cuda, entry, counted, dtype):
    """The solver's fused pair still launches csrc/fused_pair.cu's
    persistent kernel in f32 and bf16: its count moves, the cluster
    kernel's and the variants' do not."""
    ids, blocks, pcol, prow = fused_inputs(4, 4096, 1024)
    args = _bf16_args(cuda, ids, blocks, pcol, prow)
    if dtype == torch.float32:
        args[1] = args[1].float()
    n0 = _counts()
    rows, cols = getattr(fusedpair, entry)(*args, Ci=CI, Cj=CJ, S=1024)
    torch.cuda.synchronize()
    assert _launched(n0) == {n: int(n == counted) for n in WATCHED}
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=1024)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


# ---------------------------------------------------------------------------
# the variant v1 of scripts/tpu_fused_variants.py (make_v1, rows only): the
# rows kernel (csrc/fused_pair_rows.cu) and its first body (_generic)
# ---------------------------------------------------------------------------
# FUSED_SHAPES, the uniform 1M BA shape, an even N that is no multiple of 4
# (two elements a thread), an odd N (one), and a wide S
V1_SHAPES = FUSED_SHAPES + [(4, 250_000, 1024), (4, 1002, 64), (3, 4097, 500), (2, 1000, 3000)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", V1_ROUTES)
@pytest.mark.parametrize("W,N,S", V1_SHAPES)
def test_fused_pair_v1_rows_cuda_matches_plain(cuda, name, W, N, S):
    """The rows kernel and v1's first body against the plain version's rows
    on the same bf16 values (out-of-range and negative ids included): f32
    on both sides.  Exactly one launch, of the wrapper called."""
    args = _bf16_args(cuda, *fused_inputs(W, N, S))
    n0 = _counts()
    rows = getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert _launched(n0) == {n: int(n == name) for n in WATCHED}
    close(rows.cpu(), fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)[0].cpu(),
          CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Ci,Cj,W,N,S", [(2, 5, 4, 1001, 300), (8, 16, 3, 777, 1024)])
def test_fused_pair_v1_rows_generic_route_cuda_matches_plain(cuda, Ci, Cj, W, N, S):
    """Pairs the rows kernel is not specialised for go to v1's first body:
    its count moves, the rows kernel's does not."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-2, S + 3, (W, N)).astype(np.int32)
    args = _bf16_args(cuda, ids, rng.normal(size=(W * Ci * Cj, N)).astype(np.float32),
                      rng.normal(size=(Cj, S)).astype(np.float32),
                      rng.normal(size=(Ci, N)).astype(np.float32))
    n0 = _counts()
    rows = fusedpair.fused_pair_v1_rows(*args, Ci=Ci, Cj=Cj, S=S)
    torch.cuda.synchronize()
    assert _launched(n0) == {n: int(n == "fused_pair_v1_rows_generic") for n in WATCHED}
    close(rows.cpu(), fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)[0].cpu(),
          CUDA_TOL)


# ---------------------------------------------------------------------------
# the grid path (image_warping) and the dense JᵀJ path on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_grid_run_steps_makes_no_host_sync(cuda):
    """A GN run_steps batch of image_warping (64 x 64, an excluded square,
    LINEARIZE) under
    torch.cuda.set_sync_debug_mode("error"): no step reads anything back
    from the card (GN has no device-side stop flag to read).  warmup()
    runs first, outside the mode; the excluded unknowns do not move."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from torch_grid_profile import make_grid_plan

    mask = (slice(24, 40), slice(24, 40))
    plan = make_grid_plan(64, cuda, mask=mask)
    assert plan.compiled.groups[0].schedule.value == "linearize"
    U0 = {k: v.clone() for k, v in plan.unknowns().items()}
    plan.warmup()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert plan.run_steps(3) == 3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for k, v in plan.unknowns().items():
        assert bool(torch.isfinite(v).all())
        assert torch.equal(v[mask], U0[k][mask])
    assert not torch.equal(plan.unknowns()["Offset"], U0["Offset"])


@pytest.mark.cuda
def test_dense_step_matmuls_run_in_full_f32(cuda, monkeypatch):
    """The dense JᵀJ path (the 4-camera BA scene, 228 unknowns) with TF32
    allowed process-wide: every matmul of an LM step runs with
    torch.backends.cuda.matmul.allow_tf32 off, the global setting is back
    after the step, and the step agrees with one taken with TF32 off to
    the card's run-to-run f32 noise (two such steps differ by ~5e-5 of an
    entry, measured; TF32's 10-bit mantissa would move JᵀJ by ~1e-3)."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.solver import gn

    ins, _ = ba.synthetic_inputs(n_cameras=4, n_points=64, obs_per_point=3)
    dims = {"C": 4, "P": 64, "O": len(ins["oToC"])}
    seen, real = [], torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    kept = torch.backends.cuda.matmul.allow_tf32
    steps = {}
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device=cuda)
            plan.init({k: np.copy(v) for k, v in ins.items()})
            assert plan.compiled._is_dense(plan.compiled.groups[0], plan._prep["consts"][0])
            monkeypatch.setattr(gn.torch, "matmul", spy)
            plan.step()
            monkeypatch.setattr(gn.torch, "matmul", real)
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
            steps[tf32] = {k: v.cpu() for k, v in plan.unknowns().items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = kept
    assert seen and not any(seen)
    for k in steps[False]:
        close(steps[True][k], steps[False][k], 1e-4)


@pytest.mark.cuda
def test_direct_solve_matmuls_run_in_full_f32(cuda, monkeypatch):
    """linear_solver="direct" (JᵀJ and Jᵀr of the dense Jacobian) with
    TF32 allowed process-wide: every matmul of an LM step runs with
    torch.backends.cuda.matmul.allow_tf32 off, the global setting is back
    after the step, and the step agrees with one taken with TF32 off to
    the card's run-to-run f32 noise (as the dense JᵀJ path above)."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.solver import gn

    ins, _ = ba.synthetic_inputs(n_cameras=4, n_points=64, obs_per_point=3)
    dims = {"C": 4, "P": 64, "O": len(ins["oToC"])}
    seen, real, direct = [], torch.matmul, gn.CompiledSolver._direct_solve
    calls = []

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    def counted(self, *args):
        calls.append(1)
        return direct(self, *args)

    kept = torch.backends.cuda.matmul.allow_tf32
    steps = {}
    monkeypatch.setattr(gn.CompiledSolver, "_direct_solve", counted)
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device=cuda,
                                                  linear_solver="direct")
            plan.init({k: np.copy(v) for k, v in ins.items()})
            monkeypatch.setattr(gn.torch, "matmul", spy)
            plan.step()
            monkeypatch.setattr(gn.torch, "matmul", real)
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
            steps[tf32] = {k: v.cpu() for k, v in plan.unknowns().items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = kept
    assert len(calls) == 2 and seen and not any(seen)
    for k in steps[False]:
        close(steps[True][k], steps[False][k], 1e-4)


# ---------------------------------------------------------------------------
# the graph models: ARAP's (3, 3) levels on fused_pair_apply_atomics
# ---------------------------------------------------------------------------
def _arap_plan(cuda, side, shuffle=False):
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import arap_mesh_deformation as arap

    ins = arap.synthetic_inputs(side=side)
    if shuffle:
        ins = arap.shuffle_edges(ins, seed=0)
    plan = tt.load_energy(arap.ENERGY).plan({"N": side * side, "E": len(ins["V0"])},
                                            solver="gauss_newton", device=cuda)
    plan.set_solver_parameter("lIterations", 10)
    plan.init(ins)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("side,shuffle", [(256, False), (256, True), (48, False)])
def test_fused_pair_atomics_arap_levels_cuda_match_plain(cuda, side, shuffle):
    """fused_pair_apply_atomics at the level shapes ARAP's reg group gives
    it: each (3, 3) col pair's table ([4, side²] element ids of the
    generator's or the shuffled edge order, S = side² cols) with seeded
    blocks, pcol and prow; exactly one launch a call, CUDA_TOL."""
    bsr = _arap_plan(cuda, side, shuffle)._prep["consts"][1]["bsr"]
    S = side * side
    rng = np.random.default_rng(side)
    levels = [bsr.cols[bsr.col_gathers[pr[3]][0]] for pr in bsr.pairs if pr[2] == "col"]
    assert [tuple(ids.shape) for ids in levels] == [(4, S)] * 2
    for ids in levels:
        W, N = ids.shape
        args = (ids, *(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
                       for s in ((W * 9, N), (3, S), (3, N))))
        assert fusedpair.fused_pair_route(W, N, 3, 3, S) == "fused_pair_apply_atomics"
        n0 = fusedpair.fused_pair_apply_atomics.launches
        rows, cols = fusedpair.fused_pair_apply_atomics(*args, Ci=3, Cj=3, S=S)
        torch.cuda.synchronize()
        assert fusedpair.fused_pair_apply_atomics.launches == n0 + 1
        r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=3, Cj=3, S=S)
        close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
        close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
def test_arap_run_steps_makes_no_host_sync(cuda):
    """A GN run_steps batch of ARAP at side 48 (13 824 unknowns: its reg
    group on rank-keyed tables through fused_pair_apply_atomics, its fit
    group from stored point Jacobians) under
    torch.cuda.set_sync_debug_mode("error"): no step reads anything back
    from the card.  warmup() runs first, outside the mode."""
    plan = _arap_plan(cuda, 48)
    plan.warmup()
    torch.cuda.synchronize()
    n0 = fusedpair.fused_pair_apply_atomics.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert plan.run_steps(3) == 3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # 2 col pairs x 10 PCG iterations x 3 steps
    assert fusedpair.fused_pair_apply_atomics.launches - n0 == 60
    for v in plan.unknowns().values():
        assert bool(torch.isfinite(v).all())
    assert plan.final_cost < 120.0


@pytest.mark.cuda
@pytest.mark.parametrize("Ci,Cj", [(3, 3), (9, 3), (3, 9), (16, 16), (1, 1)])
@pytest.mark.parametrize("W,N,S", [(4, 1600, 1600), (3, 777, 500)])
def test_fused_pair_atomics_channel_counts_cuda_match_plain(cuda, Ci, Cj, W, N, S):
    """The atomics body at the graph models' pairs (ARAP's 3 x 3, the
    embedded graph's 9-channel rotation rows against 3-channel offsets)
    and at its limits: one launch, CUDA_TOL; 17 row channels raise."""
    rng = np.random.default_rng(Ci * 100 + Cj)
    ids = rng.integers(0, S, (W, N)).astype(np.int32)
    ids[:, -7:] = S + 3
    ids[0, :5] = -1
    args = (torch.from_numpy(ids).to(cuda),
            *(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
              for s in ((W * Ci * Cj, N), (Cj, S), (Ci, N))))
    n0 = fusedpair.fused_pair_apply_atomics.launches
    rows, cols = fusedpair.fused_pair_apply_atomics(*args, Ci=Ci, Cj=Cj, S=S)
    torch.cuda.synchronize()
    assert fusedpair.fused_pair_apply_atomics.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)
    big = (args[0], torch.zeros((W * 17 * Cj, N), device=cuda), args[2],
           torch.zeros((17, N), device=cuda))
    with pytest.raises(ValueError, match="outside"):
        fusedpair.fused_pair_apply_atomics(*big, Ci=17, Cj=Cj, S=S)


@pytest.mark.cuda
@pytest.mark.parametrize("Ci,route", [(fusedpair.MAX_CI, "fused_pair_apply_wloop_chunked"),
                                      (fusedpair.MAX_CI + 1, "fused_pair_apply_atomics")])
def test_wide_level_routes_by_row_channels_cuda(cuda, Ci, route):
    """A wide level (W = 9) of a pair with Ci row channels, as a vertex of
    degree 9 gives the embedded graph's rotation rows: the kernel
    fused_pair_route names takes it (the chunked W-loop kernel up to
    MAX_CI, the atomics body beyond), one launch, CUDA_TOL."""
    W, N, Cj, S = 9, 1001, 3, 64
    assert fusedpair.fused_pair_route(W, N, Ci, Cj, S) == route
    rng = np.random.default_rng(Ci)
    ids = rng.integers(0, S, (W, N)).astype(np.int32)
    ids[:, -7:] = S + 3
    args = (torch.from_numpy(ids).to(cuda),
            *(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
              for s in ((W * Ci * Cj, N), (Cj, S), (Ci, N))))
    fn = getattr(fusedpair, route)
    n0 = fn.launches
    rows, cols = fn(*args, Ci=Ci, Cj=Cj, S=S)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


# the kernel wrappers the block-sparse solver calls on f32 blocks
PATH_KERNELS = ("oh_setup_products", "fullrepeat_setup", "fused_pair_apply",
                "fused_pair_apply_atomics", "fused_pair_apply_wloop",
                "fused_pair_apply_wloop_chunked")


def _path_plan(cuda, which):
    import thallo_tpu_torch as tt

    if which == "sparse_bundle_fusion":
        from thallo_tpu_torch.models.cases import model_case

        m, ins, dims, solver, _ = model_case(which, big=True)
        plan = tt.load_energy(m.ENERGY).plan(dims, solver=solver, device=cuda)
    else:
        from pathlib import Path

        from thallo_tpu_torch import io
        from thallo_tpu_torch.models import arap_mesh_deformation as arap

        data = Path(__file__).resolve().parent.parent / "examples" / "data"
        verts, faces, _ = io.load_ply(str(data / "sample_mesh.ply"))
        pull = {0: verts[0] + np.array([0, 0, 0.5], np.float32), len(verts) - 1: verts[-1]}
        ins, dims = io.mesh_to_arap_inputs(verts, faces, constraints=pull)
        plan = tt.load_energy(arap.ENERGY).plan(dims, solver="gauss_newton", device=cuda)
    plan.init(ins)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("which,want", [
    ("sparse_bundle_fusion", {"oh_setup_products", "fused_pair_apply_wloop_chunked"}),
    ("sample_mesh_ply", {"oh_setup_products", "fused_pair_apply_atomics"})])
def test_path_kernels_cuda_match_plain(cuda, monkeypatch, which, want):
    """Every kernel one solver step launches on sparse_bundle_fusion at 800
    frames x 16 correspondences (its frames' one-hot recipe, its [16, 800]
    (3, 3) col levels) and on the committed PLY mesh as ARAP, at the
    shapes, recipes and tables of that step, on seeded values: one launch
    a call, CUDA_TOL."""
    from thallo_tpu_torch.solver import blocksparse

    plan = _path_plan(cuda, which)
    calls = {}
    for name in PATH_KERNELS:
        def record(*a, real=getattr(blocksparse, name), name=name, **k):
            table = a[2] if name == "oh_setup_products" else a[0]
            calls.setdefault((name, table.data_ptr(), tuple(sorted(k.items()))), (name, a, k))
            return real(*a, **k)
        monkeypatch.setattr(blocksparse, name, record)
    plan.step()
    monkeypatch.undo()
    assert {c[0] for c in calls.values()} == want
    rng = np.random.default_rng(5)

    def normal(x):
        return torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(cuda)

    for name, a, k in calls.values():
        if name == "oh_setup_products":
            args = (normal(a[0]), normal(a[1]), a[2])
            refs = (ohsetup.oh_setup_products_reference(*args, **k),)
        elif name == "fullrepeat_setup":
            args = (normal(a[0]), normal(a[1]))
            agg, crosses = fullrepeat.fullrepeat_setup_reference(*args, **k)
            refs = (agg, *crosses)
        else:
            args = (a[0], normal(a[1]), normal(a[2]), normal(a[3]))
            refs = fusedpair.fused_pair_apply_reference(*args, **k)
        fn = getattr(ohsetup if name == "oh_setup_products" else
                     fullrepeat if name == "fullrepeat_setup" else fusedpair, name)
        n0 = fn.launches
        out = fn(*args, **k)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1, name
        if name == "oh_setup_products":
            out = (out,)
        elif name == "fullrepeat_setup":
            out = (out[0], *out[1])
        for got, ref in zip(out, refs):
            close(got.cpu(), ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Ci,Cj", [(9, 3), (16, 3)])
def test_fused_pair_bf16_atomics_wide_rows_cuda_match_plain(cuda, Ci, Cj):
    """The first bf16 atomics body at more than 8 row channels
    (instantiated per (Ci, Cj) bound, as the f32 one), at a wide level (W =
    12) that fused_pair_route(bf16=True) sends to the bf16 slots kernel:
    one launch, CUDA_TOL on the same bf16 values; 17 row channels raise."""
    W, N, S = 12, 1001, 500
    assert fusedpair.fused_pair_route(W, N, Ci, Cj, S, bf16=True) == \
        "fused_pair_apply_atomics_bf16"
    rng = np.random.default_rng(Ci)
    ids = rng.integers(0, S, (W, N)).astype(np.int32)
    ids[:, -7:] = S + 3
    args = (torch.from_numpy(ids).to(cuda),
            torch.from_numpy(bf16_round(rng.normal(size=(W * Ci * Cj, N)).astype(np.float32)))
            .to(cuda).bfloat16(),
            *(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
              for s in ((Cj, S), (Ci, N))))
    n0 = fusedpair.fused_pair_bf16_atomics.launches
    rows, cols = fusedpair.fused_pair_bf16_atomics(*args, Ci=Ci, Cj=Cj, S=S)
    torch.cuda.synchronize()
    assert fusedpair.fused_pair_bf16_atomics.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)
    big = (args[0], torch.zeros((W * 17 * Cj, N), device=cuda).bfloat16(), args[2],
           torch.zeros((17, N), device=cuda))
    with pytest.raises(ValueError, match="outside"):
        fusedpair.fused_pair_bf16_atomics(*big, Ci=17, Cj=Cj, S=S)


def _item6_plan(cuda, which):
    """A plan of chip_smoke.py's phase-2 model cases of the contractions and
    sampled images, initialised on the card."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models.cases import case_energy, model_case

    if which == "embedded_bf16":
        name = "embedded_mesh_deformation"
        m, ins, dims, solver, _ = model_case(name, big=True)
        plan = tt.load_energy(case_energy(name, m)).plan(dims, solver=solver, device=cuda,
                                                         block_dtype="bf16")
    else:  # "<name>_big": CASES' size above the dense threshold
        name = which.removesuffix("_big")
        m, ins, dims, solver, _ = model_case(name, big=which.endswith("_big"))
        plan = tt.load_energy(case_energy(name, m)).plan(dims, solver=solver, device=cuda)
    plan.init(ins)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("which,want", [
    ("deconvolution", {"segment_sum"}),
    ("spatially_varying_deconvolution", {"segment_sum"}),
    ("face_fitting", {"segment_sum"}),
    ("bundle_fusion", {"segment_sum"}),
    ("bundle_fusion_big", {"oh_setup_products", "fused_pair_apply_atomics"}),
    ("embedded_bf16", {"fused_pair_apply_atomics_bf16"})])
def test_item6_path_kernels_cuda_match_plain(cuda, monkeypatch, which, want):
    """Every kernel one solver step launches on the contraction and
    sampled-image models at tests/test_models2.py's sizes (their stored
    point Jacobians' small-image scatters through the fixed-order segment
    sum, lower.fixed_order_plan),
    bundle_fusion at 700 frames (one-hot camera rows) and embedded
    deformation under block_dtype="bf16" (its 9-channel rotation rows on
    the bf16 slots kernel), at that step's shapes, recipes and tables on
    seeded values: one launch a call (the fixed-order plans' on
    segment_sum_fixed_order), CUDA_TOL."""
    from thallo_tpu_torch import lower
    from thallo_tpu_torch.solver import blocksparse

    plan = _item6_plan(cuda, which)
    calls = {}
    names = PATH_KERNELS + ("fused_pair_apply_atomics_bf16",)
    for mod, name in [(blocksparse, n) for n in names] + [(lower, "oh_setup_aggregate"),
                                                          (lower, "segment_sum")]:
        def record(*a, real=getattr(mod, name), name=name, **k):
            table = a[2] if name == "oh_setup_products" else a[1] \
                if name == "oh_setup_aggregate" else a[1].order if name == "segment_sum" \
                else a[0]
            calls.setdefault((name, table.data_ptr(),
                              tuple(getattr(a_, "shape", None) for a_ in a),
                              tuple(sorted(k.items()))), (name, a, k))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, record)
    plan.step()
    monkeypatch.undo()
    assert {c[0] for c in calls.values()} == want
    rng = np.random.default_rng(7)

    def normal(x):
        return torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(
            device=cuda, dtype=x.dtype)

    for name, a, k in calls.values():
        if name == "oh_setup_products":
            args = (normal(a[0]), normal(a[1]), a[2])
            refs = (ohsetup.oh_setup_products_reference(*args, **k),)
            fn = ohsetup.oh_setup_products
        elif name == "oh_setup_aggregate":
            args = (normal(a[0]), a[1])
            refs = (ohsetup.oh_setup_aggregate_reference(*args, **k),)
            fn = ohsetup.oh_setup_aggregate
        elif name == "segment_sum":
            args = (normal(a[0].T).T, a[1])  # channel-major values, as scatter_route's
            refs = (segsum.segment_sum_reference(*args),)
            fn = segsum.segment_sum_fixed_order if a[1].block_run is not None \
                else segsum.segment_sum
        else:
            args = (a[0], normal(a[1]), normal(a[2]), normal(a[3]))
            refs = fusedpair.fused_pair_apply_reference(*args, **k)
            fn = getattr(fusedpair, name)
        n0 = fn.launches
        out = fn(*args, **k)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1, name
        for got, ref in zip(out if isinstance(out, tuple) else (out,), refs):
            close(got.cpu(), ref.cpu(), CUDA_TOL)


# ---------------------------------------------------------------------------
# f64 instantiations (double_precision): f64 on both sides, only the order
# of the (atomic) sums differs, so each output lies within a few ulps of
# f64 times the square root of its terms; 1e-12 x max|ref| holds that with
# room at these shapes (an f32 kernel would miss it by 1e4)
# ---------------------------------------------------------------------------
CUDA_F64_TOL = 1e-12


def _f64(cuda, arrays):
    return [torch.from_numpy(a.astype(np.float64) if a.dtype.kind == "f" else a).to(cuda)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_pair_apply", "fused_pair_apply_f64",
                                  "fused_pair_apply_atomics", "fused_pair_apply_atomics_f64"])
@pytest.mark.parametrize("W,N,S", PAIR_SHAPES + [(4, 1000, 1600)])
def test_fused_pair_f64_cuda_matches_plain(cuda, name, W, N, S):
    """Each f64 instantiation launches once on its own count and agrees
    with the plain f64 version; the persistent one raises where its f64
    accumulator does not fit it (S = 1600: 115 200 bytes), and the f32
    entry points raise on f64 operands (fused_pair_route names the f64
    kernel), each without a launch."""
    args = _f64(cuda, fused_inputs(W, N, S))
    names = ("fused_pair_apply", "fused_pair_apply_f64", "fused_pair_apply_atomics",
             "fused_pair_apply_atomics_f64")
    n0 = {n: getattr(fusedpair, n).launches for n in names}
    fn = getattr(fusedpair, name)
    if not name.endswith("_f64") or not (name == "fused_pair_apply_atomics_f64" or
                                         fusedpair.persistent_fits(CI, CJ, S, 8)):
        with pytest.raises(NotImplementedError if not name.endswith("_f64") else ValueError):
            fn(*args, Ci=CI, Cj=CJ, S=S)
        assert {n: getattr(fusedpair, n).launches for n in names} == n0
        return
    rows, cols = fn(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert {n: getattr(fusedpair, n).launches - n0[n] for n in names} == {
        n: int(n == name) for n in names}
    assert rows.dtype == cols.dtype == torch.float64
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_F64_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Ci,Cj", [(3, 3), (9, 3), (16, 16)])
def test_fused_pair_atomics_f64_pairs_cuda_match_plain(cuda, Ci, Cj):
    """The f64 atomics body at ARAP's (3, 3), the embedded graph's (9, 3)
    and the largest pair, with out-of-range ids."""
    W, N, S = 4, 1600, 1600
    rng = np.random.default_rng(3)
    ids = rng.integers(0, S, (W, N)).astype(np.int32)
    ids[:, -7:] = S + 3
    arrays = (ids, rng.normal(size=(W * Ci * Cj, N)), rng.normal(size=(Cj, S)),
              rng.normal(size=(Ci, N)))
    args = _f64(cuda, arrays)
    rows, cols = fusedpair.fused_pair_apply_atomics_f64(*args, Ci=Ci, Cj=Cj, S=S)
    torch.cuda.synchronize()
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_F64_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,S", [(12, 2000, 64), (24, 333, 300), (2, 40000, 1024)])
def test_fused_pair_f64_route_cuda_matches_plain(cuda, W, N, S):
    """fused_pair_route's f64 route: wide levels (the W-loop kernel's in
    f32) and short ones take the f64 atomics body, a long narrow level the
    f64 persistent kernel; the route's wrapper launches once and agrees."""
    route = fusedpair.fused_pair_route(W, N, CI, CJ, S, dtype=torch.float64)
    assert route == ("fused_pair_apply_f64" if (W, N) == (2, 40000)
                     else "fused_pair_apply_atomics_f64")
    args = _f64(cuda, fused_inputs(W, N, S))
    fn = getattr(fusedpair, route)
    n0 = fn.launches
    rows, cols = fn(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_F64_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("double", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("tiled", [False, True], ids=["default", "tiled"])
@pytest.mark.parametrize("mode", [2, 4], ids=["linearize", "inline"])
def test_matrix_free_graph_group_cuda_matches_cpu(cuda, monkeypatch, tmp_path, mode, tiled,
                                                 double):
    """LINEARIZE (use_autoscheduler=2) and INLINE (exhaustive candidate 1)
    on small BA's graph group, 2 LM steps on the card against the CPU: the
    camera transposes (16 cameras, 5 600 values) launch the segment sum in
    a fixed order (lower.fixed_order_plan: segment_sum_fixed_order), and
    under THALLO_SEGSUM=tiled every transpose does; never the aggregation
    kernel (f64: their f64 instantiations); INLINE reaches them through
    torch.func.vjp."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    monkeypatch.setenv("THALLO_MEASUREMENTS", str(tmp_path / "m.json"))
    monkeypatch.setenv("THALLO_SEGSUM", "tiled" if tiled else "none")
    ins, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    seg = segsum.segment_sum_f64 if double else segsum.segment_sum
    agg = ohsetup.oh_setup_aggregate_f64 if double else ohsetup.oh_setup_aggregate
    costs = []
    for device in ("cuda", "cpu"):
        plan = tt.load_energy(ba.ENERGY, tt.ProblemSpec(double_precision=double)).plan(
            dims, solver="levenberg_marquardt", device=device, use_autoscheduler=mode)
        plan.set_solver_parameter("q_tolerance", -1.0)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        fixed = segsum.segment_sum_fixed_order_f64 if double else segsum.segment_sum_fixed_order
        n0 = (seg.launches + fixed.launches, agg.launches)
        for _ in range(2):
            plan.step()
        costs.append(plan.cost())
        if device == "cuda":
            torch.cuda.synchronize()
            assert plan.compiled.groups[0].schedule.value == ("linearize" if mode == 2
                                                              else "inline")
            launched = (seg.launches + fixed.launches - n0[0], agg.launches - n0[1])
            assert launched[0] > 0 and launched[1] == 0, launched
    assert abs(costs[0] - costs[1]) <= (1e-10 if double else 1e-4) * costs[1], costs


@pytest.mark.cuda
@pytest.mark.parametrize("name,ids,S", seg_maps(), ids=[m[0] for m in seg_maps()])
def test_segsum_f64_cuda_matches_plain(cuda, name, ids, S):
    """The f64 instantiation over every pairing of level kernels, on
    row-major and on transposed channel-major data (the staged kernel where
    the plan has the staged form): f64 out, one launch a call on
    segment_sum_f64's count (segment_sum sends f64 data there)."""
    C = 9 if name in ("uniform1", "skew", "cams") else 3
    data = np.random.default_rng(10).normal(size=(len(ids), C))
    plan = segsum.build_plan(ids, S, device=cuda)
    d = torch.from_numpy(data).to(cuda)
    n0, n32 = segsum.segment_sum_f64.launches, segsum.segment_sum.launches
    out = segsum.segment_sum(d, plan)
    strided = segsum.segment_sum_f64(d.T.contiguous().T, plan)
    torch.cuda.synchronize()
    assert segsum.segment_sum_f64.launches == n0 + 2
    assert segsum.segment_sum.launches == n32
    assert out.dtype == strided.dtype == torch.float64
    ref = segsum.segment_sum_reference(d, plan).cpu()
    close(out.cpu(), ref, CUDA_F64_TOL)
    close(strided.cpu(), ref, CUDA_F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_pair_apply_wloop", "fused_pair_apply_wloop_chunked",
                                  "fused_pair_rows_floor", "fused_pair_bf16_atomics"])
def test_kernels_without_f64_refuse_it_on_cuda(cuda, name):
    """A kernel with no f64 instantiation raises on f64 operands; it casts
    nothing down and runs no plain version."""
    args = _f64(cuda, fused_inputs(12, 2000, 64))
    with pytest.raises(NotImplementedError, match="f64"):
        getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=64)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.5])
@pytest.mark.parametrize("R,N", OH_SHAPES + [(20000, 1024)])
def test_oh_products_f64_cuda_matches_plain(cuda, share, R, N):
    rT, Jall, ids = _f64(cuda, oh_inputs(R, N))
    ids = torch.from_numpy(hot_ids(ids.cpu().numpy()[None], share)[0]).to(cuda)
    n0 = ohsetup.oh_setup_products_f64.launches
    out = ohsetup.oh_setup_products(rT, Jall, ids, N=N, recipe=OH_RECIPE)
    torch.cuda.synchronize()
    assert ohsetup.oh_setup_products_f64.launches == n0 + 1
    assert out.dtype == torch.float64
    ref = ohsetup.oh_setup_products_reference(rT, Jall, ids, N=N, recipe=OH_RECIPE)
    close(out.cpu(), ref.cpu(), CUDA_F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", [FR_RECIPE, FR_RECIPE2], ids=["one_cross", "two_cross"])
@pytest.mark.parametrize("N_t,W", FR_CUDA_SHAPES[:3] + [(77, 8), (100_003, 4)])
def test_fullrepeat_f64_cuda_matches_plain(cuda, recipe, N_t, W):
    """The f64 tile kernel: 16-byte copies (N_t*W even) and 8-byte ones
    (odd), W even (double2 reads) and odd."""
    recipe, (rT, Jall) = _fr_case(N_t, W, recipe)
    rT, Jall = rT.double(), Jall.double()
    n0 = fullrepeat.fullrepeat_setup_f64.launches
    agg, crosses = fullrepeat.fullrepeat_setup(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    torch.cuda.synchronize()
    assert fullrepeat.fullrepeat_setup_f64.launches == n0 + 1
    ragg, rcross = fullrepeat.fullrepeat_setup_reference(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    for got, ref in zip([agg, *crosses], [ragg, *rcross]):
        assert got.dtype == torch.float64
        close(got.cpu(), ref.cpu(), CUDA_F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", AGG_SHAPES + [(6161, 1024)])
def test_oh_aggregate_f64_cuda_matches_plain(cuda, R, N):
    parts, ids = _f64(cuda, agg_inputs(R, N))
    n0 = ohsetup.oh_setup_aggregate_f64.launches
    out = ohsetup.oh_setup_aggregate(parts, ids, N=N)
    torch.cuda.synchronize()
    assert ohsetup.oh_setup_aggregate_f64.launches == n0 + 1
    assert out.dtype == torch.float64
    close(out.cpu(), ohsetup.oh_setup_aggregate_reference(parts, ids, N=N).cpu(), CUDA_F64_TOL)


@pytest.mark.cuda
def test_double_step_makes_no_host_sync(cuda):
    """One LM step of the small BA scene under double_precision, in f64
    throughout (the f64 oh_setup_products, fullrepeat_setup and fused
    pair), reads nothing back from the card."""
    n0 = fusedpair.fused_pair_apply_f64.launches + \
        fusedpair.fused_pair_apply_atomics_f64.launches
    _step_makes_no_host_sync(cuda, double=True)
    assert fusedpair.fused_pair_apply_f64.launches + \
        fusedpair.fused_pair_apply_atomics_f64.launches > n0


def _dispatch_plan(cuda, k, solver="levenberg_marquardt", **options):
    """The small BA scene (block-sparse, block-Jacobi) under
    steps_per_dispatch=k on the card, initialised."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    plan = tt.load_energy(ba.ENERGY).plan(dims, solver=solver, device=cuda,
                                          steps_per_dispatch=k, **options)
    plan.set_solver_parameter("nIterations", 100)
    plan.init({n: np.copy(v) for n, v in ins.items()})
    return plan


@pytest.mark.cuda
def test_dispatch_takes_the_graph_path(cuda, monkeypatch):
    """steps_per_dispatch=3: run_steps(6) runs the first step eagerly and
    the other five as replays of one captured step (two dispatches), and
    ends where an eager run_steps(6) ends, within the atomics' order
    (STEP tolerance of phase 3: 1e-4 x max|U|)."""
    from thallo_tpu_torch import plan as tplan

    replays = []
    real = tplan._StepGraph.run
    monkeypatch.setattr(tplan._StepGraph, "run",
                        lambda self, U, lm, ran, steps: replays.append(steps) or
                        real(self, U, lm, ran, steps))
    graphed, eager = _dispatch_plan(cuda, 3), _dispatch_plan(cuda, 1)
    graphed.warmup()
    assert graphed._graph is not None
    assert graphed.run_steps(6) == eager.run_steps(6) == 6
    assert replays == [5]
    assert graphed._lm.n_iter == eager._lm.n_iter == 6
    for n, u in eager.unknowns().items():
        assert float((graphed.unknowns()[n] - u).abs().max()) <= 1e-4 * float(u.abs().max())


@pytest.mark.cuda
def test_replay_makes_no_host_read(cuda):
    """A dispatch's replays under torch.cuda.set_sync_debug_mode("error"):
    copying the state in, k replays and copying it out read nothing back."""
    plan = _dispatch_plan(cuda, 4)
    plan.run_steps(4)  # captures
    graph = plan._step_graph()
    ran = torch.zeros((), dtype=torch.int64, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        U, lm = graph.run(plan._U, plan._lm, ran, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(ran) == 4 and all(bool(torch.isfinite(u).all()) for u in U.values())


@pytest.mark.cuda
def test_set_solver_parameter_drops_the_graph(cuda):
    """lIterations changed between two run_steps calls of a GN plan: the
    second call captures anew (the first graph baked 10 PCG iterations in)
    and matches an eager run of the same calls."""
    runs = []
    for k in (2, 1):
        plan = _dispatch_plan(cuda, k, solver="gauss_newton")
        plan.set_solver_parameter("lIterations", 10)
        plan.run_steps(4)
        first = plan._graph
        plan.set_solver_parameter("lIterations", 3)
        assert plan._graph is None
        plan.run_steps(4)
        if k == 2:
            assert first is not None and plan._graph is not None and plan._graph is not first
        runs.append({n: u.cpu() for n, u in plan.unknowns().items()})
    for n, u in runs[1].items():
        assert float((runs[0][n] - u).abs().max()) <= 1e-4 * float(u.abs().max())


@pytest.mark.cuda
def test_in_order_scatter_is_deterministic(cuda):
    """The tiny scatters' in-order segment sum (deconvolution 16²'s
    stored-Jacobian scatter, 6 400 values into 256: the thread kernel on
    an in-order plan, and the fixed-order kernel on the plan
    lower.fixed_order_plan builds) gives index_add_'s CPU sums bit for
    bit, and two card runs of the model's first step give the same
    unknowns bit for bit."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch import lower
    from thallo_tpu_torch.models.cases import case_energy, model_case

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, size=6400).astype(np.int32)
    vals = torch.from_numpy(rng.normal(size=(2, 6400)).astype(np.float32))
    plan = segsum.build_plan(ids, 256, device=cuda, in_order=True)
    got = segsum.segment_sum(vals.to(cuda).T, plan).T.cpu()
    want = torch.zeros((2, 256)).index_add_(1, torch.from_numpy(ids).long(), vals)
    assert torch.equal(got, want)
    fixed = lower.fixed_order_plan(ids, 256, cuda)
    assert torch.equal(segsum.segment_sum(vals.to(cuda).T, fixed).T.cpu(), want)
    m, inputs, dims, solver, l_iterations = model_case("deconvolution")
    Us = []
    for _ in range(2):
        p = tt.load_energy(case_energy("deconvolution", m)).plan(dims, solver=solver,
                                                                 device=cuda)
        p.set_solver_parameter("lIterations", l_iterations)
        p.set_solver_parameter("q_tolerance", -1.0)
        p.init({n: np.copy(v) for n, v in inputs.items()})
        n0 = segsum.segment_sum_fixed_order.launches
        p.step()
        assert segsum.segment_sum_fixed_order.launches > n0
        Us.append(p.unknowns()["X"].cpu())
    assert torch.equal(Us[0], Us[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K,dtype", [(144, torch.float32), (144, torch.float64),
                                     (512, torch.float32)])
def test_capturable_eigh_matches_torch_and_captures(cuda, K, dtype):
    """ops/linalg.eigh (cuSOLVER's batched eigensolver, info on the
    device) against torch.linalg.eigvalsh in f64 on a seeded S = M Mᵀ, then
    captured in a CUDA graph and replayed: the eigenvalues within 1e-5 (f32)
    or 1e-12 (f64) of max λ, S V = V Λ within ten times that, and the replay's
    eigenvalues within the same bound of the eager call's."""
    from thallo_tpu_torch.ops import linalg

    g = torch.Generator(device=cuda).manual_seed(0)
    M = torch.randn(K, K, device=cuda, dtype=dtype, generator=g)
    S = M @ M.T
    lam, V = linalg.eigh(S)
    ref = torch.linalg.eigvalsh(S.double()).to(dtype)
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * float(ref.abs().max())
    assert float((lam - ref).abs().max()) <= tol
    assert float((S @ V - V * lam).abs().max()) <= 10 * tol
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        linalg.eigh(S)
    torch.cuda.current_stream().wait_stream(side)
    graph, out = torch.cuda.CUDAGraph(), {}
    with torch.cuda.graph(graph):
        out["lam"] = linalg.eigh(S)[0]
    graph.replay()
    torch.cuda.synchronize()
    assert float((out["lam"] - lam).abs().max()) <= tol


# the atomics route's shapes (W, N, Ci, Cj, S, ids): ARAP's 3 x 3 col
# levels (grouped: element n's slots are its grid neighbours; shuffled:
# the same ids permuted), a BA pair whose accumulator is beyond the
# persistent kernel, bundle_fusion's [8, 700], embedded deformation's
# 9 x 3, and the largest pair, 16 x 16
def _grid_ids(side, shuffled):
    n = np.arange(side * side)
    x, y = n % side, n // side
    ids = np.stack([np.where(x + 1 < side, n + 1, -1), np.where(x > 0, n - 1, -1),
                    np.where(y + 1 < side, n + side, -1), np.where(y > 0, n - side, -1)])
    if shuffled:
        ids = ids[:, np.random.default_rng(5).permutation(side * side)]
    return np.ascontiguousarray(ids, dtype=np.int32)


ATOMICS_ROUTE_SHAPES = [("arap_grouped", 3, 3, 64 * 64), ("arap_shuffled", 3, 3, 64 * 64),
                        ((4, 20_000), 3, 9, 4000), ((8, 700), 6, 6, 700),
                        ((4, 1600), 9, 3, 400), ((3, 5000), 16, 16, 3000)]


@pytest.mark.cuda
@pytest.mark.parametrize("double", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("shape,Ci,Cj,S", ATOMICS_ROUTE_SHAPES,
                         ids=["arap_grouped", "arap_shuffled", "ba_big_s", "bundle_fusion",
                              "embedded", "16x16"])
def test_fused_pair_atomics_bodies_cuda_match_plain(cuda, double, shape, Ci, Cj, S):
    """The slots kernel and the first atomics body, f32 and f64, at every
    shape of the atomics route, against the plain version; each wrapper
    counts its own launch, and fused_pair_route names one of them."""
    rng = np.random.default_rng(11)
    if isinstance(shape, str):
        ids = _grid_ids(64, shape.endswith("shuffled"))
    else:
        ids = rng.integers(0, S, shape).astype(np.int32)
    W, N = ids.shape
    dt = torch.float64 if double else torch.float32
    args = [torch.from_numpy(ids).to(cuda)] + [
        torch.from_numpy(rng.normal(size=s)).to(cuda, dt) for s in ((W * Ci * Cj, N), (Cj, S),
                                                                    (Ci, N))]
    ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    sfx = "_f64" if double else ""
    names = ["fused_pair_apply_atomics" + sfx, "fused_pair_apply_atomics_thread" + sfx]
    assert fusedpair.fused_pair_route(W, N, Ci, Cj, S, dtype=dt) in names
    tol = CUDA_F64_TOL if double else CUDA_TOL
    for name in names:
        fn = getattr(fusedpair, name)
        n0 = fn.launches
        rows, cols = fn(*args, Ci=Ci, Cj=Cj, S=S)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1 and rows.dtype == cols.dtype == dt
        close(rows.cpu(), ref[0].cpu(), tol)
        close(cols.cpu(), ref[1].cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [segsum.STAGED_BLOCKS, 6])
@pytest.mark.parametrize("double", [False, True], ids=["f32", "f64"])
def test_segsum_ring_cuda_bit_identical(cuda, monkeypatch, blocks, double):
    """The ring kernel (segment_sum's staged route) and the first staged
    body on channel-major data: each within CUDA_TOL (CUDA_F64_TOL) of the
    plain version, the ring kernel the same bits on two launches, and its
    own plain twin's [G, S, C] order."""
    monkeypatch.setattr(segsum, "STAGED_BLOCKS", blocks)
    rng = np.random.default_rng(12)
    S, M = 256, 60_000
    ids = rng.integers(0, S, M).astype(np.int32)
    dt = torch.float64 if double else torch.float32
    data = torch.from_numpy(rng.normal(size=(9, M))).to(cuda, dt).T
    plan = segsum.build_plan(ids, S, device=cuda)
    assert plan.local is not None and plan.n_blocks == min(plan.n_chunks, blocks)
    tol = CUDA_F64_TOL if double else CUDA_TOL
    ref = segsum.segment_sum_reference(data, plan)
    n0 = dict(segsum.BODY_LAUNCHES)
    ring = segsum.segment_sum(data, plan)
    again = segsum.segment_sum(data, plan)
    first = segsum.segment_sum_per_chunk(data, plan)
    torch.cuda.synchronize()
    assert segsum.BODY_LAUNCHES["ring"] == n0.get("ring", 0) + 2
    assert segsum.BODY_LAUNCHES["per_chunk"] == n0.get("per_chunk", 0) + 1
    assert torch.equal(ring, again)
    for got in (ring, first):
        close(got.cpu(), ref.cpu(), tol)
    close(ring.cpu(), segsum.segment_sum_staged_reference(data, plan).cpu(), tol)


# ---------------------------------------------------------------------------
# the fixed-order segment sum (csrc/segsum.cu run_sum_staged_order_kernel):
# the plans lower.fixed_order_plan builds for the small-image scatters
# (deconvolution's [1-2, 6 400] -> 256, face_fitting's [1-2, 192] -> 4,
# bundle_fusion's [6, 300] and [6, 24] -> 4, the tests' BA cameras [9, 5 600]
# -> 16: sorted runs), a ragged map (ids past S dropped, empty segments),
# runs longer than a tile (in order and as a tree), one long run
# ---------------------------------------------------------------------------
FIXED_ORDER_SHAPES = [(1, 6400, 256), (2, 6400, 256), (1, 192, 4), (2, 192, 4), (6, 300, 4),
                      (6, 24, 4), (9, 5600, 16)]


def _fixed_order_case(F, M, N, seed, ragged=False):
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(N), -(-M // N))[:M].astype(np.int32)
    rng.shuffle(ids)
    if ragged:
        ids[rng.random(M) < 0.1] = N + 5  # dropped: past the segments
        ids[ids == 1] = 2  # an empty segment
    return ids, rng.normal(size=(F, M)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("double", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("F,M,N,ragged", [s + (False,) for s in FIXED_ORDER_SHAPES]
                         + [(3, 1001, 37, True), (2, 5000, 3, False), (4, 20000, 1, False)])
def test_segment_sum_fixed_order_cuda_matches_plain(cuda, double, F, M, N, ragged):
    """lower.fixed_order_plan's plan summed by segment_sum_fixed_order[_f64]
    (through segment_sum, one launch a call, the runs kernel not launched)
    on channel-major values: an in-order plan gives the CPU's index_add_
    bits, a sorted-runs plan lies within CUDA_TOL (CUDA_F64_TOL) of it;
    two launches give the same bits; the first body (segment_sum on the
    plan build_plan makes without the fixed-order form) within the same
    bound."""
    from thallo_tpu_torch import lower

    ids, vals = _fixed_order_case(F, M, N, F * M + N, ragged)
    dt = torch.float64 if double else torch.float32
    cpu_vals = torch.from_numpy(vals).to(dt)
    keep = ids < N
    want = torch.zeros((F, N), dtype=dt).index_add_(1, torch.from_numpy(ids[keep]).long(),
                                                    cpu_vals[:, keep])
    plan = lower.fixed_order_plan(ids, N, cuda)
    assert plan.block_run is not None and len(plan.modes) == 1
    in_order = plan.modes == (segsum.THREAD,)
    assert in_order == (np.bincount(ids[keep], minlength=N).max() <= lower.IN_ORDER_MAX_RUN)
    d = cpu_vals.to(cuda).T
    fixed = segsum.segment_sum_fixed_order_f64 if double else segsum.segment_sum_fixed_order
    n0 = (fixed.launches, dict(segsum.BODY_LAUNCHES))
    got = segsum.segment_sum(d, plan)
    again = segsum.segment_sum(d, plan)
    torch.cuda.synchronize()
    assert fixed.launches == n0[0] + 2
    assert segsum.BODY_LAUNCHES["runs"] == n0[1].get("runs", 0)
    assert got.dtype == dt and torch.equal(got, again)
    if in_order:
        assert torch.equal(got.T.cpu(), want)
    tol = CUDA_F64_TOL if double else CUDA_TOL
    close(got.T.cpu(), want, tol)
    first = segsum.build_plan(ids, N, device=cuda, in_order=plan.modes == (segsum.THREAD,))
    close(segsum.segment_sum(d, first).T.cpu(), want, tol)


@pytest.mark.cuda
def test_segment_sum_fixed_order_tree_and_long_runs_cuda(cuda, monkeypatch):
    """The tree form at one run a block (all warps on it) and at several,
    and an in-order plan whose runs span several tiles (ORDER_TILE): each
    against the CPU's index_add_, the in-order one bit for bit; a plan
    without the fixed-order form raises."""
    rng = np.random.default_rng(3)
    for N, M, in_order in ((1, 70_000, False), (40, 3000, False), (2, 2600, True)):
        ids = rng.integers(0, N, M).astype(np.int32)
        vals = torch.from_numpy(rng.normal(size=(3, M)).astype(np.float32))
        plan = segsum.build_plan(ids, N, device=cuda, in_order=in_order, fixed_order=True)
        got = segsum.segment_sum_fixed_order(vals.to(cuda).T, plan).T.cpu()
        want = torch.zeros((3, N)).index_add_(1, torch.from_numpy(ids).long(), vals)
        if in_order:
            assert plan.order_tile == segsum.ORDER_TILE
            assert torch.equal(got, want)
        close(got, want, CUDA_TOL)
    with pytest.raises(ValueError, match="fixed-order form"):
        segsum.segment_sum_fixed_order(vals.to(cuda).T, segsum.build_plan(ids, N, device=cuda))


# ---------------------------------------------------------------------------
# the slots kernel on bf16 blocks (fused_pair_apply_atomics_bf16): ARAP
# 256²'s (3, 3) level shape, BF16_WIDE's (W = 12, N = S = 16 384 at (9, 3)
# and (16, 3)), embedded deformation's (9, 3) [4, 1 600], a ragged level
# with out-of-range ids, at every slot-lane count
# ---------------------------------------------------------------------------
BF16_SLOTS_SHAPES = [(3, 3, 4, 65536, 65536), (9, 3, 12, 16384, 16384), (16, 3, 12, 16384, 16384),
                     (9, 3, 4, 1600, 1600), (2, 5, 7, 1001, 300)]


def _bf16_level(cuda, Ci, Cj, W, N, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, S + 3, (W, N)).astype(np.int32)
    return _bf16_args(cuda, ids, rng.normal(size=(W * Ci * Cj, N)).astype(np.float32),
                      rng.normal(size=(Cj, S)).astype(np.float32),
                      rng.normal(size=(Ci, N)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("Ci,Cj,W,N,S", BF16_SLOTS_SHAPES)
def test_fused_pair_apply_atomics_bf16_cuda_matches_plain(cuda, Ci, Cj, W, N, S):
    """The bf16 slots kernel against the plain version on the same bf16
    values (f32 on both sides, only the order of sums differs), one launch
    on its own count at the slot lanes bf16_slot_lanes picks and at P = 1,
    2, 4, 8 (fusedpair._launch_atomics); fused_pair_route(bf16=True) names
    it at these shapes, and the first bf16 body agrees."""
    args = _bf16_level(cuda, Ci, Cj, W, N, S, Ci * W + N)
    assert fusedpair.fused_pair_route(W, N, Ci, Cj, S, bf16=True) == \
        "fused_pair_apply_atomics_bf16"
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=Ci, Cj=Cj, S=S)
    fn = fusedpair.fused_pair_apply_atomics_bf16
    n0 = fn.launches
    outs = [fn(*args, Ci=Ci, Cj=Cj, S=S)]
    outs += [fusedpair._launch_atomics(fn, *args, Ci, Cj, S, torch.bfloat16, True, P=P)
             for P in (1, 2, 4, 8)]
    outs.append(fusedpair.fused_pair_bf16_atomics(*args, Ci=Ci, Cj=Cj, S=S))
    torch.cuda.synchronize()
    assert fn.launches == n0 + 5
    for rows, cols in outs:
        close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
        close(cols.cpu(), c_ref.cpu(), CUDA_TOL)
