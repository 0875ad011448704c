"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here needs an NVIDIA GPU: they carry the `cuda` marker
and skip without one.  No JAX: the card's machine runs the port alone
(`python -m pytest tests/test_torch_cuda.py -m cuda`)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from thallo_tpu_torch.ops import fullrepeat, fusedpair, loopfloor, ohsetup, segsum  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    AGG_SHAPES, CI, CJ, FR_RECIPE, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES,
    SEG_SHAPES, WLOOP_SHAPES, agg_inputs, bf16_round, close, fr_inputs, fused_inputs,
    oh_inputs, seg_inputs, seg_maps)

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
@pytest.mark.parametrize("name", ["fused_pair_apply_atomics", "fused_pair_rows_floor"])
@pytest.mark.parametrize("W,N,S", PAIR_SHAPES)
def test_fused_pair_other_kernels_cuda_match_plain(cuda, name, W, N, S):
    """The kept global-atomics body at every shape, and the persistent
    kernel without its cols side wherever fused_pair_route sends it."""
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    fn = getattr(fusedpair, name)
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    if name == "fused_pair_rows_floor" and fusedpair.fused_pair_route(CI, CJ, S) == "atomics":
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
    """fused_pair_apply launches the kernel fused_pair_route names (its own
    count, or the atomics wrapper's) and agrees with the plain version."""
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    counted = (fusedpair.fused_pair_apply if fusedpair.fused_pair_route(CI, CJ, S)
               == "persistent" else fusedpair.fused_pair_apply_atomics)
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
    rng = np.random.default_rng(11)
    ids = np.where(rng.random(ids.shape) < share, 5, ids).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (ids, blocks, pcol, prow)]
    rows, cols = getattr(fusedpair, name)(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    mags = fusedpair.fused_pair_apply_reference(args[0], *(a.abs() for a in args[1:]),
                                                Ci=CI, Cj=CJ, S=S)[1]
    n = fusedpair.fused_pair_apply_reference(args[0], *(torch.ones_like(a) for a in args[1:]),
                                             Ci=CI, Cj=CJ, S=S)[1]
    bound = 4 * 2.0 ** -24 * n.sqrt() * mags
    assert bool(((cols - c_ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", OH_SHAPES)
def test_oh_products_cuda_matches_plain(cuda, R, N):
    args = [torch.from_numpy(a).to(cuda) for a in oh_inputs(R, N)]
    out = ohsetup.oh_setup_products(*args, N=N, recipe=OH_RECIPE)
    torch.cuda.synchronize()
    ref = ohsetup.oh_setup_products_reference(*args, N=N, recipe=OH_RECIPE)
    close(out.cpu(), ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N_t,W", FR_SHAPES)
def test_fullrepeat_cuda_matches_plain(cuda, N_t, W):
    rT, Jall = [torch.from_numpy(a).to(cuda) for a in fr_inputs(N_t, W)]
    agg, crosses = fullrepeat.fullrepeat_setup(rT, Jall, W=W, N_t=N_t, recipe=FR_RECIPE)
    torch.cuda.synchronize()
    ragg, rcross = fullrepeat.fullrepeat_setup_reference(rT, Jall, W=W, N_t=N_t,
                                                         recipe=FR_RECIPE)
    close(agg.cpu(), ragg.cpu(), CUDA_TOL)
    close(crosses[0].cpu(), rcross[0].cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", AGG_SHAPES)
def test_oh_aggregate_cuda_matches_plain(cuda, R, N):
    parts, ids = [torch.from_numpy(a).to(cuda) for a in agg_inputs(R, N)]
    n0 = ohsetup.oh_setup_aggregate.launches
    out = ohsetup.oh_setup_aggregate(parts, ids, N=N)
    torch.cuda.synchronize()
    assert ohsetup.oh_setup_aggregate.launches == n0 + 1
    close(out.cpu(), ohsetup.oh_setup_aggregate_reference(parts, ids, N=N).cpu(), CUDA_TOL)


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
    """The W-loop kernel at wide levels, at narrow ones, and where its
    [Cj, S] accumulator runs as several channel chunks (S = 5000)."""
    args = [torch.from_numpy(a).to(cuda) for a in fused_inputs(W, N, S)]
    n0 = fusedpair.fused_pair_apply_wloop.launches
    rows, cols = fusedpair.fused_pair_apply_wloop(*args, Ci=CI, Cj=CJ, S=S)
    torch.cuda.synchronize()
    assert fusedpair.fused_pair_apply_wloop.launches == n0 + 1
    r_ref, c_ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    close(rows.cpu(), r_ref.cpu(), CUDA_TOL)
    close(cols.cpu(), c_ref.cpu(), CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_pair_bf16", "fused_pair_v1_rows",
                                  "fused_pair_v2_smem", "fused_pair_v3_partials"])
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
def test_skewed_setup_and_apply_cuda_matches_cpu(cuda):
    """The level tables on the card: skewed_inputs(16, 1400, 5600) (point
    levels W = 8, 24, 273; the residual sort) gives the same -JᵀF, diag
    and JᵀJ·p on the card as on the CPU, through both fused-pair
    kernels."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.skewed_inputs(16, 1400, 5600)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    rng = np.random.default_rng(3)
    out = {}
    n0 = (fusedpair.fused_pair_apply.launches, fusedpair.fused_pair_apply_wloop.launches)
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
    assert fusedpair.fused_pair_apply.launches == n0[0] + 1
    assert fusedpair.fused_pair_apply_wloop.launches == n0[1] + 2
    for got, ref in zip(out["cuda"], out["cpu"]):
        for k in ref:
            close(got[k], ref[k], 1e-4)
