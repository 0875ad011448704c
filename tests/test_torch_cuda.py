"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here needs an NVIDIA GPU: they carry the `cuda` marker
and skip without one.  No JAX: the card's machine runs the port alone
(`python -m pytest tests/test_torch_cuda.py -m cuda`)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup, segsum  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    AGG_SHAPES, CI, CJ, FR_RECIPE, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES,
    SEG_SHAPES, agg_inputs, close, fr_inputs, fused_inputs, oh_inputs, seg_inputs)

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
