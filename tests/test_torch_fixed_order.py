"""The fixed-order form of the small-image scatters' segment-sum plans
(ops/segsum.py ``build_plan(..., fixed_order=True)``, built by
``lower.fixed_order_plan``): how the runs are cut into the fixed-order
kernel's blocks, and the wrappers' plain versions on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thallo_tpu_torch import lower  # noqa: E402
from thallo_tpu_torch.ops import segsum  # noqa: E402

# (F, M, N): deconvolution's [1-2, 6 400] -> 256, face_fitting's [1-2, 192]
# -> 4, bundle_fusion's [6, 300] and [6, 24] -> 4, the tests' BA cameras
# [9, 5 600] -> 16; a map with dropped ids and empty segments; long runs
SHAPES = [(1, 6400, 256), (2, 192, 4), (6, 300, 4), (6, 24, 4), (9, 5600, 16), (3, 1001, 37),
          (2, 5000, 3), (1, 20000, 1)]


def _ids(M, N, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, M).astype(np.int32)
    if N > 2:
        ids[rng.random(M) < 0.1] = N + 5  # past the segments: dropped
        ids[ids == 1] = 0  # segment 1 empty
    return ids


@pytest.mark.parametrize("F,M,N", SHAPES)
def test_fixed_order_blocks_cover_the_runs(F, M, N):
    """Each block is a contiguous range of whole runs starting where the
    last ended, at most ORDER_LANES lanes unless it is one longer run, at
    most ORDER_THREADS runs in order (ORDER_THREADS / 32 as a tree);
    block_lane follows seg_start; order_tile is the widest block, at most
    ORDER_TILE; the plan is one level with no staged form."""
    ids = _ids(M, N, M + N)
    plan = lower.fixed_order_plan(ids, N, "cpu")
    br, bl = plan.block_run.numpy(), plan.block_lane.numpy()
    start = plan.seg_start.numpy()
    counts = np.diff(start)
    in_order = plan.modes == (segsum.THREAD,)
    assert in_order == (counts.max() <= lower.IN_ORDER_MAX_RUN)
    assert plan.piece_start is None and plan.local is None and len(plan.modes) == 1
    assert br[0] == 0 and br[-1] == N and (np.diff(br) >= 1).all()
    np.testing.assert_array_equal(bl, start[br])
    cap = segsum.ORDER_THREADS if in_order else segsum.ORDER_THREADS // 32
    for b in range(len(br) - 1):
        lanes, runs = bl[b + 1] - bl[b], br[b + 1] - br[b]
        assert runs <= cap
        assert lanes <= segsum.ORDER_LANES or runs == 1
        if b + 1 < len(br) - 1:  # the next run would not have fitted
            assert runs == cap or lanes + counts[br[b + 1]] > segsum.ORDER_LANES
    assert plan.order_tile == max(1, min(segsum.ORDER_TILE, int(np.diff(bl).max())))


@pytest.mark.parametrize("F,M,N", SHAPES)
def test_fixed_order_wrappers_plain_match_index_add(F, M, N):
    """On the CPU segment_sum[_f64] (which send a fixed-order plan to
    segment_sum_fixed_order[_f64] on the card), those two and the first
    body (segment_sum on the plan built without the form) give index_add_'s
    sums bit for bit, on
    channel-major values (scatter_route's), in f32 and f64; no launch is
    counted."""
    ids = _ids(M, N, 2 * M + N)
    keep = ids < N
    plan = lower.fixed_order_plan(ids, N, "cpu")
    counted = (segsum.segment_sum, segsum.segment_sum_f64, segsum.segment_sum_fixed_order,
               segsum.segment_sum_fixed_order_f64)
    first = segsum.build_plan(ids, N, device="cpu", in_order=True)
    n0 = [fn.launches for fn in counted]
    for dt in (torch.float32, torch.float64):
        vals = torch.from_numpy(np.random.default_rng(N).normal(size=(F, M))).to(dt)
        want = torch.zeros((F, N), dtype=dt).index_add_(
            1, torch.from_numpy(ids[keep]).long(), vals[:, keep])
        for fn in (segsum.segment_sum, segsum.segment_sum_f64, segsum.segment_sum_fixed_order,
                   segsum.segment_sum_fixed_order_f64):
            assert torch.equal(fn(vals.T, plan).T, want), fn.__name__
        assert torch.equal(segsum.segment_sum(vals.T, first).T, want)
    assert [fn.launches for fn in counted] == n0


def test_fixed_order_plan_form_validated():
    """The fixed-order form is one level: a two-level plan or a tile out of
    range is refused."""
    plan = lower.fixed_order_plan(_ids(600, 4, 1), 4, "cpu")
    plan.validate()
    plan.order_tile = segsum.ORDER_TILE + 1
    with pytest.raises(ValueError, match="fixed-order form"):
        plan.validate()
