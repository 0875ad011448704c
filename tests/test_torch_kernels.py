"""The port's kernel modules on the CPU: each plain torch version against
a float64 numpy oracle of its definition and against the JAX Pallas
kernel it replaces (run in interpret mode, as tests/test_{fusedpair,
ohsetup,fullrepeat,units}.py run it).  The CUDA kernels are held against
the plain versions in test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thallo_tpu.ops import segsum as jax_segsum  # noqa: E402
from thallo_tpu.ops.fullrepeat import fullrepeat_setup as jax_fullrepeat  # noqa: E402
from thallo_tpu.ops.fusedpair import fused_pair_apply as jax_fused_pair  # noqa: E402
from thallo_tpu.ops.ohsetup import oh_setup_aggregate as jax_oh_aggregate  # noqa: E402
from thallo_tpu.ops.ohsetup import oh_setup_products as jax_oh_products  # noqa: E402
from thallo_tpu_torch.ops import fullrepeat, fusedpair, loopfloor, ohsetup, segsum  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    AGG_SHAPES, CI, CJ, FR_RECIPE, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES,
    ORACLE_TOL, SEG_SHAPES, WLOOP_SHAPES, agg_inputs, agg_oracle, bf16_round, close,
    fr_inputs, fr_oracle, fused_inputs, fused_oracle, oh_inputs, oh_oracle, seg_inputs,
    seg_maps, seg_oracle)


def _load_script(name):
    """A measurement script of the JAX package, imported by path (its
    main() runs only as __main__)."""
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

# JAX's products/full-repeat/aggregate kernels split f32 into three bf16
# terms exactly, and its segment sum contracts f32 against a one-hot,
# exact on the CPU: only the summation order differs from the plain version
JAX_EXACT_TOL = 1e-5
# JAX's fused pair rounds pcol and z to bf16 (2^-8 relative per term)
JAX_BF16_TOL = 1e-2


# ---------------------------------------------------------------------------
# plain versions vs the float64 oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_plain_matches_oracle(W, N, S):
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    rows, cols = fusedpair.fused_pair_apply_reference(
        torch.from_numpy(ids), torch.from_numpy(blocks), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    close(rows, r_ref, ORACLE_TOL)
    close(cols, c_ref, ORACLE_TOL)


@pytest.mark.parametrize("R,N", OH_SHAPES)
def test_oh_products_plain_matches_oracle(R, N):
    rT, Jall, ids = oh_inputs(R, N)
    out = ohsetup.oh_setup_products_reference(
        torch.from_numpy(rT), torch.from_numpy(Jall), torch.from_numpy(ids),
        N=N, recipe=OH_RECIPE)
    close(out, oh_oracle(rT, Jall, ids, N, OH_RECIPE), ORACLE_TOL)


@pytest.mark.parametrize("N_t,W", FR_SHAPES)
def test_fullrepeat_plain_matches_oracle(N_t, W):
    rT, Jall = fr_inputs(N_t, W)
    agg, crosses = fullrepeat.fullrepeat_setup_reference(
        torch.from_numpy(rT), torch.from_numpy(Jall), W=W, N_t=N_t, recipe=FR_RECIPE)
    agg_ref, cross_ref = fr_oracle(rT, Jall, N_t, W)
    close(agg, agg_ref, ORACLE_TOL)
    assert len(crosses) == 1
    close(crosses[0], cross_ref, ORACLE_TOL)


# ---------------------------------------------------------------------------
# plain versions vs the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_plain_matches_jax(W, N, S):
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    rows, cols = fusedpair.fused_pair_apply(
        torch.from_numpy(ids), torch.from_numpy(blocks), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    jr, jc = jax_fused_pair(jnp.asarray(ids), jnp.asarray(blocks), jnp.asarray(pcol),
                            jnp.asarray(prow), Ci=CI, Cj=CJ, S=S, interpret=True)
    close(rows, jr, JAX_BF16_TOL)
    close(cols, jc, JAX_BF16_TOL)


@pytest.mark.parametrize("R,N", OH_SHAPES)
def test_oh_products_plain_matches_jax(R, N):
    rT, Jall, ids = oh_inputs(R, N)
    out = ohsetup.oh_setup_products(
        torch.from_numpy(rT), torch.from_numpy(Jall), torch.from_numpy(ids),
        N=N, recipe=OH_RECIPE)
    ref = jax_oh_products(jnp.asarray(rT), jnp.asarray(Jall), jnp.asarray(ids), N=N,
                          recipe=OH_RECIPE, interpret=True)
    close(out, ref, JAX_EXACT_TOL)


@pytest.mark.parametrize("N_t,W", FR_SHAPES)
def test_fullrepeat_plain_matches_jax(N_t, W):
    rT, Jall = fr_inputs(N_t, W)
    agg, crosses = fullrepeat.fullrepeat_setup(
        torch.from_numpy(rT), torch.from_numpy(Jall), W=W, N_t=N_t, recipe=FR_RECIPE)
    jagg, jcross = jax_fullrepeat(jnp.asarray(rT), jnp.asarray(Jall), W=W, N_t=N_t,
                                  recipe=FR_RECIPE, interpret=True)
    close(agg, jagg, JAX_EXACT_TOL)
    close(crosses[0], jcross[0], JAX_EXACT_TOL)


# ---------------------------------------------------------------------------
# wide levels: the W-loop body (JAX runs _kernel_wloop where W > 8)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W,N,S", WLOOP_SHAPES)
def test_fused_pair_wloop_plain_matches_oracle(W, N, S):
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    rows, cols = fusedpair.fused_pair_apply_wloop(
        torch.from_numpy(ids), torch.from_numpy(blocks), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    close(rows, r_ref, ORACLE_TOL)
    close(cols, c_ref, ORACLE_TOL)


@pytest.mark.parametrize("W,N,S", WLOOP_SHAPES[:2])
def test_fused_pair_wloop_plain_matches_jax(W, N, S):
    test_fused_pair_plain_matches_jax(W, N, S)


# ---------------------------------------------------------------------------
# the measurement scripts' kernels: bf16 block storage, and the launch floor
# ---------------------------------------------------------------------------
BF16_KERNELS = ["fused_pair_bf16", "fused_pair_v1_rows", "fused_pair_v2_smem",
                "fused_pair_v3_partials"]


def _bf16_inputs(W, N, S):
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    return ids, bf16_round(blocks), pcol, prow


@pytest.mark.parametrize("name", BF16_KERNELS)
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_bf16_plain_matches_oracle(name, W, N, S):
    """bf16 blocks (values exactly representable), f32 arithmetic: the
    oracle on the same rounded values differs only by f32 rounding."""
    ids, blocks, pcol, prow = _bf16_inputs(W, N, S)
    out = getattr(fusedpair, name)(
        torch.from_numpy(ids), torch.from_numpy(blocks).bfloat16(), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    if name == "fused_pair_v1_rows":
        close(out, r_ref, ORACLE_TOL)
        return
    close(out[0], r_ref, ORACLE_TOL)
    close(out[1], c_ref, ORACLE_TOL)


@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_bf16_plain_matches_jax_micro(W, N, S):
    """Against the micro script's XLA formulation, which rounds pcol and
    z to bf16 as well (2^-8 relative per term): JAX_BF16_TOL."""
    micro = _load_script("tpu_fused_pair_micro")
    ids, blocks, pcol, prow = _bf16_inputs(W, N, S)
    rows, cols = fusedpair.fused_pair_bf16(
        torch.from_numpy(ids), torch.from_numpy(blocks).bfloat16(), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    jr, jc = micro.xla_reference(jnp.asarray(ids), jnp.asarray(blocks, jnp.bfloat16),
                                 jnp.asarray(pcol), jnp.asarray(prow), Ci=CI, Cj=CJ, W=W, S=S)
    close(rows, jr, JAX_BF16_TOL)
    close(cols, jc, JAX_BF16_TOL)


@pytest.mark.parametrize("L", [1024, 65536])
def test_loop_floor_plain(L):
    x = np.random.default_rng(6).normal(size=(loopfloor.ROWS, L)).astype(np.float32)
    out = loopfloor.add_one(torch.from_numpy(x), tiles=L // 1024)
    np.testing.assert_array_equal(out.numpy(), x + np.float32(1))


# ---------------------------------------------------------------------------
# the materialized-J scatters: aggregation and the tiled segment sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,N", AGG_SHAPES)
def test_oh_aggregate_plain_matches_oracle(R, N):
    parts, ids = agg_inputs(R, N)
    out = ohsetup.oh_setup_aggregate(torch.from_numpy(parts), torch.from_numpy(ids), N=N)
    close(out, agg_oracle(parts, ids, N), ORACLE_TOL)


@pytest.mark.parametrize("R,N", AGG_SHAPES)
def test_oh_aggregate_plain_matches_jax(R, N):
    parts, ids = agg_inputs(R, N)
    out = ohsetup.oh_setup_aggregate(torch.from_numpy(parts), torch.from_numpy(ids), N=N)
    ref = jax_oh_aggregate(jnp.asarray(parts), jnp.asarray(ids), N=N, interpret=True)
    close(out, ref, JAX_EXACT_TOL)


def _plans(ids, S):
    return segsum.build_plan(ids, S), jax_segsum.build_plan(ids, S)


@pytest.mark.parametrize("M,S,C", SEG_SHAPES)
def test_segsum_plan_matches_jax(M, S, C):
    _, ids = seg_inputs(M, S, C)
    mine, ref = _plans(ids, S)
    assert (mine.tile_n, mine.num_segments) == (ref.tile_n, ref.num_segments)
    for name in ("gather_idx", "rel", "mask"):
        a, b = getattr(mine, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("M,S,C", SEG_SHAPES)
def test_segsum_plain_matches_jax(M, S, C):
    data, ids = seg_inputs(M, S, C)
    mine, ref = _plans(ids, S)
    out = segsum.segment_sum(torch.from_numpy(data), mine)
    close(out, seg_oracle(data, ids, S), ORACLE_TOL)
    close(out, jax_segsum.pallas_segment_sum(jnp.asarray(data), ref, interpret=True),
          JAX_EXACT_TOL)
    close(out, jax_segsum.tiled_segment_sum(jnp.asarray(data), ref), JAX_EXACT_TOL)


def test_segsum_strided_data_and_nan_rows():
    """A transposed channel-major buffer is read through its strides, and
    a NaN reaches only its own segment: padded lanes add exactly 0."""
    data, ids = seg_inputs(*SEG_SHAPES[0])
    S = SEG_SHAPES[0][1]
    plan = segsum.build_plan(ids, S)
    cm = torch.from_numpy(np.ascontiguousarray(data.T))
    close(segsum.segment_sum(cm.T, plan), seg_oracle(data, ids, S), ORACLE_TOL)
    data[7] = np.nan
    out = segsum.segment_sum(torch.from_numpy(data), plan).numpy()
    bad = np.zeros(S, bool)
    bad[ids[7]] = True
    assert np.isnan(out[bad]).all() and np.isfinite(out[~bad]).all()


# f32 sums of the same rows in another order (the compact form's pieces
# against index_add_ and against JAX's one-hot contraction): 1e-6 of
# max|ref|, or, where one segment sums thousands of rows (the "skew" map's
# hot segment, 6000), the rule of chip_smoke.py's skewed cases: each output
# within 4 x 2^-24 sqrt(n) x the sum of its n terms' magnitudes
COMPACT_TOL = 1e-6
COMPACT_SUM_TOL = 4 * 2.0 ** -24


def _close_sums(got, ref, data, ids, S):
    n = np.bincount(ids, minlength=S)[:, None]
    bound = COMPACT_SUM_TOL * np.sqrt(n) * seg_oracle(np.abs(data), ids, S)
    assert (np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)) <= bound).all()


SEG_MAPS = seg_maps()
SEG_MAP_IDS = [m[0] for m in SEG_MAPS]
# what choose_modes picks for each map of SEG_MAPS
SEG_MAP_MODES = {"uniform0": (segsum.THREAD,), "uniform1": (segsum.WARP, segsum.THREAD),
                 "uniform2": (segsum.THREAD,), "empty": (segsum.WARP, segsum.THREAD),
                 "skew": (segsum.WARP, segsum.WARP), "tail": (segsum.THREAD, segsum.THREAD),
                 "cams": (segsum.WARP, segsum.THREAD)}
SEG_MAPS_STAGED = {"uniform1", "cams"}  # the maps staged_eligible accepts


@pytest.mark.parametrize("name,ids,S", SEG_MAPS, ids=SEG_MAP_IDS)
def test_segsum_compact_form_matches_jax_plan(name, ids, S):
    """order/seg_start hold the real lanes of JAX's plan, lane for lane in
    its (tile, lane) order; the pieces tile each run in order."""
    mine, ref = _plans(ids, S)
    real = np.asarray(ref.mask).reshape(ref.gather_idx.shape) != 0
    T = ref.gather_idx.shape[0]
    dest = (np.arange(T)[:, None] * ref.tile_n + np.asarray(ref.rel))[real]
    np.testing.assert_array_equal(mine.order.numpy(), np.asarray(ref.gather_idx)[real])
    start = mine.seg_start.numpy()
    assert start.dtype == np.int32 and start[0] == 0 and start[-1] == len(ids)
    np.testing.assert_array_equal(np.repeat(np.arange(S), np.diff(start)), dest)
    assert mine.max_row == len(ids) - 1
    assert mine.modes == SEG_MAP_MODES[name]
    if len(mine.modes) == 1:
        assert mine.piece_start is None and mine.seg_piece is None
        return
    pieces, seg_piece = mine.piece_start.numpy(), mine.seg_piece.numpy()
    _, piece = segsum.choose_modes(np.diff(start), len(ids))
    assert (np.diff(pieces) > 0).all() and np.diff(pieces).max() <= piece
    # segment s's pieces start at its run and end at the next segment's
    np.testing.assert_array_equal(pieces[seg_piece[:-1]][np.diff(start) > 0],
                                  start[:-1][np.diff(start) > 0])
    np.testing.assert_array_equal(np.diff(seg_piece), -(-np.diff(start) // piece))
    assert pieces[-1] == len(ids) and seg_piece[-1] == len(pieces) - 1


@pytest.mark.parametrize("name,ids,S", SEG_MAPS, ids=SEG_MAP_IDS)
def test_segsum_compact_sum_matches_plain_and_jax(name, ids, S):
    """The sum the kernel computes, from the compact form alone, level by
    level, against the plain version and the Pallas kernel."""
    C = 9 if name in ("uniform1", "skew", "cams") else 3
    data = np.random.default_rng(10).normal(size=(len(ids), C)).astype(np.float32)
    mine, ref = _plans(ids, S)
    out = segsum.segment_sum_compact_reference(torch.from_numpy(data), mine)
    close(out, seg_oracle(data, ids, S), ORACLE_TOL)
    assert (mine.local is not None) == (name in SEG_MAPS_STAGED)
    if mine.local is not None:
        staged = segsum.segment_sum_staged_reference(torch.from_numpy(data), mine)
        close(staged, seg_oracle(data, ids, S), ORACLE_TOL)
        close(staged, out, COMPACT_TOL)
    plain = segsum.segment_sum_reference(torch.from_numpy(data), mine)
    jax_out = jax_segsum.pallas_segment_sum(jnp.asarray(data), ref, interpret=True)
    for other in (plain, jax_out):
        if name == "skew":
            _close_sums(out, other, data, ids, S)
        else:
            close(out, other, COMPACT_TOL)


@pytest.mark.parametrize("name,ids,S", [m for m in SEG_MAPS if m[0] in SEG_MAPS_STAGED],
                         ids=sorted(SEG_MAPS_STAGED, reverse=True))
def test_segsum_staged_form(name, ids, S):
    """The staged form holds every lane once, sorted by (chunk of data
    rows, destination), rows ascending within a cell."""
    plan = segsum.build_plan(ids, S)
    K, T = plan.n_chunks, segsum.STAGED_ROWS
    assert K == -(-len(ids) // T)
    cells = np.diff(plan.cell_start.numpy())
    assert cells.shape == (K * S,) and cells.sum() == len(ids)
    cell_of = np.repeat(np.arange(K * S), cells)
    rows = cell_of // S * T + plan.local.numpy()
    np.testing.assert_array_equal(np.sort(rows), np.arange(len(ids)))
    np.testing.assert_array_equal(ids[rows], cell_of % S)
    assert (np.diff(rows)[np.diff(cell_of) == 0] > 0).all()
    np.testing.assert_array_equal(plan.seg_chunks.numpy(), np.arange(S + 1) * K)


@pytest.mark.parametrize("counts,ok", [
    (np.full(1024, 977), True),                    # a camera's observations
    (np.full(250_000, 4), False),                  # too many segments, short runs
    (np.r_[np.full(1023, 464), 478_468], False),   # a hot camera: half the rows
    (np.full(2048, 64), True), (np.full(2049, 64), False), (np.full(100, 63), False),
])
def test_segsum_staged_eligible(counts, ok):
    assert segsum.staged_eligible(counts, int(counts.sum())) == ok


def test_segsum_hand_made_plan_gets_compact_form():
    """A plan built by hand (lanes reversed within each tile, so no longer
    sorted by destination) derives its compact form on first use, by a
    stable sort; a mask that is not 0/1 is refused."""
    data, ids = seg_inputs(*SEG_SHAPES[1])
    S = SEG_SHAPES[1][1]
    built = segsum.build_plan(ids, S)
    flip = torch.arange(built.rel.shape[1] - 1, -1, -1)
    plan = segsum.SegSumPlan(built.gather_idx[:, flip].contiguous(),
                             built.rel[:, flip].contiguous(),
                             built.mask[:, flip].contiguous(), built.tile_n, S)
    assert plan.order is None
    out = segsum.segment_sum_compact_reference(torch.from_numpy(data), plan)
    assert plan.order is not None and plan.modes == built.modes
    np.testing.assert_array_equal(plan.seg_start.numpy(), built.seg_start.numpy())
    assert sorted(plan.order.tolist()) == sorted(built.order.tolist())
    close(out, seg_oracle(data, ids, S), ORACLE_TOL)
    bad = segsum.SegSumPlan(built.gather_idx, built.rel, built.mask * 0.5, built.tile_n, S)
    with pytest.raises(ValueError, match="mask"):
        bad.compact()


@pytest.mark.parametrize("counts,modes", [
    (np.full(250_000, 4), (segsum.THREAD,)),                    # a point's observations
    (np.full(1024, 977), (segsum.WARP, segsum.THREAD)),         # a camera's
    (np.r_[np.full(1023, 464), 478_468], (segsum.WARP, segsum.WARP)),  # a hot camera
    (np.r_[np.full(9999, 3), 844], (segsum.THREAD, segsum.THREAD)),    # a popular point
    (np.r_[np.zeros(50, int), np.full(50, 20)], (segsum.WARP,)),
    (np.zeros(7, int), (segsum.THREAD,)),
])
def test_segsum_choose_modes(counts, modes):
    got, piece = segsum.choose_modes(counts, int(counts.sum()))
    assert got == modes and piece % 32 == 0
    assert (len(got) == 1) == (counts.max() <= piece)


@pytest.mark.parametrize("Ci,Cj,S,route", [
    (3, 9, 1024, "persistent"), (3, 9, 16, "persistent"),
    (3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36, "persistent"),
    (3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36 + 1, "atomics"),  # accumulator too large
    (9, 3, 64, "atomics"), (3, 3, 64, "atomics"), (8, 16, 1024, "atomics"),
])
def test_fused_pair_route(Ci, Cj, S, route):
    assert fusedpair.fused_pair_route(Ci, Cj, S) == route


@pytest.mark.parametrize("name", ["fused_pair_apply_atomics", "fused_pair_rows_floor"])
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_other_wrappers_plain_match_oracle(name, W, N, S):
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    out = getattr(fusedpair, name)(
        torch.from_numpy(ids), torch.from_numpy(blocks), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    if name == "fused_pair_rows_floor":
        close(out, r_ref, ORACLE_TOL)
        return
    close(out[0], r_ref, ORACLE_TOL)
    close(out[1], c_ref, ORACLE_TOL)


def test_segsum_plan_refuses_degenerate():
    """All rows into one segment: the padding waste is refused, as in
    thallo_tpu."""
    ids = np.zeros(100_000, np.int32)
    assert segsum.build_plan(ids, 100_000) is None
    assert jax_segsum.build_plan(ids, 100_000) is None


# ---------------------------------------------------------------------------
# wrapper dispatch: CPU tensors take the plain version, launch nothing
# ---------------------------------------------------------------------------
def _launches():
    return (fusedpair.fused_pair_apply.launches, ohsetup.oh_setup_products.launches,
            fullrepeat.fullrepeat_setup.launches, ohsetup.oh_setup_aggregate.launches,
            segsum.segment_sum.launches, fusedpair.fused_pair_apply_wloop.launches,
            loopfloor.add_one.launches, fusedpair.fused_pair_apply_atomics.launches,
            fusedpair.fused_pair_rows_floor.launches,
            *(getattr(fusedpair, name).launches for name in BF16_KERNELS))


def test_cpu_tensors_launch_no_kernel():
    before = _launches()
    test_fused_pair_plain_matches_jax(*FUSED_SHAPES[0])
    test_oh_products_plain_matches_oracle(*OH_SHAPES[0])
    rT, Jall = fr_inputs(*FR_SHAPES[0])
    fullrepeat.fullrepeat_setup(torch.from_numpy(rT), torch.from_numpy(Jall),
                                W=FR_SHAPES[0][1], N_t=FR_SHAPES[0][0], recipe=FR_RECIPE)
    test_oh_aggregate_plain_matches_oracle(*AGG_SHAPES[0])
    test_segsum_plain_matches_jax(*SEG_SHAPES[0])
    test_fused_pair_wloop_plain_matches_oracle(*WLOOP_SHAPES[0])
    for name in BF16_KERNELS:
        test_fused_pair_bf16_plain_matches_oracle(name, *FUSED_SHAPES[0])
    test_loop_floor_plain(1024)
    for name in ("fused_pair_apply_atomics", "fused_pair_rows_floor"):
        test_fused_pair_other_wrappers_plain_match_oracle(name, *FUSED_SHAPES[0])
    test_segsum_compact_sum_matches_plain_and_jax(*SEG_MAPS[0])
    assert _launches() == before


def test_unsupported_device_raises():
    ids = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fusedpair.fused_pair_apply(ids, ids.float(), ids.float(), ids.float(),
                                   Ci=1, Cj=1, S=2)


def test_unsupported_device_raises_new_kernels():
    ids = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ohsetup.oh_setup_aggregate(torch.zeros((2, 8), device="meta"), ids, N=4)
    plan = segsum.build_plan(np.arange(8, dtype=np.int32), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        segsum.segment_sum(torch.zeros((8, 2), device="meta"), plan)
