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
    AGG_SHAPES, CI, CJ, FR_RECIPE, FR_RECIPE2, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES,
    ORACLE_TOL, SEG_SHAPES, WLOOP_SHAPES, agg_inputs, agg_oracle, bf16_round, close,
    fr_inputs, fr_oracle, fused_inputs, fused_oracle, hot_ids, oh_inputs, oh_oracle,
    seg_inputs, seg_maps, seg_oracle)


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


@pytest.mark.parametrize("W,N,S", WLOOP_SHAPES)
def test_fused_pair_wloop_chunked_plain_matches_oracle(W, N, S):
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    rows, cols = fusedpair.fused_pair_apply_wloop_chunked(
        torch.from_numpy(ids), torch.from_numpy(blocks), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    close(rows, r_ref, ORACLE_TOL)
    close(cols, c_ref, ORACLE_TOL)


# the skewed 1M BA scene's five point levels (W, N_t)
SKEW_LEVELS = [(2, 250000), (6, 70845), (24, 12599), (96, 2054), (716, 325)]


@pytest.mark.parametrize("W,N", SKEW_LEVELS + [(9, 1), (1, 10), (100, 17), (5, 0), (0, 5)])
@pytest.mark.parametrize("sms", [132, 1])
def test_wloop_plan(W, N, sms):
    """Items of one 32-element tile and w_item w's cover every (w, n) once
    (the kernel's item -> (tile, w0) map); about one item per warp of the
    grid, at least WLOOP_MIN_ITEM w's where W has that many; the grid no
    larger than the items fill, and within the blocks the SMs hold."""
    w_item, grid = fusedpair.wloop_plan(W, N, 1024, sms)
    warps = fusedpair.WLOOP_THREADS // 32
    tiles, chunks = -(-N // 32), -(-W // w_item)
    assert w_item >= 1 and grid >= 1
    assert w_item >= min(W, fusedpair.WLOOP_MIN_ITEM) and (w_item - 1) * chunks < W or W == 0
    covered = np.zeros((max(W, 1), max(tiles, 1)), int)
    for item in range(tiles * chunks):
        tile, w0 = divmod(item, chunks)
        covered[w0 * w_item:min(W, (w0 + 1) * w_item), tile] += 1
    assert W == 0 or N == 0 or (covered == 1).all()
    assert grid <= max(1, -(-(tiles * chunks) // warps))
    assert grid <= fusedpair.WLOOP_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("W,N_t,Ci,Cj,S,route", [
    # the skewed 1M scene's levels (measured on the card: PERF.md, the route)
    *[(W, N, 3, 9, 1024, r) for (W, N), r in zip(SKEW_LEVELS, [
        "fused_pair_apply", "fused_pair_apply", "fused_pair_apply_wloop",
        "fused_pair_apply_wloop", "fused_pair_apply_wloop"])],
    # narrow levels of few elements (measured too): the W-loop kernel
    (8, 16384, 3, 9, 1024, "fused_pair_apply_wloop"), (4, 8192, 3, 9, 1024, "fused_pair_apply_wloop"),
    (2, 32768, 3, 9, 1024, "fused_pair_apply"),
    # the boundary: WLOOP_MIN_W wide, PERSISTENT_MIN_N elements
    (fusedpair.WLOOP_MIN_W - 1, fusedpair.PERSISTENT_MIN_N, 3, 9, 1024, "fused_pair_apply"),
    (fusedpair.WLOOP_MIN_W - 1, fusedpair.PERSISTENT_MIN_N - 1, 3, 9, 1024,
     "fused_pair_apply_wloop"),
    (fusedpair.WLOOP_MIN_W, fusedpair.PERSISTENT_MIN_N, 3, 9, 1024, "fused_pair_apply_wloop"),
    (fusedpair.WLOOP_MIN_W, 10 ** 7, 3, 9, 1024, "fused_pair_apply_wloop"),
    # accumulators beyond the persistent kernels; other pairs
    (24, 333, 3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36 + 1, "fused_pair_apply_wloop_chunked"),
    (24, 333, 3, 9, 96 * 1024 // 4 + 1, "fused_pair_apply_atomics"),
    (4, 333, 3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36 + 1, "fused_pair_apply_atomics"),
    (24, 333, 3, 3, 64, "fused_pair_apply_wloop_chunked"),
    (4, 333, 9, 3, 64, "fused_pair_apply_atomics"),
    # wide levels of more row channels than the chunked kernel's MAX_CI
    # (a 9-channel rotation row of a vertex of degree >= 9)
    (9, 1001, fusedpair.MAX_CI, 3, 64, "fused_pair_apply_wloop_chunked"),
    (9, 1001, fusedpair.MAX_CI + 1, 3, 64, "fused_pair_apply_atomics"),
    (24, 333, 9, 3, 64, "fused_pair_apply_atomics"),
])
def test_fused_pair_route_levels(W, N_t, Ci, Cj, S, route):
    assert fusedpair.fused_pair_route(W, N_t, Ci, Cj, S) == route


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


def test_loop_floor_plain_odd_length():
    """L % 4 != 0, as 7 tiles of 143."""
    x = np.random.default_rng(6).normal(size=(loopfloor.ROWS, 1001)).astype(np.float32)
    out = loopfloor.add_one(torch.from_numpy(x), tiles=7)
    np.testing.assert_array_equal(out.numpy(), x + np.float32(1))


# ---------------------------------------------------------------------------
# bf16 blocks on the solver's path (block_dtype="bf16"): the wrappers of
# the bf16 persistent kernels and of the first bf16 body
# ---------------------------------------------------------------------------
BF16_PAIR_WRAPPERS = ["fused_pair_apply", "fused_pair_apply_wloop", "fused_pair_apply_bf16",
                      "fused_pair_apply_wloop_bf16", "fused_pair_bf16_atomics",
                      "fused_pair_apply_atomics_bf16"]


@pytest.mark.parametrize("name", BF16_PAIR_WRAPPERS)
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES + WLOOP_SHAPES[:2])
def test_fused_pair_bf16_blocks_plain_matches_oracle(name, W, N, S):
    """Each wrapper that takes bf16 blocks (the f32 entry points dispatch
    them by dtype) on the CPU: the oracle on the same rounded values."""
    ids, blocks, pcol, prow = _bf16_inputs(W, N, S)
    rows, cols = getattr(fusedpair, name)(
        torch.from_numpy(ids), torch.from_numpy(blocks).bfloat16(), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    close(rows, r_ref, ORACLE_TOL)
    close(cols, c_ref, ORACLE_TOL)


@pytest.mark.parametrize("W,N,S", FUSED_SHAPES + WLOOP_SHAPES[:2])
def test_fused_pair_bf16_blocks_plain_matches_jax(W, N, S):
    """Against JAX's fused_pair_apply on bf16 blocks in interpret mode
    (its _kernel or _kernel_wloop, as its solver runs them under
    block_dtype="bf16"), which also rounds pcol and z to bf16: JAX_BF16_TOL."""
    ids, blocks, pcol, prow = _bf16_inputs(W, N, S)
    rows, cols = fusedpair.fused_pair_apply(
        torch.from_numpy(ids), torch.from_numpy(blocks).bfloat16(), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S)
    jr, jc = jax_fused_pair(jnp.asarray(ids), jnp.asarray(blocks, jnp.bfloat16),
                            jnp.asarray(pcol), jnp.asarray(prow), Ci=CI, Cj=CJ, S=S,
                            interpret=True)
    close(rows, jr, JAX_BF16_TOL)
    close(cols, jc, JAX_BF16_TOL)


def test_bf16_elems():
    """Two elements a thread only where N is even (a bf16 pair is then
    4-byte aligned in every block plane)."""
    assert fusedpair.bf16_elems(250_000) == fusedpair.BF16_ELEMS
    assert fusedpair.bf16_elems(70_845) == 1


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
    (3, 9, 1024, "fused_pair_apply"), (3, 9, 16, "fused_pair_apply"),
    (3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36, "fused_pair_apply"),
    # accumulator too large
    (3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36 + 1, "fused_pair_apply_atomics_thread"),
    (9, 3, 64, "fused_pair_apply_atomics_thread"), (3, 3, 64, "fused_pair_apply_atomics"),
    (8, 16, 1024, "fused_pair_apply_atomics_thread"),
])
def test_fused_pair_route(Ci, Cj, S, route):
    """Narrow levels (W 4, many elements): the persistent kernel where the
    pair and its accumulator fit it, else the atomics route: the slots
    kernel for the 3 x 3 pair, the first atomics body for the others
    (atomics_keeps_thread)."""
    assert fusedpair.fused_pair_route(4, 250_000, Ci, Cj, S) == route


BA_RECIPE = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))


@pytest.mark.parametrize("recipe,K", [(BA_RECIPE, 18), (OH_RECIPE, 24)])
@pytest.mark.parametrize("N", [1024, 97, 3000])
def test_products_plan(recipe, K, N):
    """Every output row comes from exactly one channel, as its row or its
    mirror; a symmetric pair keeps a <= b; the chunks cover the channels
    and each block's shared memory fits the budget."""
    plan = ohsetup.products_plan(recipe, 2, K, N, ohsetup.PRODUCTS_THREADS,
                                 ohsetup.PRODUCTS_SMEM)
    F = ohsetup.recipe_width(recipe)
    assert plan.F == F
    rows = [f for f, _ in plan.dest] + [m for _, m in plan.dest if m >= 0]
    assert sorted(rows) == list(range(F))
    n_sym = 45 if recipe == BA_RECIPE else 45 + 27
    assert len(plan.chan) == 18 + n_sym
    assert plan.n_chunks * plan.chunk >= len(plan.chan) > (plan.n_chunks - 1) * plan.chunk
    assert plan.block_smem <= ohsetup.PRODUCTS_SMEM
    assert max(max(a0 + sa, b0 + sb) for a0, sa, b0, sb in plan.chan) <= 2 + K
    if (recipe, N) == (BA_RECIPE, 1024):  # BA-1M's camera slot: 2 chunks of 32
        assert (plan.chunk, plan.n_chunks, plan.stride) == (32, 2, 33)


@pytest.mark.parametrize("N,fits", [(20000, True), (30000, False)])
def test_products_plan_refuses_wide_rows(N, fits):
    """A channel row that does not fit the budget: no plan (the atomics
    route)."""
    assert (ohsetup.products_plan(BA_RECIPE, 2, 18, N, 256, 112 * 1024) is not None) == fits


@pytest.mark.parametrize("recipe,K", [(BA_RECIPE, 18), (OH_RECIPE, 24)])
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("share", [0.0, 0.5])
def test_oh_products_planned_matches_plain(recipe, K, small, share):
    """The plan applied in plain torch (chunked, mirrored: what the kernel
    sums) against the plain version; `small` leaves room for 5 channels a
    block, so the channels run as many chunks.  f32 sums of the same terms
    in another order: JAX_EXACT_TOL of max|ref|."""
    R, N = OH_SHAPES[1]
    rT, Jall, ids = oh_inputs(R, N)
    args = (torch.from_numpy(rT), torch.from_numpy(Jall[:K].copy()),
            torch.from_numpy(hot_ids(ids, share)))
    threads = ohsetup.PRODUCTS_THREADS
    smem = ohsetup._smem_bytes(5, N, 2, K, threads) if small else ohsetup.PRODUCTS_SMEM
    plan = ohsetup.products_plan(recipe, 2, K, N, threads, smem)
    assert plan.n_chunks > 1 and (plan.chunk <= 5) == small
    out = ohsetup.oh_setup_products_planned(*args, N=N, recipe=recipe, smem=smem)
    close(out, ohsetup.oh_setup_products_reference(*args, N=N, recipe=recipe), JAX_EXACT_TOL)


@pytest.mark.parametrize("share", [0.5, 1.0])
def test_oh_products_plain_matches_jax_hot_ids(share):
    """A hot camera: `share` of the rows on one id, against the Pallas
    kernel in interpret mode (JAX_EXACT_TOL: its bf16 split is exact; the
    hot id's sums hold ~R x share terms in another order)."""
    R, N = OH_SHAPES[1]
    rT, Jall, ids = oh_inputs(R, N)
    ids = hot_ids(ids, share)
    out = ohsetup.oh_setup_products(
        torch.from_numpy(rT), torch.from_numpy(Jall), torch.from_numpy(ids),
        N=N, recipe=OH_RECIPE)
    ref = jax_oh_products(jnp.asarray(rT), jnp.asarray(Jall), jnp.asarray(ids), N=N,
                          recipe=OH_RECIPE, interpret=True)
    close(out, ref, JAX_EXACT_TOL)
    close(out, oh_oracle(rT, Jall, ids, N, OH_RECIPE), ORACLE_TOL)


def _fr_recipe(rc, extra):
    """The point and camera slots' full-repeat recipe and, with `extra`
    channels of a further slot, FR_RECIPE2's second cross pair shifted to
    that slot's rows."""
    if not extra:
        return FR_RECIPE
    return (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 3 * rc, 9, 0), ("diag", 0, 3, 0, 3),
            ("cross", 0, 3, 12 * rc, extra, 1), ("jtr", 12 * rc, extra))


@pytest.mark.parametrize("W", range(fullrepeat.MIN_W, fullrepeat.MAX_W + 1))
@pytest.mark.parametrize("rc,extra", [(2, 0), (4, 3), (8, 4)])  # Kall 24, 60, 128
def test_fullrepeat_plan(W, rc, extra):
    """Over W 2-8, Kall up to 128 and rc up to 8 the tile kernel has a
    plan: its windows and tables fit a block's shared memory (and the SM's
    at its blocks per SM), a tile is whole warps, every element lies in a
    tile, and the channels write every agg row once (as a row or a mirror)
    and every cross row once."""
    Kall = rc * (12 + extra)
    recipe = _fr_recipe(rc, extra)
    plan = fullrepeat.fullrepeat_plan(recipe, W, Kall, rc)
    assert plan is not None
    assert plan.block_smem == fullrepeat.tile_smem(rc, Kall, W, plan.T, plan.stages,
                                                   len(plan.groups), len(plan.chans))
    assert plan.block_smem <= 232_448  # an H100 block's dynamic shared memory
    assert plan.blocks_per_sm * (plan.block_smem + 1024) <= 227 * 1024
    assert plan.T % 32 == 0 and plan.threads % 32 == 0
    assert plan.threads <= min(fullrepeat.FULLREPEAT_THREADS, plan.T * len(plan.groups))
    for N_t in (1, plan.T - 1, 1000, 250_000):
        grid = fullrepeat.fullrepeat_grid(plan, N_t, 132)
        tiles = {t for b in range(grid) for t in range(b, -(-N_t // plan.T), grid)}
        assert tiles == set(range(-(-N_t // plan.T)))
    agg_rows, cross_rows = [], []
    for b0, sb, row, step in plan.chans:
        assert b0 + (rc - 1) * sb < rc + Kall
        if step > 0:
            cross_rows += [row + w * step for w in range(W)]
        else:
            agg_rows += [row] + ([-1 - step] if step < 0 else [])
    assert sorted(agg_rows) == list(range(plan.F_agg))
    assert sorted(cross_rows) == list(range(sum(plan.cross_widths)))
    bounds = [j for _, _, j0, j1 in plan.groups for j in (j0, j1)]
    assert bounds[0] == 0 and bounds[-1] == len(plan.chans)
    assert bounds[1:-1:2] == bounds[2:-1:2]  # each group starts where the last ended
    if (W, rc, extra) == (4, 2, 0):  # BA-1M's point level: 3 groups of 39 channels
        assert (plan.T, plan.stages, plan.threads, plan.blocks_per_sm, len(plan.chans)) \
            == (128, 2, 384, 2, 39)


@pytest.mark.parametrize("W,Kall,rc", [(9, 24, 2), (1, 24, 2), (40, 24, 2), (4, 129, 2),
                                       (4, 90, 9)])
def test_fullrepeat_plan_refuses(W, Kall, rc):
    """Shapes outside W 2-8, Kall <= 128, rc <= 8 have no plan: they take
    the first body (fullrepeat_setup_thread)."""
    assert fullrepeat.fullrepeat_plan(FR_RECIPE, W, Kall, rc) is None


@pytest.mark.parametrize("recipe", [FR_RECIPE, FR_RECIPE2], ids=["one_cross", "two_cross"])
@pytest.mark.parametrize("N_t,W", FR_SHAPES + [(333, 2), (77, 8)])
def test_fullrepeat_planned_matches_plain(recipe, N_t, W):
    """The plan applied in plain torch (what the tile kernel computes: its
    channels, mirrors and w-strided cross rows) against the plain version
    and the float64 oracle, every output row written."""
    extra = 2 if recipe == FR_RECIPE2 else 0
    rT, Jall = (torch.from_numpy(a) for a in fr_inputs(N_t, W, extra=extra))
    agg, crosses = fullrepeat.fullrepeat_setup_planned(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    ragg, rcross = fullrepeat.fullrepeat_setup_reference(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    assert len(crosses) == len(rcross) == (2 if extra else 1)
    for got, ref in zip([agg, *crosses], [ragg, *rcross]):
        assert bool(torch.isfinite(got).all())
        close(got, ref, JAX_EXACT_TOL)
    agg_ref, cross_ref = fr_oracle(rT.numpy(), Jall[:24].numpy(), N_t, W)
    close(agg[:agg_ref.shape[0]], agg_ref, ORACLE_TOL)
    close(crosses[0], cross_ref, ORACLE_TOL)


@pytest.mark.parametrize("F,N,chunks", [(9, 1024, 1), (18, 1024, 1), (56, 1024, 2), (13, 300, 1),
                                        (200, 64, 1), (1, 6371, 1), (400, 1000, 8)])
def test_aggregate_plan(F, N, chunks):
    """The aggregation kernel's chunks cover the channels in equal parts,
    the fewest that fit AGG_SMEM, each accumulator a whole number of warp
    merge batches."""
    plan = ohsetup.aggregate_plan(F, N)
    assert plan.n_chunks == chunks
    assert plan.n_chunks * plan.chunk >= F > (plan.n_chunks - 1) * plan.chunk
    assert plan.acc_rows % ohsetup.AGG_BATCH == 0 and plan.acc_rows >= plan.chunk
    assert plan.block_smem == plan.acc_rows * N * 4 <= ohsetup.AGG_SMEM
    grid = ohsetup.aggregate_grid(plan, 1_000_000, ohsetup.AGG_THREADS, 132)
    assert grid * plan.n_chunks <= 132 * ohsetup.AGG_BLOCKS_PER_SM


@pytest.mark.parametrize("N", [6372, 20000])
def test_aggregate_plan_refuses_wide_rows(N):
    """Where not one batch of channel rows fits: no plan (the first body's
    route)."""
    assert ohsetup.aggregate_plan(9, N) is None


@pytest.mark.parametrize("F,R,N", [(13, 6161, 300), (56, 4099, 1024)])
@pytest.mark.parametrize("share", [0.0, 0.5])
def test_oh_aggregate_planned_matches_plain(F, R, N, share):
    """The plan applied in plain torch (chunked) against the plain version:
    every row written; ids out of range drop; `share` of the rows on one
    id."""
    parts, ids = agg_inputs(R, N, F=F)
    p, i = torch.from_numpy(parts), torch.from_numpy(hot_ids(ids, share))
    out = ohsetup.oh_setup_aggregate_planned(p, i, N=N)
    assert bool(torch.isfinite(out).all())
    close(out, ohsetup.oh_setup_aggregate_reference(p, i, N=N), JAX_EXACT_TOL)


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
            fusedpair.fused_pair_apply_wloop_chunked.launches,
            ohsetup.oh_setup_products_atomics.launches,
            fullrepeat.fullrepeat_setup_thread.launches,
            ohsetup.oh_setup_aggregate_atomics.launches,
            *(getattr(fusedpair, name).launches for name in BF16_KERNELS + BF16_PAIR_WRAPPERS))


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
    for name in BF16_PAIR_WRAPPERS:
        test_fused_pair_bf16_blocks_plain_matches_oracle(name, *FUSED_SHAPES[0])
    for name in ("fused_pair_apply_atomics", "fused_pair_rows_floor"):
        test_fused_pair_other_wrappers_plain_match_oracle(name, *FUSED_SHAPES[0])
    test_segsum_compact_sum_matches_plain_and_jax(*SEG_MAPS[0])
    test_fused_pair_wloop_chunked_plain_matches_oracle(*WLOOP_SHAPES[0])
    rT, Jall, ids = (torch.from_numpy(a) for a in oh_inputs(*OH_SHAPES[0]))
    ohsetup.oh_setup_products_atomics(rT, Jall, ids, N=OH_SHAPES[0][1], recipe=OH_RECIPE)
    rT, Jall = (torch.from_numpy(a) for a in fr_inputs(*FR_SHAPES[0]))
    fullrepeat.fullrepeat_setup_thread(rT, Jall, W=FR_SHAPES[0][1], N_t=FR_SHAPES[0][0],
                                       recipe=FR_RECIPE)
    parts, ids = (torch.from_numpy(a) for a in agg_inputs(*AGG_SHAPES[0]))
    ohsetup.oh_setup_aggregate_atomics(parts, ids, N=AGG_SHAPES[0][1])
    assert _launches() == before


def test_unsupported_device_raises():
    ids = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fusedpair.fused_pair_apply(ids, ids.float(), ids.float(), ids.float(),
                                   Ci=1, Cj=1, S=2)


def test_unsupported_device_raises_new_kernels():
    ids = torch.zeros((8,), dtype=torch.int32, device="meta")
    for fn in (ohsetup.oh_setup_aggregate, ohsetup.oh_setup_aggregate_atomics):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros((2, 8), device="meta"), ids, N=4)
    for fn in (fullrepeat.fullrepeat_setup, fullrepeat.fullrepeat_setup_thread):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros((2, 8), device="meta"), torch.zeros((24, 8), device="meta"), W=4,
               N_t=2, recipe=FR_RECIPE)
    plan = segsum.build_plan(np.arange(8, dtype=np.int32), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        segsum.segment_sum(torch.zeros((8, 2), device="meta"), plan)
    r = torch.zeros((2, 8), device="meta")
    for fn in (ohsetup.oh_setup_products, ohsetup.oh_setup_products_atomics):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(r, torch.zeros((18, 8), device="meta"), ids, N=4, recipe=BA_RECIPE)
    ids2d = torch.zeros((12, 8), dtype=torch.int32, device="meta")
    for fn in (fusedpair.fused_pair_apply_wloop, fusedpair.fused_pair_apply_wloop_chunked):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(ids2d, ids2d.float(), ids2d.float(), ids2d.float(), Ci=1, Cj=1, S=2)
