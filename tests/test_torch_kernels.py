"""The port's kernel modules on the CPU: each plain torch version against
a float64 numpy oracle of its definition and against the JAX Pallas
kernel it replaces (run in interpret mode, as tests/test_{fusedpair,
ohsetup,fullrepeat,units}.py run it).  The CUDA kernels are held against
the plain versions in test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thallo_tpu.ops import segsum as jax_segsum  # noqa: E402
from thallo_tpu.ops.fullrepeat import fullrepeat_setup as jax_fullrepeat  # noqa: E402
from thallo_tpu.ops.fusedpair import fused_pair_apply as jax_fused_pair  # noqa: E402
from thallo_tpu.ops.ohsetup import oh_setup_aggregate as jax_oh_aggregate  # noqa: E402
from thallo_tpu.ops.ohsetup import oh_setup_products as jax_oh_products  # noqa: E402
from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup, segsum  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    AGG_SHAPES, CI, CJ, FR_RECIPE, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES,
    ORACLE_TOL, SEG_SHAPES, agg_inputs, agg_oracle, close, fr_inputs, fr_oracle,
    fused_inputs, fused_oracle, oh_inputs, oh_oracle, seg_inputs, seg_oracle)

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
            segsum.segment_sum.launches)


def test_cpu_tensors_launch_no_kernel():
    before = _launches()
    test_fused_pair_plain_matches_jax(*FUSED_SHAPES[0])
    test_oh_products_plain_matches_oracle(*OH_SHAPES[0])
    rT, Jall = fr_inputs(*FR_SHAPES[0])
    fullrepeat.fullrepeat_setup(torch.from_numpy(rT), torch.from_numpy(Jall),
                                W=FR_SHAPES[0][1], N_t=FR_SHAPES[0][0], recipe=FR_RECIPE)
    test_oh_aggregate_plain_matches_oracle(*AGG_SHAPES[0])
    test_segsum_plain_matches_jax(*SEG_SHAPES[0])
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
