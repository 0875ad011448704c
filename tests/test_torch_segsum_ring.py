"""The staged segment sum's ring form (thallo_tpu_torch/ops/segsum.py,
csrc/segsum.cu staged_ring_kernel) on the CPU: the plan's block ranges,
the plain version's order of additions, and its sums against a float64
oracle and against the JAX package's pallas_segment_sum in interpret
mode, in f32 and in f64.

The module fixture turns on jax_enable_x64 for the f64 comparisons and
restores the flag when the module ends.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.torch_cases import close, seg_oracle  # noqa: E402
from thallo_tpu.ops import segsum as jax_segsum  # noqa: E402
from thallo_tpu_torch.ops import segsum  # noqa: E402

# (M, S, C): a camera-like map (long runs, the staged form) and a
# point-like one (short runs, too many segments for it)
MAPS = [(20_000, 64, 9), (20_000, 5_000, 3)]
DTYPES = [np.float32, np.float64]
# f64 oracle bound: f32 sums of ~300 terms in another order, f64 ones
ORACLE_TOL = {np.float32: 1e-5, np.float64: 1e-12}
# against JAX's interpret-mode kernel: a one-hot contraction in its own
# order, accumulated in f32 whatever the data's type
# (thallo_tpu/ops/segsum.py: preferred_element_type=jnp.float32), so f32's
# bound in f64 too
JAX_TOL = {np.float32: 1e-5, np.float64: 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _x64():
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", x64)


def _map(M, S, C, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, S, M).astype(np.int32), rng.normal(size=(M, C)).astype(dtype)


@pytest.mark.parametrize("blocks", [segsum.STAGED_BLOCKS, 6])
@pytest.mark.parametrize("M,S,C", MAPS)
def test_ring_form_is_consistent(monkeypatch, blocks, M, S, C):
    """Every lane once; the blocks' chunk ranges contiguous, in order,
    none empty, covering the K chunks; block_span their largest."""
    monkeypatch.setattr(segsum, "STAGED_BLOCKS", blocks)
    ids, _ = _map(M, S, C, np.float32)
    plan = segsum.build_plan(ids, S)
    if S > segsum.STAGED_MAX_SEGMENTS:
        assert plan.local is None and plan.block_chunk is None and plan.n_blocks == 0
        return
    K, G, T = plan.n_chunks, plan.n_blocks, plan.staged_rows
    assert T == segsum.STAGED_ROWS and K == -(-M // T) and G == min(K, blocks)
    bc = plan.block_chunk.numpy()
    assert bc.shape == (G + 1,) and bc[0] == 0 and bc[-1] == K
    assert (np.diff(bc) >= 1).all() and plan.block_span == np.diff(bc).max()
    cells = np.diff(plan.cell_start.numpy())
    cell = np.repeat(np.arange(K * S), cells)
    rows = cell // S * T + plan.local.numpy()
    np.testing.assert_array_equal(np.sort(rows), np.arange(M))
    np.testing.assert_array_equal(ids[rows], cell % S)
    # each block's lanes are one contiguous run of the cell order
    block = np.searchsorted(bc, cell // S, side="right") - 1
    assert (np.diff(block) >= 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", [segsum.STAGED_BLOCKS, 6])
def test_ring_partials_add_in_chunk_lane_order(monkeypatch, dtype, blocks):
    """Each (block, segment) partial is the sum from 0 of its lanes in
    (chunk, lane) order, bit for bit: the order the kernel adds in."""
    monkeypatch.setattr(segsum, "STAGED_BLOCKS", blocks)
    M, S, C = MAPS[0]
    ids, data = _map(M, S, C, dtype)
    plan = segsum.build_plan(ids, S)
    got = segsum.segment_sum_ring_partials(torch.from_numpy(data), plan).numpy()
    K, G, T = plan.n_chunks, plan.n_blocks, plan.staged_rows
    bc, cs, local = plan.block_chunk.numpy(), plan.cell_start.numpy(), plan.local.numpy()
    want = np.zeros((G, S, C), dtype)
    for g in range(G):
        for k in range(bc[g], bc[g + 1]):
            for s in range(S):
                for e in range(cs[k * S + s], cs[k * S + s + 1]):
                    want[g, s] += data[k * T + local[e]]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,S,C", MAPS)
def test_staged_and_plain_sums(dtype, M, S, C):
    """The plain versions give the same bits twice, agree with a float64
    oracle and with JAX's pallas_segment_sum in interpret mode (its plan
    from the same ids)."""
    ids, data = _map(M, S, C, dtype)
    plan = segsum.build_plan(ids, S)
    x = torch.from_numpy(data)
    fns = [segsum.segment_sum_reference, segsum.segment_sum_compact_reference]
    if plan.local is not None:
        fns.append(segsum.segment_sum_staged_reference)
    oracle = seg_oracle(data, ids, S)
    ref = jax_segsum.build_plan(ids, S)
    jax_out = np.asarray(jax_segsum.pallas_segment_sum(jnp.asarray(data), ref, interpret=True))
    assert jax_out.dtype == dtype
    for fn in fns:
        out = fn(x, plan)
        assert out.dtype == x.dtype and torch.equal(out, fn(x, plan))
        close(out, oracle, ORACLE_TOL[dtype])
        close(out, jax_out, JAX_TOL[dtype])
