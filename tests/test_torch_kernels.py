"""The port's three kernel modules on the CPU: each plain torch version
against a float64 numpy oracle of its definition and against the JAX
Pallas kernel it replaces (run in interpret mode, as tests/test_{fusedpair,
ohsetup,fullrepeat}.py run it).  The CUDA kernels are held against the
plain versions in test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from thallo_tpu.ops.fullrepeat import fullrepeat_setup as jax_fullrepeat  # noqa: E402
from thallo_tpu.ops.fusedpair import fused_pair_apply as jax_fused_pair  # noqa: E402
from thallo_tpu.ops.ohsetup import oh_setup_products as jax_oh_products  # noqa: E402
from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    CI, CJ, FR_RECIPE, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES, ORACLE_TOL,
    close, fr_inputs, fr_oracle, fused_inputs, fused_oracle, oh_inputs, oh_oracle)

# JAX's products/full-repeat kernels split f32 into three bf16 terms
# exactly, so only the summation order differs from the plain version
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
# wrapper dispatch: CPU tensors take the plain version, launch nothing
# ---------------------------------------------------------------------------
def test_cpu_tensors_launch_no_kernel():
    before = (fusedpair.fused_pair_apply.launches, ohsetup.oh_setup_products.launches,
              fullrepeat.fullrepeat_setup.launches)
    test_fused_pair_plain_matches_jax(*FUSED_SHAPES[0])
    test_oh_products_plain_matches_oracle(*OH_SHAPES[0])
    rT, Jall = fr_inputs(*FR_SHAPES[0])
    fullrepeat.fullrepeat_setup(torch.from_numpy(rT), torch.from_numpy(Jall),
                                W=FR_SHAPES[0][1], N_t=FR_SHAPES[0][0], recipe=FR_RECIPE)
    after = (fusedpair.fused_pair_apply.launches, ohsetup.oh_setup_products.launches,
             fullrepeat.fullrepeat_setup.launches)
    assert before == after


def test_unsupported_device_raises():
    ids = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fusedpair.fused_pair_apply(ids, ids.float(), ids.float(), ids.float(),
                                   Ci=1, Cj=1, S=2)
