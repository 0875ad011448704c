"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here needs an NVIDIA GPU: they carry the `cuda` marker
and skip without one.  No JAX: the card's machine runs the port alone
(`python -m pytest tests/test_torch_cuda.py -m cuda`)."""
import pytest

torch = pytest.importorskip("torch")

from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    CI, CJ, FR_RECIPE, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES, close,
    fr_inputs, fused_inputs, oh_inputs)

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
