"""The two kernels redesigned for the H100's f64 routes, on the CPU from
their plans alone: the w-lane W-loop pair on bf16 blocks with f64 values
(fused_pair_apply_wloop_bf16_f64: wloop_lanes_plan, fused_pair_route, fused_pair_apply_wloop_lanes_planned) and the range
products kernel (oh_setup_products_f64, and the f32 oh_setup_products:
products_ranges_plan, products_ranges_grid, products_route,
oh_setup_products_ranges_planned), each planned form against the plain
version and a float64 oracle in f64, and in f32 against the JAX Pallas
kernel it replaces (interpret mode, as tests/test_torch_kernels.py runs
it).  The CUDA kernels are held against the plain versions in
test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thallo_tpu.ops.fusedpair import fused_pair_apply as jax_fused_pair  # noqa: E402
from thallo_tpu.ops.ohsetup import oh_setup_products as jax_oh_products  # noqa: E402
from thallo_tpu_torch.ops import fusedpair, ohsetup  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    CI, CJ, OH_RECIPE, ORACLE_TOL, bf16_round, close, fused_oracle, hot_ids, oh_inputs,
    oh_oracle)

# f64 sums of the same terms in another order
F64_TOL = 1e-12
# the f32 planned forms against JAX: its products kernel splits f32 into
# three bf16 terms exactly (only the order differs); its fused pair rounds
# pcol and z to bf16 (tests/test_torch_kernels.py's JAX_EXACT_TOL and
# JAX_BF16_TOL)
JAX_EXACT_TOL = 1e-5
JAX_BF16_TOL = 1e-2
BA_RECIPE = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))
SMS = 132  # the H100's SMs: the plans the card takes


def _pair_inputs(W, N, S, share=0.0, seed=0):
    """ids with out-of-range entries and `share` on one camera, bf16-exact
    blocks, normal pcol and prow (f64)."""
    rng = np.random.default_rng(seed)
    ids = hot_ids(rng.integers(-2, S + 3, (W, N)), share, hot=min(5, S - 1))
    blocks = bf16_round(rng.normal(size=(W * CI * CJ, N)).astype(np.float32))
    return ids, blocks, rng.normal(size=(CJ, S)), rng.normal(size=(CI, N))


# ---------------------------------------------------------------------------
# the w-lane W-loop kernel
# ---------------------------------------------------------------------------
# the skewed 1M scene's wide levels, phase 28(a)'s (10, 100 000), short
# and odd ones, and N below one item
PLAN_SHAPES = [(10, 100_000), (24, 12_599), (96, 2_054), (716, 325), (9, 1001), (11, 5),
               (10, 16), (1, 40), (0, 7), (13, 0)]


@pytest.mark.parametrize("W,N", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [SMS, 2 * SMS, 1, 7])
def test_wloop_lanes_plan(W, N, sms):
    """Items of `elems` elements (32 / elems w-lanes) and w_item w's cover
    every (w, n) once; one block an SM; no other (elems, w_item) of the
    candidates gives the busiest warp fewer rounds; at least
    WLOOP_MIN_ITEM w's an item where W has that many."""
    elems, w_item, grid = fusedpair.wloop_lanes_plan(W, N, sms)
    assert elems in fusedpair.WLOOP_LANES_ELEMS
    assert grid == sms
    assert 1 <= w_item and (W == 0 or w_item >= min(W, fusedpair.WLOOP_MIN_ITEM))
    lanes, warps = 32 // elems, grid * fusedpair.WLOOP_LANES_THREADS // 32
    # the kernel's item -> (tile, w0), lane -> (h, e) map covers each (w, n) once
    if 0 < W * N <= 20_000:
        seen = np.zeros((W, N), np.int64)
        chunks = -(-W // w_item)
        for item in range(-(-N // elems) * chunks):
            tile, w0 = divmod(item, chunks)
            w0 *= w_item
            w1 = min(W, w0 + w_item)
            for h in range(lanes):
                for w in range(w0 + h, w1, lanes):
                    n = np.arange(tile * elems, min(N, (tile + 1) * elems))
                    seen[w, n] += 1
        assert (seen == 1).all()

    def rounds(e, wi):
        items = -(-N // e) * -(-W // wi)
        return -(-items // warps) * -(-wi // (32 // e))

    if W and N:
        best = min(rounds(e, -(-W // k)) for e in fusedpair.WLOOP_LANES_ELEMS
                   for k in range(1, W + 1) if -(-W // k) >= min(W, fusedpair.WLOOP_MIN_ITEM))
        assert rounds(elems, w_item) == best


def test_wloop_lanes_plan_at_the_path_shapes():
    """Phase 28(a)'s level takes items of 16 elements that cover all 10 w's
    (rows stored; 3 items a warp, 5 steps each); the skewed scene's
    widest level splits its w's."""
    assert fusedpair.wloop_lanes_plan(10, 100_000, SMS) == (16, 10, SMS)
    elems, w_item, _ = fusedpair.wloop_lanes_plan(716, 325, SMS)
    assert w_item < 716


@pytest.mark.parametrize("W,N,S,want", [
    (10, 100_000, 1024, "fused_pair_apply_wloop_bf16_f64"),
    (10, 32_768, 1592, "fused_pair_apply_wloop_bf16_f64"),
    (24, 12_599, 1024, "fused_pair_apply_wloop_bf16_f64"),
    (716, 325, 1024, "fused_pair_apply_wloop_bf16_f64"),
    (9, 32_767, 64, "fused_pair_apply_wloop_bf16_f64"),
    (4, 250_000, 1024, "fused_pair_apply_bf16_f64"),
    (10, 100_000, 2000, "fused_pair_apply_atomics_bf16_f64")])
def test_wloop_bf16_f64_route(W, N, S, want):
    """Wide bf16-f64 levels of the 3 x 9 pair take the w-lane kernel at
    every N (the skewed 1M scene's short levels too), and the first
    <bf16, double> body is on no route; narrow long ones the persistent
    pair; an accumulator beyond the shared memory the slots kernel.  The
    f64 and f32 routes are unchanged."""
    assert fusedpair.fused_pair_route(W, N, CI, CJ, S, bf16=True, dtype=torch.float64) == want
    f64 = fusedpair.fused_pair_route(W, N, CI, CJ, S, dtype=torch.float64)
    assert f64 == want.replace("_bf16", "") \
        or f64 == "fused_pair_apply_atomics_thread_f64"
    assert fusedpair.fused_pair_route(10, 100_000, CI, CJ, 1024) == "fused_pair_apply_wloop"


@pytest.mark.parametrize("W,N,S,share", [(10, 3000, 64, 0.0), (24, 333, 300, 0.5),
                                         (716, 40, 30, 0.5), (9, 5, 64, 0.0),
                                         (10, 100_000, 1024, 0.0)])
def test_wloop_lanes_planned_matches_plain_and_oracle(W, N, S, share):
    """The w-lane kernel's sums from its plan (w-lanes, w-chunks) in f64,
    against the plain version and the float64 oracle."""
    ids, blocks, pcol, prow = _pair_inputs(W, N, S, share)
    args = (torch.from_numpy(ids), torch.from_numpy(blocks).bfloat16(), torch.from_numpy(pcol),
            torch.from_numpy(prow))
    got = fusedpair.fused_pair_apply_wloop_lanes_planned(*args, Ci=CI, Cj=CJ, S=S, sms=SMS)
    ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=S)
    for g, r, o in zip(got, ref, fused_oracle(ids, blocks, pcol, prow, S)):
        assert g.dtype == torch.float64
        close(g, r, F64_TOL)
        close(g, o, F64_TOL)


@pytest.mark.parametrize("W,N,S", [(12, 2000, 64), (24, 333, 300)])
def test_wloop_lanes_planned_f32_matches_jax(W, N, S):
    """The plan's sums in f32 against JAX's W-loop kernel (interpret
    mode), which rounds pcol and z to bf16."""
    ids, blocks, pcol, prow = _pair_inputs(W, N, S)
    pcol, prow = pcol.astype(np.float32), prow.astype(np.float32)
    rows, cols = fusedpair.fused_pair_apply_wloop_lanes_planned(
        torch.from_numpy(ids), torch.from_numpy(blocks), torch.from_numpy(pcol),
        torch.from_numpy(prow), Ci=CI, Cj=CJ, S=S, sms=SMS)
    jr, jc = jax_fused_pair(jnp.asarray(ids), jnp.asarray(blocks), jnp.asarray(pcol),
                            jnp.asarray(prow), Ci=CI, Cj=CJ, S=S, interpret=True)
    close(rows, jr, JAX_BF16_TOL)
    close(cols, jc, JAX_BF16_TOL)


@pytest.mark.parametrize("name", ["fused_pair_apply_wloop_bf16_f64",
                                  "fused_pair_apply_wloop_bf16_f64_gathered"])
def test_wloop_bf16_f64_bodies_on_cpu_take_the_plain_version(name):
    """On CPU tensors both bodies return the plain version and count no
    launch."""
    ids, blocks, pcol, prow = _pair_inputs(10, 300, 64, 0.5)
    args = (torch.from_numpy(ids), torch.from_numpy(blocks).bfloat16(), torch.from_numpy(pcol),
            torch.from_numpy(prow))
    ref = fusedpair.fused_pair_apply_reference(*args, Ci=CI, Cj=CJ, S=64)
    fn = getattr(fusedpair, name)
    n0 = fn.launches
    got = fn(*args, Ci=CI, Cj=CJ, S=64)
    assert fn.launches == n0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# the range products kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("recipe,K", [(BA_RECIPE, 18), (OH_RECIPE, 24)])
@pytest.mark.parametrize("N", [1024, 5, 97, 3000, 9000])
@pytest.mark.parametrize("threads,itemsize", [(512, 8), (256, 8), (1024, 4)])
def test_products_ranges_plan(recipe, K, N, threads, itemsize):
    """The ranges cover [0, N) in equal spans; each range's accumulator
    rows (an odd stride of at least the chunk's channels, up to 64, two a
    lane) and the warps' stages fit the shared memory; as few ranges as
    fit; every output row from one channel as its row or its mirror."""
    smem = ohsetup.PRODUCTS_SMEM
    plan = ohsetup.products_ranges_plan(recipe, 2, K, N, threads, smem, itemsize)
    if plan is None:
        return
    n_ch = len(plan.chan)
    assert plan.n_chunks == -(-n_ch // ohsetup.RANGE_CHUNK)
    assert plan.stride % 2 == 1 and plan.stride >= min(n_ch, ohsetup.RANGE_CHUNK)
    assert plan.n_ranges * plan.span >= N > (plan.n_ranges - 1) * plan.span
    assert plan.n_ranges <= (ohsetup.PRODUCTS_MAX_RANGES_F64 if itemsize == 8
                             else ohsetup.PRODUCTS_MAX_RANGES)
    assert plan.block_smem <= smem
    stage = threads // 32 * (2 + K) * 33
    if plan.n_ranges > 1:  # one range fewer leaves a span that does not fit
        wider = -(-N // (plan.n_ranges - 1))
        assert (wider * plan.stride + stage) * itemsize > smem
    rows = [f for f, _ in plan.dest] + [m for _, m in plan.dest if m >= 0]
    assert sorted(rows) == list(range(ohsetup.recipe_width(recipe)))


def test_products_ranges_plan_at_ba_1m():
    """BA 1M's camera slot in f64: 63 channels (stride 63) in one chunk, 4
    ranges of 256 cameras, 33 blocks a range on 132 SMs; in f32 at 1024
    threads 2 ranges of 512."""
    plan = ohsetup.products_ranges_plan(BA_RECIPE, 2, 18, 1024,
                                        ohsetup.PRODUCTS_RANGE_THREADS_F64, ohsetup.PRODUCTS_SMEM)
    assert (len(plan.chan), plan.n_chunks, plan.stride, plan.span, plan.n_ranges) == \
        (63, 1, 63, 256, 4)
    assert ohsetup.products_ranges_grid(plan, 1_000_000, 512, SMS) == 33
    assert ohsetup.products_ranges_grid(plan, 100, 512, SMS) == 1
    plan32 = ohsetup.products_ranges_plan(BA_RECIPE, 2, 18, 1024, 1024, ohsetup.PRODUCTS_SMEM, 4)
    assert (plan32.span, plan32.n_ranges) == (512, 2)


@pytest.mark.parametrize("N,R,dtype,want", [
    (1024, 1_000_000, torch.float64, "oh_setup_products_f64"),
    (9000, 1_000_000, torch.float64, "oh_setup_products_f64"),
    (1024, 5_590, torch.float64, "oh_setup_products_f64"),       # 4 chunks
    (64, 32_768, torch.float64, "oh_setup_products_chunked_f64"),  # 2 chunks
    (64, 65_536, torch.float64, "oh_setup_products_f64"),
    (12_000, 1_000_000, torch.float64, "oh_setup_products_f64"),  # 42 ranges
    (13_000, 1_000_000, torch.float64, "oh_setup_products_atomics_f64"),
    (20_000, 1_000_000, torch.float64, "oh_setup_products_atomics_f64"),
    (1024, 1_000_000, torch.float32, "oh_setup_products"),
    (18_000, 1_000_000, torch.float32, "oh_setup_products"),
    (700, 12_784, torch.float32, "oh_setup_products_chunked"),
    (64, 65_536, torch.float32, "oh_setup_products_chunked"),
    (64, 131_072, torch.float32, "oh_setup_products"),
    (20_000, 1_000_000, torch.float32, "oh_setup_products"),
    (40_000, 1_000_000, torch.float32, "oh_setup_products_atomics")])
def test_products_route(N, R, dtype, want):
    """The channel-chunk kernel where its plan needs at most
    PRODUCTS_CHUNKED_MAX_CHUNKS chunks and R is below PRODUCTS_RANGE_MIN_R
    (f64: PRODUCTS_RANGE_MIN_R_F64); else the range kernel where
    products_ranges_plan has a plan of at most PRODUCTS_MAX_RANGES[_F64]
    ranges (f32 at PRODUCTS_RANGE_THREADS, f64 at
    PRODUCTS_RANGE_THREADS_F64); else the first body (in f64 its new
    instantiation, where the route raised NotImplementedError before)."""
    got = ohsetup.products_route(BA_RECIPE, 2, 18, N, dtype, R)
    assert got == want
    f64 = dtype == torch.float64
    chunks = ohsetup.products_plan(BA_RECIPE, 2, 18, N, ohsetup.PRODUCTS_THREADS_F64 if f64
                                   else ohsetup.PRODUCTS_THREADS, ohsetup.PRODUCTS_SMEM,
                                   8 if f64 else 4)
    if "chunked" in got:
        assert chunks.n_chunks <= ohsetup.PRODUCTS_CHUNKED_MAX_CHUNKS


@pytest.mark.parametrize("recipe,K", [(BA_RECIPE, 18), (OH_RECIPE, 24)])
@pytest.mark.parametrize("R,N", [(2348, 64), (5000, 3000), (777, 5)])
@pytest.mark.parametrize("share", [0.0, 0.5])
def test_oh_products_ranges_planned_matches_plain_and_oracle(recipe, K, R, N, share):
    """The range plan's sums (every range and chunk, mirrors) in f64
    against the plain version and the float64 oracle: no row left NaN."""
    rT, Jall, ids = oh_inputs(R, N)
    ids = hot_ids(ids, share)
    ids[:3] = [-1, N, N + 5]
    rT, Jall = rT.astype(np.float64), Jall[:K].astype(np.float64)
    args = (torch.from_numpy(rT), torch.from_numpy(Jall), torch.from_numpy(ids))
    out = ohsetup.oh_setup_products_ranges_planned(*args, N=N, recipe=recipe)
    assert out.dtype == torch.float64 and not torch.isnan(out).any()
    close(out, ohsetup.oh_setup_products_reference(*args, N=N, recipe=recipe), F64_TOL)
    close(out, oh_oracle(rT, Jall, ids, N, recipe), F64_TOL)


@pytest.mark.parametrize("R,N", [(2348, 64), (5000, 3000)])
def test_oh_products_ranges_planned_f32_matches_jax(R, N):
    """The range plan in f32 (PRODUCTS_RANGE_THREADS) against JAX's products kernel
    in interpret mode."""
    rT, Jall, ids = oh_inputs(R, N)
    ids = hot_ids(ids, 0.5)
    out = ohsetup.oh_setup_products_ranges_planned(
        torch.from_numpy(rT), torch.from_numpy(Jall), torch.from_numpy(ids), N=N,
        recipe=OH_RECIPE)
    ref = jax_oh_products(jnp.asarray(rT), jnp.asarray(Jall), jnp.asarray(ids), N=N,
                          recipe=OH_RECIPE, interpret=True)
    close(out, ref, JAX_EXACT_TOL)
    close(out, oh_oracle(rT, Jall, ids, N, OH_RECIPE), ORACLE_TOL)


@pytest.mark.parametrize("name", ["oh_setup_products_f64", "oh_setup_products_chunked_f64",
                                  "oh_setup_products_atomics_f64", "oh_setup_products",
                                  "oh_setup_products_chunked"])
def test_oh_products_bodies_on_cpu_take_the_plain_version(name):
    """On CPU tensors every products body returns the plain version and
    counts no launch."""
    rT, Jall, ids = oh_inputs(500, 40)
    dt = torch.float64 if name.endswith("_f64") else torch.float32
    args = (torch.from_numpy(rT).to(dt), torch.from_numpy(Jall).to(dt), torch.from_numpy(ids))
    fn = getattr(ohsetup, name)
    n0 = fn.launches
    out = fn(*args, N=40, recipe=OH_RECIPE)
    assert fn.launches == n0
    assert torch.equal(out, ohsetup.oh_setup_products_reference(*args, N=40, recipe=OH_RECIPE))
