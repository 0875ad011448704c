"""The variants v1, v2 and v3 of scripts/tpu_fused_variants.py in the
port, on the CPU: v1's plain version against make_v1 itself in TPU
interpret mode, v2's and v3's against the script's own per-program
arithmetic (`_common`, run on jnp arrays: make_v2 and make_v3 carry
scratch and revisited outputs that the interpret mode does not run),
the grid planning of their cluster kernel (csrc/fused_pair_cluster.cu),
and which kernel each variant takes at which shape.  The kernels
themselves are held against the plain versions on the card in
test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from thallo_tpu_torch.ops import fusedpair  # noqa: E402
from tests.torch_cases import (CI, CJ, FUSED_SHAPES, ORACLE_TOL, bf16_round, close,  # noqa: E402
                               fused_inputs, fused_oracle)

# the script rounds pcol and z to bf16 for the TPU's matrix unit (2^-8
# relative per term); the port keeps them in f32
JAX_BF16_TOL = 1e-2
VARIANTS = ["fused_pair_v2_smem", "fused_pair_v3_partials"]
# a program's elements: several programs, the last one ragged
N_BLK = 256
# FUSED_SHAPES (ragged N, out-of-range and negative ids) and a W = 8
# level like the script's skew_level_w8
SCRIPT_SHAPES = FUSED_SHAPES + [(8, 600, 256)]


def _load_script(name):
    """A measurement script of the JAX package, imported by path (its
    main() runs only as __main__)."""
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_variant(name, ids, blocks, pcol, prow, S):
    """(rows, cols) as the script's kernel computes them: its per-program
    body `_common` on each N_BLK slice of N, the rows side by side, the
    cols summed in program order (make_v2's scratch accumulator) or
    stacked and summed with jnp.sum(., 0) (make_v3, tpu_fused_variants.py:149)."""
    script = _load_script("tpu_fused_variants")
    W, N = ids.shape
    rows, cols = [], []
    for k in range(0, N, N_BLK):
        r, c = script._common(jnp.asarray(ids[:, k:k + N_BLK]),
                              jnp.asarray(blocks[:, k:k + N_BLK], jnp.bfloat16),
                              jnp.asarray(pcol), jnp.asarray(prow[:, k:k + N_BLK]), CI, CJ, W, S)
        rows.append(r)
        cols.append(c)
    if name == "fused_pair_v2_smem":
        acc = jnp.zeros((CJ, S), jnp.float32)
        for c in cols:
            acc = acc + c
    else:
        acc = jnp.sum(jnp.stack(cols), axis=0)
    return jnp.concatenate(rows, axis=1), acc


def _torch(*arrays):
    ids, blocks, pcol, prow = arrays
    return (torch.from_numpy(ids), torch.from_numpy(blocks).bfloat16(), torch.from_numpy(pcol),
            torch.from_numpy(prow))


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("W,N,S", SCRIPT_SHAPES)
def test_variant_plain_matches_jax_script(name, W, N, S):
    """The port's plain version of each variant against the script's
    arithmetic on the same bf16 blocks: JAX_BF16_TOL."""
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    blocks = bf16_round(blocks)
    rows, cols = getattr(fusedpair, name)(*_torch(ids, blocks, pcol, prow), Ci=CI, Cj=CJ, S=S)
    jr, jc = _script_variant(name, ids, blocks, pcol, prow, S)
    close(rows, jr, JAX_BF16_TOL)
    close(cols, jc, JAX_BF16_TOL)


@pytest.mark.parametrize("W,N,S", SCRIPT_SHAPES)
def test_v1_plain_matches_jax_script(W, N, S):
    """fused_pair_v1_rows's plain version against the script's make_v1,
    its Pallas kernel run in TPU interpret mode (programs of N_BLK
    elements, the last one ragged) on the same bf16 blocks: JAX_BF16_TOL;
    make_v1's cols output is zeros."""
    from jax.experimental.pallas import tpu as pltpu

    script = _load_script("tpu_fused_variants")
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    blocks = bf16_round(blocks)
    rows = fusedpair.fused_pair_v1_rows(*_torch(ids, blocks, pcol, prow), Ci=CI, Cj=CJ, S=S)
    with pltpu.force_tpu_interpret_mode():
        jr, jc = script.make_v1(CI, CJ, W, S, N_BLK)(
            jnp.asarray(ids), jnp.asarray(blocks, jnp.bfloat16), jnp.asarray(pcol),
            jnp.asarray(prow))
    close(rows, np.asarray(jr), JAX_BF16_TOL)
    assert not np.asarray(jc).any()


@pytest.mark.parametrize("name", ["fused_pair_v2_smem_generic", "fused_pair_v3_partials_generic",
                                  "fused_pair_cluster_noflush", "fused_pair_v1_rows_generic"])
@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_variant_other_wrappers_plain_match_oracle(name, W, N, S):
    """The first bodies' wrappers and the cluster kernel's measurement
    wrapper (rows only) on the CPU: the oracle on the same bf16 values."""
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    blocks = bf16_round(blocks)
    out = getattr(fusedpair, name)(*_torch(ids, blocks, pcol, prow), Ci=CI, Cj=CJ, S=S)
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    if name in ("fused_pair_cluster_noflush", "fused_pair_v1_rows_generic"):
        close(out, r_ref, ORACLE_TOL)
        return
    close(out[0], r_ref, ORACLE_TOL)
    close(out[1], c_ref, ORACLE_TOL)


@pytest.mark.parametrize("N,elems,threads,C,max_clusters,grid,n_slabs", [
    (250_000, 2, 512, 8, 33, 248, 31),   # the uniform shape: 245 tiles fill 31 clusters
    (250_000, 2, 512, 8, 16, 128, 16),   # fewer clusters fit the card than the tiles fill
    (250_000, 2, 256, 4, 13, 52, 13),    # 13 clusters, not a divisor of the 489 tiles
    (250_000, 1, 512, 2, 1000, 490, 245),
    (1001, 1, 512, 8, 33, 8, 1),         # (3, 1001, 500): 2 tiles, fewer than one cluster
    (100, 1, 256, 16, 5, 16, 1),         # one tile
    (0, 2, 512, 4, 9, 4, 1),             # no elements: one cluster of zeros
])
def test_cluster_plan(N, elems, threads, C, max_clusters, grid, n_slabs):
    """The grid is a multiple of C, holds no more clusters than the card
    allows or the tiles fill (at least one), and v3 writes one slab per
    cluster."""
    got = fusedpair.cluster_plan(N, elems, threads, C, max_clusters)
    assert got == (grid, n_slabs)
    tiles = -(-N // (threads * elems))
    assert grid % C == 0 and n_slabs == grid // C
    assert 1 <= n_slabs <= max(1, min(max_clusters, -(-tiles // C)))


@pytest.mark.parametrize("args", [(1000, 0, 512, 8, 4), (1000, 1, 512, 0, 4),
                                  (1000, 1, 512, 8, 0), (-1, 1, 512, 8, 4)])
def test_cluster_plan_refuses(args):
    with pytest.raises(ValueError, match="cluster_plan"):
        fusedpair.cluster_plan(*args)


@pytest.mark.parametrize("N,elems,aim_blocks,threads", [
    (250_000, 2, 264, fusedpair.CLUSTER_THREADS),  # the uniform shape: 245 block tiles
    (70_845, 1, 264, fusedpair.CLUSTER_THREADS),   # 139 block tiles, over half the aim
    (16_384, 2, 264, 64),   # the script's skew_level_w8: 16 block tiles -> 128 of 2 warps
    (16_384, 1, 128, 128),  # 16384 elements over 128 blocks: 4 warps each
    (325, 1, 264, 64),      # a level of 11 warp tiles: the smallest block
])
def test_cluster_threads(N, elems, aim_blocks, threads):
    """CLUSTER_THREADS wherever its tiles give at least half the aimed
    blocks work; fewer warps a block for short levels."""
    got = fusedpair.cluster_threads(N, elems, aim_blocks)
    assert got == threads
    assert got % 32 == 0 and 64 <= got <= fusedpair.CLUSTER_THREADS


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("Ci,Cj,S,suffix", [
    (3, 9, 1024, ""), (3, 9, 256, ""), (3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36, ""),
    (2, 5, 300, "_generic"), (8, 16, 1024, "_generic"), (4, 3, 64, "_generic"),
    (3, 3, 64, "_generic")])
def test_variant_route(name, Ci, Cj, S, suffix):
    """The cluster kernel for the pairs the persistent kernels take with
    their accumulator in shared memory; the first body for other pairs."""
    assert fusedpair.variant_route(name, Ci, Cj, S) == name + suffix


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("Ci,Cj,S", [(3, 9, fusedpair.PERSISTENT_MAX_SMEM // 36 + 1),
                                     (8, 16, 2000), (9, 9, 64), (3, 17, 64)])
def test_variant_route_refuses(name, Ci, Cj, S):
    """A shape neither kernel takes raises: nothing falls back."""
    with pytest.raises(ValueError, match="no kernel"):
        fusedpair.variant_route(name, Ci, Cj, S)


@pytest.mark.parametrize("Ci,Cj,S,suffix", [
    (3, 9, 1024, ""), (3, 9, 1, ""), (3, 9, 50_000, ""),  # any S: pcol in shared memory or not
    (2, 5, 300, "_generic"), (8, 16, 50_000, "_generic"), (3, 3, 64, "_generic")])
def test_variant_route_v1(Ci, Cj, S, suffix):
    """v1: the rows kernel for the 3 x 9 pair at any S (it needs no
    accumulator); its first body for the other pairs up to 8 x 16."""
    assert fusedpair.variant_route("fused_pair_v1_rows", Ci, Cj, S) == "fused_pair_v1_rows" + suffix


@pytest.mark.parametrize("Ci,Cj,S", [(9, 9, 64), (3, 17, 64), (3, 9, 0), (0, 9, 64)])
def test_variant_route_v1_refuses(Ci, Cj, S):
    with pytest.raises(ValueError, match="no kernel"):
        fusedpair.variant_route("fused_pair_v1_rows", Ci, Cj, S)


@pytest.mark.parametrize("N,elems", [
    (250_000, 2), (1000, 2), (1002, 2), (2, 2), (70_845, 1), (4097, 1), (777, 1), (3, 1),
    (1, 1), (0, 2)])
def test_v1_elems(N, elems):
    """Two elements a thread where every block plane starts 4-byte aligned
    (N even), else one."""
    assert fusedpair.v1_elems(N) == elems


def test_variant_route_unknown_name():
    with pytest.raises(ValueError, match="unknown variant"):
        fusedpair.variant_route("fused_pair_v4", 3, 9, 1024)


def test_variant_wrappers_on_cpu_take_the_plain_version():
    """On CPU tensors no wrapper counts a launch, whatever the shape."""
    names = (list(VARIANTS) + [n + "_generic" for n in VARIANTS]
             + ["fused_pair_cluster_noflush", "fused_pair_v1_rows", "fused_pair_v1_rows_generic"])
    n0 = [getattr(fusedpair, n).launches for n in names]
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, (2, 300)).astype(np.int32)
    args = _torch(ids, rng.normal(size=(2 * 27, 300)).astype(np.float32),
                  rng.normal(size=(9, 64)).astype(np.float32),
                  rng.normal(size=(3, 300)).astype(np.float32))
    for n in names:
        getattr(fusedpair, n)(*args, Ci=CI, Cj=CJ, S=64)
    assert [getattr(fusedpair, n).launches for n in names] == n0
