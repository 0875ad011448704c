"""Shared inputs and float64 oracles for the thallo_tpu_torch kernel
tests (numpy only: imported by the CPU parity tests, which also import
JAX, and by the card-side tests, which must not)."""
import numpy as np

# plain f32 version vs the float64 oracle: only f32 rounding differs
ORACLE_TOL = 1e-5
CI, CJ = 3, 9  # BA: point x camera


def close(got, ref, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# inputs (numpy, seeded) and float64 oracles
# ---------------------------------------------------------------------------
def fused_inputs(W, N, S, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, (W, N)).astype(np.int32)
    ids[:, -7:] = S + 3  # out-of-range tail drops
    ids[0, :5] = -1
    blocks = rng.normal(size=(W * CI * CJ, N)).astype(np.float32)
    pcol = rng.normal(size=(CJ, S)).astype(np.float32)
    prow = rng.normal(size=(CI, N)).astype(np.float32)
    return ids, blocks, pcol, prow


def hot_ids(ids, share, hot=5, seed=11):
    """ids with `share` of the entries (chosen by a seeded draw) set to one
    id, `hot`: a hot camera."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(ids.shape) < share, hot, ids).astype(np.int32)


def bf16_round(a):
    """f32 values rounded to bf16 (nearest even), kept as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def fused_oracle(ids, blocks, pcol, prow, S):
    W, N = ids.shape
    b = blocks.astype(np.float64).reshape(W, CI, CJ, N)
    ok = (ids >= 0) & (ids < S)
    idx = np.where(ok, ids, 0)
    pc = pcol.astype(np.float64)[:, idx] * ok  # [Cj, W, N]
    rows = np.einsum("wijn,jwn->in", b, pc)
    z = np.einsum("wijn,in->wjn", b, prow.astype(np.float64)) * ok[:, None, :]
    cols = np.zeros((CJ, S))
    for cj in range(CJ):
        np.add.at(cols[cj], idx.ravel(), z[:, cj, :].ravel())
    return rows, cols


# camera side of BA (K=18: one 9-channel slot) plus a cross pair into a
# 3-channel slot, so both operand offsets are exercised
OH_RECIPE = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9), ("pair", 0, 9, 18, 3))


def oh_inputs(R, N, rc=2, seed=1):
    rng = np.random.default_rng(seed)
    rT = (rng.normal(size=(rc, R)) * 10).astype(np.float32)
    Jall = rng.normal(size=(rc * 9 + rc * 3, R)).astype(np.float32)
    ids = rng.integers(0, N, R).astype(np.int32)
    ids[:3] = N + 7
    ids[3] = -2
    return rT, Jall, ids


def oh_oracle(rT, Jall, ids, N, recipe):
    rc, R = rT.shape
    r64, J64 = rT.astype(np.float64), Jall.astype(np.float64)
    slabs = []
    for ent in recipe:
        if ent[0] in ("jtr", "d2"):
            _, off, C = ent
            J = J64[off:off + rc * C].reshape(rc, C, R)
            slabs.append((J * r64[:, None]).sum(0) if ent[0] == "jtr" else (J * J).sum(0))
        else:
            _, oa, Ca, ob, Cb = ent
            Ja = J64[oa:oa + rc * Ca].reshape(rc, Ca, R)
            Jb = J64[ob:ob + rc * Cb].reshape(rc, Cb, R)
            slabs.append(np.einsum("kar,kbr->abr", Ja, Jb).reshape(Ca * Cb, R))
    x = np.concatenate(slabs)
    out = np.zeros((x.shape[0], N))
    ok = (ids >= 0) & (ids < N)
    for f in range(x.shape[0]):
        np.add.at(out[f], ids[ok], x[f, ok])
    return out


# point side of BA: slot list [points (3), cameras (9)], Kall = 24
FR_RECIPE = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 6, 9, 0), ("diag", 0, 3, 0, 3))


# a second cross pair (points x a 2-channel slot at row 24) and that
# slot's own jtr: two cross outputs, numbered 0 and 1
FR_RECIPE2 = FR_RECIPE + (("cross", 0, 3, 24, 2, 1), ("jtr", 24, 2))


def fr_inputs(N_t, W, rc=2, seed=2, extra=0):
    """rT and Jall of a full-repeat level: the point (3) and camera (9)
    slots, and `extra` channels of a further slot."""
    rng = np.random.default_rng(seed)
    R = N_t * W
    rT = (rng.normal(size=(rc, R)) * 10).astype(np.float32)
    Jall = rng.normal(size=(rc * (3 + 9 + extra), R)).astype(np.float32)
    return rT, Jall


def fr_oracle(rT, Jall, N_t, W):
    rc = rT.shape[0]
    r = rT.astype(np.float64).reshape(rc, N_t, W)
    Jp = Jall[:rc * 3].astype(np.float64).reshape(rc, 3, N_t, W)
    Jc = Jall[rc * 3:].astype(np.float64).reshape(rc, 9, N_t, W)
    jtr = (Jp * r[:, None]).sum((0, 3))
    d2 = (Jp ** 2).sum((0, 3))
    diag = np.einsum("kanw,kbnw->abn", Jp, Jp).reshape(9, N_t)
    cross = np.einsum("kanw,kbnw->wabn", Jp, Jc).reshape(W * 27, N_t)
    return np.concatenate([jtr, d2, diag]), cross


FUSED_SHAPES = [(4, 1000, 64), (3, 777, 500)]  # (W, N, S): ragged N; S > 256
# wide levels (W > 8: JAX's _kernel_wloop, the port's W-loop kernel); the
# last one's [Cj, S] accumulator does not fit the shared memory at once
WLOOP_SHAPES = [(12, 2000, 64), (24, 333, 300), (40, 100, 5000)]
OH_SHAPES = [(777, 96), (2348, 64)]            # (R, N)
FR_SHAPES = [(500, 4), (130, 3)]               # (N_t, W)


# small-image aggregation (oh_setup_aggregate): F channels of per-row
# parts summed by id; a tail of out-of-range ids drops
AGG_F = 13
AGG_SHAPES = [(700, 64), (700, 300), (6161, 64), (6161, 300)]  # (R, N)


def agg_inputs(R, N, seed=4, F=AGG_F):
    rng = np.random.default_rng(seed)
    parts = (rng.normal(size=(F, R)) * 100).astype(np.float32)
    ids = rng.integers(0, N, R).astype(np.int32)
    ids[-5:] = N + 2
    ids[0] = -1
    return parts, ids


def agg_oracle(parts, ids, N):
    out = np.zeros((parts.shape[0], N))
    ok = (ids >= 0) & (ids < N)
    for f in range(parts.shape[0]):
        np.add.at(out[f], ids[ok], parts[f, ok].astype(np.float64))
    return out


# destination-tiled segment sum: (M rows, S segments, C channels); the
# last shape has more tiles than rows (mostly padded lanes)
SEG_SHAPES = [(1000, 257, 3), (5000, 64, 9), (128, 4096, 3)]


def seg_inputs(M, S, C, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, M).astype(np.int32)
    data = rng.normal(size=(M, C)).astype(np.float32)
    return data, ids


def seg_oracle(data, ids, S):
    out = np.zeros((S, data.shape[1]))
    np.add.at(out, ids, data.astype(np.float64))
    return out


# maps for the compact plan form: (name, ids, S).  "empty": every third
# segment has no row and the last 40 none either; "skew": one segment
# owns half the rows (a hot camera), the rest spread with a long tail;
# "tail": runs of ~3 rows with one of 400 (a point seen by many cameras);
# "cams": 200 segments of ~150 scattered rows over 15 chunks of data rows
# (with "uniform1" the maps that also get the staged form)
def seg_maps():
    rng = np.random.default_rng(9)
    maps = [(f"uniform{k}", seg_inputs(M, S, C)[1], S) for k, (M, S, C) in enumerate(SEG_SHAPES)]
    ids = rng.integers(0, 100, 2000) * 3
    maps.append(("empty", ids.astype(np.int32), 340))
    hot = np.where(rng.random(12000) < 0.5, 17, rng.zipf(1.5, 12000) % 96)
    maps.append(("skew", hot.astype(np.int32), 96))
    tail = np.concatenate([np.repeat(np.arange(600), 3), np.full(400, 77)])
    maps.append(("tail", rng.permutation(tail).astype(np.int32), 600))
    maps.append(("cams", rng.integers(0, 200, 30000).astype(np.int32), 200))
    return maps
