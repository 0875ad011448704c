"""The redesigned kernels on the card, beside what they replaced, and the
sweeps behind their constants.

    python3 scripts/torch_redesign_sweep.py [--n 20] [--sweep] [--only GROUP ...] [--out FILE]

Groups (all by default):
  pairs   fused pair (f32 blocks, 3 x 9, S 1024) at the uniform 1M BA
          shape (W 4, N 250 000, random ids) and at the skewed 1M scene's
          real level-0 and level-1 col tables:
            persistent     fused_pair_apply (the persistent kernel)
            atomics        fused_pair_apply_atomics_thread (the first atomics body:
                           a global atomic per cols value)
            atomics_slots  fused_pair_apply_atomics (the slots kernel)
            wloop          fused_pair_apply_wloop
            rows_floor     the persistent kernel without its cols side
          --sweep: the persistent kernel over THREADS x BLOCKS_PER_SM and
          MERGE_MIN (33 = never merge).
  wloop   the skewed 1M scene's five real levels, (2, 250000) to
          (716, 325), and narrow levels of fewer elements (random ids):
          persistent, wloop and wloop_chunked (the first W-loop body); the
          numbers behind fused_pair_route.  --sweep: the W-loop kernel over
          WLOOP_THREADS x WLOOP_BLOCKS_PER_SM and WLOOP_MIN_ITEM.
  oh      oh_setup_products at BA-1M (R 1 000 000, N 1024, random ids) and
          at the skewed scene's camera ids (sorted residual order, one
          camera with half the rows), recipe jtr 9 + d2 9 + pair 9 x 9:
          the range kernel (the route's), the channel-chunk kernel it
          replaced (oh_setup_products_chunked) and
          oh_setup_products_atomics (the first body).  --sweep: the
          channel-chunk kernel over PRODUCTS_THREADS x PRODUCTS_SMEM (the
          channel chunks) x PRODUCTS_BLOCKS_PER_SM.
  segsum  segment sum, on maps with the 1M scenes' statistics (points:
          250 000 segments of 4 sorted rows, 3 channels; cameras: 1024
          segments of ~977 scattered rows, 9 channels; the skewed scene's
          real oToC), data channel-major transposed (as the solver passes
          it) and row-major: segment_sum against torch.zeros(...).index_add_.
          --sweep: the sorted runs alone over TARGET_PIECES, and the first
          staged body over its chunk (the ring kernel where it fits), on the
          skewed map too (which
          staged_eligible refuses: a thread sums the hot camera's share of
          a chunk alone).
  staged  the staged segment sum at the camera map (1024 segments of ~977
          scattered rows, 9 channels, channel-major transposed data), in
          f32 and f64: the ring kernel (segment_sum's route), the first
          staged body (segment_sum_per_chunk[_f64]) on the same plan and on a
          plan of its own chunk (PER_CHUNK_ROWS), and index_add_; each
          twice, bit for bit.
  slots   the atomics route of the fused pair at the shape of ARAP 256²'s
          (3, 3) col levels (each vertex's four grid neighbours, in grid
          order and shuffled), in f32 and f64, and at the other shapes the
          route takes (random ids): the slots kernel
          (fused_pair_apply_atomics[_f64]) and the first body
          (fused_pair_apply_atomics_thread[_f64]).
  bf16_slots  the atomics route on bf16 blocks (block_dtype="bf16") at
          ARAP 256²'s (3, 3) col levels (grid order and shuffled), W = 12,
          N = S = 16 384 at (9, 3) and (16, 3) (chip_smoke.py's BF16_WIDE)
          and embedded deformation's (9, 3) [4, 1 600]: the bf16 slots
          kernel (fused_pair_apply_atomics_bf16) at the slot lanes
          bf16_slot_lanes picks and at P = 1, 2, 4 and 8, the first bf16
          body (fused_pair_bf16_atomics) and the f32 slots kernel on the
          same values as f32 blocks; the measurements behind
          BF16_SLOT_FILL and the bf16 route.
  fullrepeat  fullrepeat_setup at the uniform 1M scene's point level (N_t
          250 000, W 4, rc 2, Kall 24; the solver's recipe: jtr 3, d2 3,
          the 3 x 9 cross pair, the 3 x 3 diag pair): the tile kernel
          (tiles) and fullrepeat_setup_thread (the first body); then the
          point level of synthetic_inputs(1024, 100000, 10) (N_t 100 000,
          W 10, the same recipe), in f32 and f64: the wide kernel (wide,
          wide_f64) and the first body (thread, thread_f64), and the plain
          version (plain, plain_f64).  --sweep: the tile kernel over
          FULLREPEAT_TILE x FULLREPEAT_BLOCKS_PER_SM and FULLREPEAT_THREADS;
          the wide kernel at W = 10 in both dtypes over WIDE_MAX_CONFLICT
          (0: an odd pitch, scalar copies; 2: pitch W, 16-byte copies and
          pair reads) x (WIDE_TILE, WIDE_BLOCKS_PER_SM, WIDE_MAX_STAGES) x
          WIDE_THREADS (f64: WIDE_THREADS_F64).
  aggregate  oh_setup_aggregate at the PRECOMPUTE_J camera scatter,
          [9, 1 000 000] by random ids into 1024, and at the skewed
          scene's camera ids (one camera with half the rows): the
          shared-memory kernel, the first body (oh_setup_aggregate_atomics)
          and torch.zeros(...).index_add_.  --sweep: the shared-memory
          kernel over AGG_THREADS x AGG_BLOCKS_PER_SM and AGG_MERGE_MIN.
  bf16    the fused pair on bf16 blocks (block_dtype="bf16") at the uniform
          1M BA shape (W 4, N 250 000, random ids) and at the skewed 1M
          scene's five real levels: the bf16 instantiation of the kernel
          fused_pair_route names (the persistent one at BF16_ELEMS 1 and 2:
          one bf16 or one bf16 pair per thread and block row, and without
          its cols side, rows_floor_bf16; the W-loop one),
          fused_pair_bf16_atomics (the first bf16 body), and the f32 route
          kernel on the same values.  --sweep: the bf16 persistent kernel
          over THREADS x BLOCKS_PER_SM (at most 512 threads: the
          two-element form's bound) and MERGE_MIN, the bf16 W-loop kernel
          over WLOOP_THREADS x WLOOP_BLOCKS_PER_SM.
  variants  the variants v2 and v3 of scripts/tpu_fused_variants.py on bf16
          blocks at the uniform 1M BA shape (W 4, N 250 000, S 1024,
          random ids): the cluster kernel (v2_smem: a global atomic per
          nonzero entry per cluster; v3_partials: a slab per cluster,
          summed by torch.sum; noflush: nothing leaves the cluster), their
          first bodies (the _generic routes) and the micro's pair
          (fused_pair_bf16, a global atomic flush per block), each line
          with the cluster kernel's grid and its
          cudaOccupancyMaxActiveClusters.  --sweep: the cluster kernel over
          CLUSTER_SIZE (C 2, 4, 8, and 16 where the card grants non-portable
          clusters) x CLUSTER_THREADS x CLUSTER_BLOCKS_PER_SM.
  v1      the variant v1 of scripts/tpu_fused_variants.py (make_v1, rows
          only) on bf16 blocks at the uniform 1M BA shape (W 4, N 250 000,
          S 1024, random ids) and the skewed 1M scene's level-0 table: the
          rows kernel (fused_pair_v1_rows, csrc/fused_pair_rows.cu), its
          first body (fused_pair_v1_rows_generic) and the bf16 persistent
          kernel without its cols side (rows_floor_bf16, the design it
          started from).  --sweep: the rows kernel over (V1_THREADS,
          V1_BLOCKS_PER_SM).
  wloop_f64  the W-loop pair on bf16 blocks with f64 values
          (block_dtype="bf16" under double_precision) at phase 28(a)'s
          point level, (10, 100 000), S 1024 (random ids), and at the
          skewed 1M scene's wide levels: the w-lane kernel
          (fused_pair_apply_wloop_bf16_f64) and the first <bf16, double>
          body it replaced (fused_pair_apply_wloop_bf16_f64_gathered, on no
          route), each line with the level's route, and beside them the
          f64 and f32 W-loop pairs at the same shape.  --sweep: the w-lane
          kernel without its cols side (probe_nocols) and over (elems,
          w_item).  These probes launch a scratch build
          of csrc/fused_pair_wloop.cu (build/thallo_tpu_torch/probe/) that
          exports the kernel at any plan, its cols side on or compiled
          out; the port's library exports the route's instantiation only.
  oh_f64  oh_setup_products in f64 at BA-1M (R 1 000 000, N 1024, random
          ids) and at the skewed scene's camera ids: the range kernel
          (oh_setup_products_f64, the route's), the f64 channel chunks it
          replaced (oh_setup_products_chunked_f64) and the f64 first body
          (oh_setup_products_atomics_f64); in f32 the range kernel
          (oh_setup_products) beside the channel chunks it replaced
          (oh_setup_products_chunked).  --sweep: the range kernel over its
          threads (OH_F64_THREADS in f64, 512 in f32); then, in both
          dtypes, the range kernel (at its plan, up to OH_SCAN_MAX_RANGES
          ranges) beside the chunk kernel and, from 6 144 cameras, the
          first body over camera counts N (R 1 000 000, random ids), and
          the range and chunk kernels over observation counts R (5 590 to
          262 144, N 1024 and 64): the data behind products_route's
          PRODUCTS_MAX_RANGES[_F64], PRODUCTS_RANGE_MIN_R[_F64] and
          PRODUCTS_CHUNKED_MAX_CHUNKS (each line with its n_ranges, the
          chunk plan's n_chunks and the route).
One JSON line per timing: ms per call over n calls eager and in one CUDA
graph (CUDA events; a replayed graph finds everything below 50 MB warm
in L2), and the error against the plain torch version.  Needs CUDA.
"""
import argparse
import ctypes
import functools
import subprocess
import sys

import numpy as np
import torch

from torch_measure import (SKEW_1M, card, emit, kept, max_rel_err, pair_operands, per_launch_ms,
                           random_ids, skew_camera_ids, skew_tables)

PAIR_KERNELS = [("persistent", "fused_pair_apply"), ("atomics", "fused_pair_apply_atomics_thread"),
                ("atomics_slots", "fused_pair_apply_atomics"),
                ("wloop", "fused_pair_apply_wloop"), ("rows_floor", "fused_pair_rows_floor")]
WLOOP_KERNELS = [("persistent", "fused_pair_apply"), ("wloop", "fused_pair_apply_wloop"),
                 ("wloop_chunked", "fused_pair_apply_wloop_chunked")]
PAIR_SWEEP = [((256, 1), (256, 2), (256, 3), (256, 4), (256, 5), (256, 6), (256, 8),
               (128, 4), (128, 8), (128, 12), (512, 1), (512, 2), (512, 3), (512, 4),
               (1024, 1), (1024, 2)),  # (THREADS, BLOCKS_PER_SM)
              (2, 4, 33)]  # MERGE_MIN
PIECES_SWEEP = (1024, 2048, 4096, 8192, 16384, 32768)
STAGED_ROWS_SWEEP = (1024, 1536, 2048, 3072, 4096)
WLOOP_SWEEP = (((256, 2), (256, 4), (512, 1), (512, 2), (1024, 1)),  # (THREADS, BLOCKS_PER_SM)
               (1, 4, 8, 16, 32))  # WLOOP_MIN_ITEM
# narrow levels of fewer elements than the 1M scene's (W, N), random ids:
# where the persistent kernel's one thread per element stops filling the card
ROUTE_SHAPES = ((8, 16384), (8, 4096), (8, 1400), (4, 62500), (4, 8192), (2, 32768))
# (PRODUCTS_THREADS, PRODUCTS_SMEM, PRODUCTS_BLOCKS_PER_SM)
OH_SWEEP = ((128, 56 * 1024, 4), (256, 75 * 1024, 3), (256, 112 * 1024, 2),
            (512, 112 * 1024, 2), (256, 224 * 1024, 1), (512, 224 * 1024, 1),
            (1024, 224 * 1024, 1))
OH_RECIPE = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))
FR_RECIPE = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 6, 9, 0), ("diag", 0, 3, 0, 3))
# (FULLREPEAT_TILE, FULLREPEAT_BLOCKS_PER_SM), then FULLREPEAT_THREADS
FR_SWEEP = (((32, 4), (64, 2), (64, 3), (64, 4), (96, 2), (128, 1), (128, 2), (256, 1)),
            (128, 256))
# the wide kernel's shape: the point level of synthetic_inputs(1024, 100000, 10)
FR_WIDE = (100_000, 10)  # (N_t, W)
# WIDE_MAX_CONFLICT, (WIDE_TILE, WIDE_BLOCKS_PER_SM, WIDE_MAX_STAGES), WIDE_THREADS[_F64]
FR_WIDE_SWEEP = ((0, 2),
                 ((32, 1, 1), (32, 1, 2), (32, 2, 1), (32, 2, 2), (32, 3, 1), (32, 3, 2),
                  (32, 4, 1), (64, 1, 2), (64, 4, 2)),
                 (256, 512, 768, 1024))
# (THREADS or WLOOP_THREADS, BLOCKS_PER_SM or WLOOP_BLOCKS_PER_SM) of the
# bf16 kernels
BF16_SWEEP = ((256, 2), (256, 4), (512, 1), (512, 2), (512, 3))
# (CLUSTER_SIZE, CLUSTER_THREADS, CLUSTER_BLOCKS_PER_SM) of the cluster kernel
CLUSTER_SWEEP = tuple((c, t, b) for c in (2, 4, 8, 16) for t in (256, 512) for b in (1, 2, 3))
VARIANT_KERNELS = [("v2_smem", "fused_pair_v2_smem"), ("v3_partials", "fused_pair_v3_partials"),
                   ("noflush", "fused_pair_cluster_noflush"),
                   ("v2_smem_generic", "fused_pair_v2_smem_generic"),
                   ("v3_partials_generic", "fused_pair_v3_partials_generic"),
                   ("v0_bf16", "fused_pair_bf16")]
CLUSTER_MODES = {"v2_smem": 1, "v3_partials": 2, "noflush": 0}  # fusedpair._FLUSH_*
# (V1_THREADS, V1_BLOCKS_PER_SM; 0: one tile a block)
V1_SWEEP = ((128, 0), (256, 0), (512, 0), (256, 2), (512, 2), (1024, 1))
# (AGG_THREADS, AGG_BLOCKS_PER_SM), then AGG_MERGE_MIN (33: never merge)
AGG_SWEEP = (((256, 4), (512, 2), (512, 4), (1024, 1), (1024, 2)), (4, 8, 33))


def f32_operands(rng, ids, Ci, Cj, S):
    W, N = ids.shape

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()

    return ids, t(W * Ci * Cj, N), t(Cj, S), t(Ci, N)


def sweep_pairs(args, smi, out):
    from thallo_tpu_torch.ops import fusedpair

    rng = np.random.default_rng(0)
    cases = [("ba_1m_pt_cam", random_ids(rng, 4, 250_000, 1024))] + skew_tables((0, 1))
    kw = dict(Ci=3, Cj=9, S=1024)
    for name, ids in cases:
        ops = f32_operands(rng, ids, **kw)
        ref = fusedpair.fused_pair_apply_reference(*ops, **kw)

        def timed(kernel, fname, **extra):
            fn = getattr(fusedpair, fname)
            got = fn(*ops, **kw)
            err = max_rel_err((got,), ref[:1]) if kernel == "rows_floor" else max_rel_err(got, ref)
            eager, graph = per_launch_ms(lambda: fn(*ops, **kw), args.n)
            emit({"name": name, "kernel": kernel, "W": ids.shape[0], "N": ids.shape[1],
                  "eager_ms": eager, "graph_ms": graph, "rel_err": err, "card": smi, **extra},
                 out)

        for kernel, fname in PAIR_KERNELS:
            timed(kernel, fname)
        if not args.sweep:
            continue
        with kept(fusedpair, "THREADS", "BLOCKS_PER_SM"):
            for fusedpair.THREADS, fusedpair.BLOCKS_PER_SM in PAIR_SWEEP[0]:
                swept = dict(THREADS=fusedpair.THREADS, BLOCKS_PER_SM=fusedpair.BLOCKS_PER_SM)
                timed("persistent", "fused_pair_apply", **swept)
                timed("rows_floor", "fused_pair_rows_floor", **swept)
        with kept(fusedpair, "MERGE_MIN"):
            for fusedpair.MERGE_MIN in PAIR_SWEEP[1]:
                timed("persistent", "fused_pair_apply", MERGE_MIN=fusedpair.MERGE_MIN)


def sweep_wloop(args, smi, out):
    from thallo_tpu_torch.ops import _cuda, fusedpair

    rng = np.random.default_rng(2)
    kw = dict(Ci=3, Cj=9, S=1024)
    sms = _cuda.sm_count(torch.device("cuda"))
    cases = skew_tables(None) + [(f"random_w{W}_n{N}", random_ids(rng, W, N, kw["S"]))
                                 for W, N in ROUTE_SHAPES]
    for name, ids in cases:
        W, N = ids.shape
        ops = f32_operands(rng, ids, **kw)
        ref = fusedpair.fused_pair_apply_reference(*ops, **kw)

        def timed(kernel, fname, **extra):
            fn = getattr(fusedpair, fname)
            err = max_rel_err(fn(*ops, **kw), ref)
            eager, graph = per_launch_ms(lambda: fn(*ops, **kw), args.n)
            if kernel == "wloop":
                extra["w_item"], extra["grid"] = fusedpair.wloop_plan(W, N, kw["S"], sms)
            emit({"name": name, "kernel": kernel, "W": W, "N": N, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": err, "card": smi,
                  "route": fusedpair.fused_pair_route(W, N, **kw), **extra}, out)

        for kernel, fname in WLOOP_KERNELS:
            timed(kernel, fname)
        if not args.sweep or name.startswith("random"):
            continue
        with kept(fusedpair, "WLOOP_THREADS", "WLOOP_BLOCKS_PER_SM"):
            for fusedpair.WLOOP_THREADS, fusedpair.WLOOP_BLOCKS_PER_SM in WLOOP_SWEEP[0]:
                timed("wloop", "fused_pair_apply_wloop", WLOOP_THREADS=fusedpair.WLOOP_THREADS,
                      WLOOP_BLOCKS_PER_SM=fusedpair.WLOOP_BLOCKS_PER_SM)
        with kept(fusedpair, "WLOOP_MIN_ITEM"):
            for fusedpair.WLOOP_MIN_ITEM in WLOOP_SWEEP[1]:
                timed("wloop", "fused_pair_apply_wloop", WLOOP_MIN_ITEM=fusedpair.WLOOP_MIN_ITEM)


def sweep_oh(args, smi, out):
    from thallo_tpu_torch.ops import ohsetup

    rng = np.random.default_rng(3)
    C = SKEW_1M[0]
    cases = [("ba_1m_cameras", torch.from_numpy(
        rng.integers(0, C, 1_000_000).astype(np.int32)).cuda()),
             ("skew_1m_cameras", skew_camera_ids())]
    for name, ids in cases:
        R = ids.shape[0]
        ops = tuple(torch.from_numpy(rng.normal(size=(k, R)).astype(np.float32)).cuda()
                    for k in (2, 18)) + (ids,)
        ref = ohsetup.oh_setup_products_reference(*ops, N=C, recipe=OH_RECIPE)

        def timed(kernel, fname, **extra):
            fn = getattr(ohsetup, fname)
            err = max_rel_err((fn(*ops, N=C, recipe=OH_RECIPE),), (ref,))
            eager, graph = per_launch_ms(lambda: fn(*ops, N=C, recipe=OH_RECIPE), args.n)
            if kernel == "chunked":
                plan = ohsetup.products_plan(OH_RECIPE, 2, 18, C, ohsetup.PRODUCTS_THREADS,
                                             ohsetup.PRODUCTS_SMEM)
                extra.update(chunk=plan.chunk, n_chunks=plan.n_chunks)
            emit({"name": name, "kernel": kernel, "R": R, "N": C, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": err, "card": smi, **extra}, out)

        timed("ranges", "oh_setup_products")
        timed("chunked", "oh_setup_products_chunked")
        timed("atomics", "oh_setup_products_atomics")
        if not args.sweep:
            continue
        with kept(ohsetup, "PRODUCTS_THREADS", "PRODUCTS_SMEM", "PRODUCTS_BLOCKS_PER_SM"):
            for (ohsetup.PRODUCTS_THREADS, ohsetup.PRODUCTS_SMEM,
                 ohsetup.PRODUCTS_BLOCKS_PER_SM) in OH_SWEEP:
                timed("chunked", "oh_setup_products_chunked",
                      PRODUCTS_THREADS=ohsetup.PRODUCTS_THREADS,
                      PRODUCTS_SMEM=ohsetup.PRODUCTS_SMEM,
                      PRODUCTS_BLOCKS_PER_SM=ohsetup.PRODUCTS_BLOCKS_PER_SM)


def sweep_fullrepeat(args, smi, out):
    from thallo_tpu_torch.ops import fullrepeat

    rng = np.random.default_rng(4)
    N_t, W, rc, Kall = 250_000, 4, 2, 24
    rT, Jall = (torch.from_numpy(rng.normal(size=(k, N_t * W)).astype(np.float32)).cuda()
                for k in (rc, Kall))
    kw = dict(W=W, N_t=N_t, recipe=FR_RECIPE)
    ragg, rcross = fullrepeat.fullrepeat_setup_reference(rT, Jall, **kw)

    def timed(kernel, fname, **extra):
        fn = getattr(fullrepeat, fname)
        agg, crosses = fn(rT, Jall, **kw)
        eager, graph = per_launch_ms(lambda: fn(rT, Jall, **kw), args.n)
        if kernel == "tiles":
            plan = fullrepeat.fullrepeat_plan(
                FR_RECIPE, W, Kall, rc, fullrepeat.FULLREPEAT_TILE,
                fullrepeat.FULLREPEAT_BLOCKS_PER_SM, fullrepeat.FULLREPEAT_THREADS)
            extra.update(T=plan.T, stages=plan.stages, threads=plan.threads,
                         blocks_per_sm=plan.blocks_per_sm, block_smem=plan.block_smem)
        emit({"name": "ba_1m_points", "kernel": kernel, "N_t": N_t, "W": W, "eager_ms": eager,
              "graph_ms": graph, "rel_err": max_rel_err([agg, *crosses], [ragg, *rcross]),
              "card": smi, **extra}, out)

    timed("tiles", "fullrepeat_setup")
    timed("thread", "fullrepeat_setup_thread")
    if args.sweep:
        with kept(fullrepeat, "FULLREPEAT_TILE", "FULLREPEAT_BLOCKS_PER_SM",
                  "FULLREPEAT_THREADS"):
            for fullrepeat.FULLREPEAT_TILE, fullrepeat.FULLREPEAT_BLOCKS_PER_SM in FR_SWEEP[0]:
                timed("tiles", "fullrepeat_setup")
        with kept(fullrepeat, "FULLREPEAT_THREADS"):
            for fullrepeat.FULLREPEAT_THREADS in FR_SWEEP[1]:
                timed("tiles", "fullrepeat_setup")
    for dtype in (torch.float32, torch.float64):
        sweep_fullrepeat_wide(args, smi, out, rng, dtype)


def sweep_fullrepeat_wide(args, smi, out, rng, dtype):
    """The wide kernel, the first body and the plain version at FR_WIDE in
    dtype; --sweep: the wide kernel over FR_WIDE_SWEEP."""
    from thallo_tpu_torch.ops import fullrepeat

    N_t, W = FR_WIDE
    rc, Kall = 2, 24
    sfx = "_f64" if dtype == torch.float64 else ""
    rT, Jall = (torch.from_numpy(rng.normal(size=(k, N_t * W))).to("cuda", dtype)
                for k in (rc, Kall))
    kw = dict(W=W, N_t=N_t, recipe=FR_RECIPE)
    ref = fullrepeat.fullrepeat_setup_reference(rT, Jall, **kw)
    ref = [ref[0], *ref[1]]

    def timed(kernel, fn, **extra):
        agg, crosses = fn(rT, Jall, **kw)
        eager, graph = per_launch_ms(lambda: fn(rT, Jall, **kw), args.n)
        if kernel.startswith("wide"):
            plan = fullrepeat._wide_plan(FR_RECIPE, W, Kall, rc, dtype.itemsize)
            extra.update(T=plan.T, Wc=plan.Wc, pitch=plan.pitch, stages=plan.stages,
                         threads=plan.threads, blocks_per_sm=plan.blocks_per_sm,
                         block_smem=plan.block_smem)
        emit({"name": "w10_points", "kernel": kernel, "N_t": N_t, "W": W, "eager_ms": eager,
              "graph_ms": graph, "rel_err": max_rel_err([agg, *crosses], ref), "card": smi,
              **extra}, out)

    timed("wide" + sfx, getattr(fullrepeat, "fullrepeat_setup_wide" + sfx))
    timed("thread" + sfx, getattr(fullrepeat, "fullrepeat_setup_thread" + sfx))
    timed("plain" + sfx, fullrepeat.fullrepeat_setup_reference)
    if not args.sweep:
        return
    names = ("WIDE_MAX_CONFLICT", "WIDE_TILE", "WIDE_BLOCKS_PER_SM", "WIDE_MAX_STAGES",
             "WIDE_THREADS_F64" if dtype == torch.float64 else "WIDE_THREADS")
    with kept(fullrepeat, *names):
        for conflict in FR_WIDE_SWEEP[0]:
            for tile, bps, stages in FR_WIDE_SWEEP[1]:
                for threads in FR_WIDE_SWEEP[2]:
                    setting = (conflict, tile, bps, stages, threads)
                    for n, v in zip(names, setting):
                        setattr(fullrepeat, n, v)
                    timed("wide" + sfx, getattr(fullrepeat, "fullrepeat_setup_wide" + sfx),
                          **dict(zip(names, setting)))


def sweep_aggregate(args, smi, out):
    from thallo_tpu_torch.ops import ohsetup

    rng = np.random.default_rng(5)
    C = SKEW_1M[0]
    cases = [("ba_1m_cameras", torch.from_numpy(
        rng.integers(0, C, 1_000_000).astype(np.int32)).cuda()),
             ("skew_1m_cameras", skew_camera_ids())]
    for name, ids in cases:
        R = ids.shape[0]
        parts = torch.from_numpy(rng.normal(size=(9, R)).astype(np.float32)).cuda()
        ref = ohsetup.oh_setup_aggregate_reference(parts, ids, N=C)
        idl = ids.long()

        def timed(kernel, fn, **extra):
            err = max_rel_err((fn(),), (ref,))
            eager, graph = per_launch_ms(fn, args.n)
            emit({"name": name, "kernel": kernel, "R": R, "N": C, "F": 9, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": err, "card": smi, **extra}, out)

        names = ("AGG_THREADS", "AGG_BLOCKS_PER_SM", "AGG_MERGE_MIN")

        def smem():
            timed("smem", lambda: ohsetup.oh_setup_aggregate(parts, ids, N=C),
                  **{n: getattr(ohsetup, n) for n in names})

        smem()
        timed("atomics", lambda: ohsetup.oh_setup_aggregate_atomics(parts, ids, N=C))
        timed("index_add_", lambda: torch.zeros((9, C), device="cuda").index_add_(1, idl, parts))
        if not args.sweep:
            continue
        with kept(ohsetup, *names):
            for ohsetup.AGG_THREADS, ohsetup.AGG_BLOCKS_PER_SM in AGG_SWEEP[0]:
                smem()
        with kept(ohsetup, *names):
            for ohsetup.AGG_MERGE_MIN in AGG_SWEEP[1]:
                smem()


def sweep_segsum(args, smi, out):
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.ops import segsum

    rng = np.random.default_rng(1)
    C, P, target = SKEW_1M
    skew, _ = ba.skewed_inputs(n_cameras=C, n_points=P, target_obs=target, seed=0)
    maps = [("points", np.repeat(np.arange(P, dtype=np.int32), 4), P, 3),
            ("cameras", rng.integers(0, C, 4 * P).astype(np.int32), C, 9),
            ("skew_cameras", np.asarray(skew["oToC"], np.int32), C, 9)]
    for name, ids, S, ch in maps:
        cm = torch.from_numpy(rng.normal(size=(ch, len(ids))).astype(np.float32)).cuda()
        idl = torch.from_numpy(ids).cuda().long()
        for layout, data in (("channel_major_T", cm.T), ("row_major", cm.T.contiguous())):
            def timed(kernel, fn, **extra):
                got = fn()
                ref = segsum.segment_sum_reference(data, plan)
                eager, graph = per_launch_ms(fn, args.n)
                emit({"name": name, "kernel": kernel, "layout": layout, "M": len(ids), "S": S,
                      "C": ch, "eager_ms": eager, "graph_ms": graph,
                      "rel_err": max_rel_err((got,), (ref,)), "card": smi, **extra}, out)

            plan = segsum.build_plan(ids, S, device="cuda")
            timed("segment_sum", lambda: segsum.segment_sum(data, plan), modes=plan.modes,
                  staged=plan.local is not None and data.stride(0) == 1)
            timed("index_add_", lambda: torch.zeros((S, ch), device="cuda").index_add_(
                0, idl, data))
            if not args.sweep:
                continue
            kept = (segsum.TARGET_PIECES, segsum.STAGED_MAX_SEGMENTS, segsum.STAGED_MAX_SHARE)
            try:
                segsum.STAGED_MAX_SEGMENTS = 0  # the sorted runs alone
                for v in PIECES_SWEEP:
                    segsum.TARGET_PIECES = v
                    swept = segsum.build_plan(ids, S, device="cuda")
                    timed("segment_sum", lambda: segsum.segment_sum(data, swept),
                          modes=swept.modes, staged=False, TARGET_PIECES=v)
                segsum.TARGET_PIECES, segsum.STAGED_MAX_SEGMENTS = kept[:2]
                if layout != "channel_major_T" or S > segsum.STAGED_MAX_SEGMENTS:
                    continue
                segsum.STAGED_MAX_SHARE = 1  # staged whatever one segment owns
                for v in STAGED_ROWS_SWEEP:  # the first staged body; the ring where it fits
                    swept = segsum.build_plan(ids, S, device="cuda", staged_rows=v)
                    timed("segment_sum_per_chunk",
                          lambda: segsum.segment_sum_per_chunk(data, swept),
                          modes=swept.modes, staged=True, STAGED_ROWS=v)
                    if v <= segsum.STAGED_ROWS:
                        timed("segment_sum", lambda: segsum.segment_sum(data, swept),
                              modes=swept.modes, staged=True, STAGED_ROWS=v)
            finally:
                segsum.TARGET_PIECES, segsum.STAGED_MAX_SEGMENTS, segsum.STAGED_MAX_SHARE = kept


# the atomics route's other shapes: (tag, W, N, Ci, Cj, S): a BA pair whose
# accumulator is beyond the persistent kernel, bundle_fusion's [8, 700],
# embedded deformation's (9, 3) and a 16 x 16 pair
SLOTS_SHAPES = (("ba_big_s", 4, 250_000, 3, 9, 4000), ("bundle_fusion", 8, 700, 6, 6, 700),
                ("embedded", 4, 1600, 9, 3, 400), ("wide_16x16", 3, 5000, 16, 16, 3000))


def sweep_staged(args, smi, out):
    from thallo_tpu_torch.ops import segsum

    rng = np.random.default_rng(7)
    C, P, _ = SKEW_1M
    ids = rng.integers(0, C, 4 * P).astype(np.int32)
    idl = torch.from_numpy(ids).cuda().long()
    plans = {"ring": segsum.build_plan(ids, C, device="cuda"),
             "own": segsum.build_plan(ids, C, device="cuda", staged_rows=segsum.PER_CHUNK_ROWS)}
    for dt in (torch.float32, torch.float64):
        cm = torch.from_numpy(rng.normal(size=(9, len(ids)))).to("cuda", dt)
        data = cm.T
        ref = segsum.segment_sum_reference(data, plans["ring"])
        first = segsum.segment_sum_per_chunk_f64 if dt == torch.float64 else \
            segsum.segment_sum_per_chunk
        calls = [("ring", lambda: segsum.segment_sum(data, plans["ring"]), plans["ring"]),
                 ("per_chunk", lambda: first(data, plans["ring"]), plans["ring"]),
                 ("per_chunk_own", lambda: first(data, plans["own"]), plans["own"]),
                 ("index_add_", lambda: torch.zeros((C, 9), dtype=dt, device="cuda").index_add_(
                     0, idl, data), None)]
        for kernel, fn, plan in calls:
            got = fn()
            same = bool(torch.equal(got, fn()))
            eager, graph = per_launch_ms(fn, args.n)
            emit({"name": "cameras", "kernel": kernel, "dtype": str(dt), "M": len(ids), "S": C,
                  "C": 9, "T": plan.staged_rows if plan else None,
                  "blocks": plan.n_blocks if plan else None, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": max_rel_err((got,), (ref,)),
                  "same_bits": same, "card": smi}, out)


def grid_ids(side, shuffled):
    """[4, side²] int32 on the card: each vertex's four grid neighbours (-1
    past the border), the shape of ARAP's 3 x 3 col levels; shuffled: the
    vertices in a seeded random order (a shuffled edge order's tables)."""
    n = np.arange(side * side)
    x, y = n % side, n // side
    ids = np.stack([np.where(x + 1 < side, n + 1, -1), np.where(x > 0, n - 1, -1),
                    np.where(y + 1 < side, n + side, -1), np.where(y > 0, n - side, -1)])
    if shuffled:
        ids = ids[:, np.random.default_rng(5).permutation(side * side)]
    return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).cuda()


def sweep_slots(args, smi, out):
    from thallo_tpu_torch.ops import fusedpair

    rng = np.random.default_rng(8)
    cases = [(f"grid256_{order}", grid_ids(256, order == "shuffled"), 3, 3, 256 * 256)
             for order in ("grouped", "shuffled")]
    cases += [(tag, random_ids(rng, W, N, S), Ci, Cj, S) for tag, W, N, Ci, Cj, S in SLOTS_SHAPES]
    for name, ids, Ci, Cj, S in cases:
        W, N = ids.shape
        kw = dict(Ci=Ci, Cj=Cj, S=S)
        for dt, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
            ops = tuple(x.to(dt) if x.is_floating_point() else x
                        for x in f32_operands(rng, ids, Ci, Cj, S))
            ref = fusedpair.fused_pair_apply_reference(*ops, **kw)
            for kernel in ("fused_pair_apply_atomics", "fused_pair_apply_atomics_thread"):
                fn = getattr(fusedpair, kernel + suffix)
                err = max_rel_err(fn(*ops, **kw), ref)
                eager, graph = per_launch_ms(lambda: fn(*ops, **kw), args.n)
                emit({"name": name, "kernel": kernel + suffix, "W": W, "N": N, "Ci": Ci,
                      "Cj": Cj, "S": S, "eager_ms": eager, "graph_ms": graph, "rel_err": err,
                      "route": fusedpair.fused_pair_route(W, N, Ci, Cj, S, dtype=dt),
                      "card": smi}, out)


BF16_SLOTS_SHAPES = (("wide_9x3", 12, 16384, 9, 3, 16384), ("wide_16x3", 12, 16384, 16, 3, 16384),
                     ("embedded", 4, 1600, 9, 3, 1600))


def sweep_bf16_slots(args, smi, out):
    from thallo_tpu_torch.ops import _cuda, fusedpair

    rng = np.random.default_rng(9)
    cases = [(f"grid256_{order}", grid_ids(256, order == "shuffled"), 3, 3, 256 * 256)
             for order in ("grouped", "shuffled")]
    cases += [(tag, random_ids(rng, W, N, S), Ci, Cj, S)
              for tag, W, N, Ci, Cj, S in BF16_SLOTS_SHAPES]
    slots = fusedpair.fused_pair_apply_atomics_bf16
    for name, ids, Ci, Cj, S in cases:
        W, N = ids.shape
        kw = dict(Ci=Ci, Cj=Cj, S=S)
        f32 = f32_operands(rng, ids, Ci, Cj, S)
        ops = (f32[0], f32[1].bfloat16(), *f32[2:])
        f32 = (ops[0], ops[1].float(), *ops[2:])  # the same (rounded) values
        ref = fusedpair.fused_pair_apply_reference(*ops, **kw)
        auto = fusedpair.bf16_slot_lanes(W, N, _cuda.sm_count(ids.device))

        def timed(kernel, fn, operands=ops, **extra):
            err = max_rel_err(fn(*operands), ref)
            eager, graph = per_launch_ms(lambda: fn(*operands), args.n)
            emit({"name": name, "kernel": kernel, "W": W, "N": N, "Ci": Ci, "Cj": Cj, "S": S,
                  "eager_ms": eager, "graph_ms": graph, "rel_err": err, "card": smi,
                  "route": fusedpair.fused_pair_route(W, N, Ci, Cj, S, bf16=True), **extra}, out)

        timed("fused_pair_apply_atomics_bf16", lambda *a: slots(*a, **kw), P=auto)
        for P in (1, 2, 4, 8):
            timed("fused_pair_apply_atomics_bf16", lambda *a, P=P: fusedpair._launch_atomics(
                slots, *a, Ci, Cj, S, torch.bfloat16, True, P=P), P=P)
        timed("fused_pair_bf16_atomics", lambda *a: fusedpair.fused_pair_bf16_atomics(*a, **kw))
        timed("fused_pair_apply_atomics_f32", lambda *a: fusedpair.fused_pair_apply_atomics(
            *a, **kw), f32)


def sweep_bf16(args, smi, out):
    from thallo_tpu_torch.ops import fusedpair

    rng = np.random.default_rng(6)
    kw = dict(Ci=3, Cj=9, S=1024)
    cases = [("ba_1m_pt_cam", random_ids(rng, 4, 250_000, kw["S"]))] + skew_tables(None)
    for name, ids in cases:
        W, N = ids.shape
        ops = f32_operands(rng, ids, **kw)
        ops = (ops[0], ops[1].bfloat16(), *ops[2:])
        f32 = (ops[0], ops[1].float(), *ops[2:])
        ref = fusedpair.fused_pair_apply_reference(*ops, **kw)
        route = fusedpair.fused_pair_route(W, N, **kw)

        def timed(kernel, fn, operands=ops, **extra):
            err = max_rel_err(fn(*operands, **kw), ref)
            eager, graph = per_launch_ms(lambda: fn(*operands, **kw), args.n)
            emit({"name": name, "kernel": kernel, "W": W, "N": N, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": err, "card": smi, "route": route, **extra}, out)

        bf16_fn = getattr(fusedpair, route + "_bf16")
        persistent = route == "fused_pair_apply"
        if persistent:
            with kept(fusedpair, "BF16_ELEMS"):
                for fusedpair.BF16_ELEMS in (1, 2):
                    timed(route + "_bf16", bf16_fn, BF16_ELEMS=fusedpair.BF16_ELEMS,
                          elems=fusedpair.bf16_elems(N))
            rows = fusedpair.fused_pair_rows_floor
            timed("rows_floor_bf16", lambda *a, **k: (rows(*a, **k), ref[1]),
                  elems=fusedpair.bf16_elems(N))
        else:
            timed(route + "_bf16", bf16_fn)
        timed("fused_pair_bf16_atomics", fusedpair.fused_pair_bf16_atomics)
        timed("fused_pair_apply_atomics_bf16", fusedpair.fused_pair_apply_atomics_bf16)
        timed(route + "_f32", getattr(fusedpair, route), f32)
        if not args.sweep:
            continue
        names = (("THREADS", "BLOCKS_PER_SM") if persistent
                 else ("WLOOP_THREADS", "WLOOP_BLOCKS_PER_SM"))
        with kept(fusedpair, *names):
            for threads, per_sm in BF16_SWEEP:
                setattr(fusedpair, names[0], threads)
                setattr(fusedpair, names[1], per_sm)
                timed(route + "_bf16", bf16_fn, **{names[0]: threads, names[1]: per_sm})
        if persistent:
            with kept(fusedpair, "MERGE_MIN"):
                for fusedpair.MERGE_MIN in PAIR_SWEEP[1]:
                    timed(route + "_bf16", bf16_fn, MERGE_MIN=fusedpair.MERGE_MIN)


def sweep_variants(args, smi, out):
    from thallo_tpu_torch.ops import fusedpair

    rng = np.random.default_rng(7)
    kw = dict(Ci=3, Cj=9, S=1024)
    ids = random_ids(rng, 4, 250_000, kw["S"])
    W, N = ids.shape
    ops = pair_operands(rng, ids, **kw)
    ref = fusedpair.fused_pair_apply_reference(*ops, **kw)
    names = ("CLUSTER_SIZE", "CLUSTER_THREADS", "CLUSTER_BLOCKS_PER_SM")

    def timed(kernel, fname):
        fn = getattr(fusedpair, fname)
        got = fn(*ops, **kw)
        err = max_rel_err((got,), ref[:1]) if kernel == "noflush" else max_rel_err(got, ref)
        eager, graph = per_launch_ms(lambda: fn(*ops, **kw), args.n)
        extra = {}
        if kernel in CLUSTER_MODES:
            mode = CLUSTER_MODES[kernel]
            extra = {n: getattr(fusedpair, n) for n in names}
            extra["threads"], extra["grid"], extra["n_slabs"] = fusedpair.cluster_grid(
                ops[0].device, N, kw["S"], mode)
            extra["max_active_clusters"] = fusedpair.max_active_clusters(
                ops[0].device, kw["S"], extra["threads"], fusedpair.CLUSTER_SIZE,
                fusedpair.bf16_elems(N), mode)
        emit({"name": "ba_1m_pt_cam", "kernel": kernel, "W": W, "N": N, "eager_ms": eager,
              "graph_ms": graph, "rel_err": err, "card": smi, **extra}, out)

    for kernel, fname in VARIANT_KERNELS:
        timed(kernel, fname)
    if not args.sweep:
        return
    with kept(fusedpair, *names):
        for setting in CLUSTER_SWEEP:
            for n, v in zip(names, setting):
                setattr(fusedpair, n, v)
            why = None
            try:  # above 8 blocks only where the card grants non-portable clusters
                granted = fusedpair.max_active_clusters(ops[0].device, kw["S"], setting[1],
                                                        setting[0], fusedpair.bf16_elems(N)) > 0
            except RuntimeError as exc:
                if setting[0] <= 8:
                    raise
                granted, why = False, str(exc)
            if not granted:
                emit({"name": "ba_1m_pt_cam", "kernel": "cluster", "granted": False,
                      "error": why, **dict(zip(names, setting)), "card": smi}, out)
                continue
            for kernel in CLUSTER_MODES:
                timed(kernel, dict(VARIANT_KERNELS)[kernel])


def sweep_v1(args, smi, out):
    from thallo_tpu_torch.ops import fusedpair

    rng = np.random.default_rng(8)
    kw = dict(Ci=3, Cj=9, S=1024)
    cases = [("ba_1m_pt_cam", random_ids(rng, 4, 250_000, kw["S"]))] + skew_tables((0,))
    names = ("V1_THREADS", "V1_BLOCKS_PER_SM")
    for name, ids in cases:
        W, N = ids.shape
        ops = pair_operands(rng, ids, **kw)
        ref = fusedpair.fused_pair_apply_reference(*ops, **kw)[:1]

        def timed(kernel, fname, **extra):
            fn = getattr(fusedpair, fname)
            err = max_rel_err((fn(*ops, **kw),), ref)
            eager, graph = per_launch_ms(lambda: fn(*ops, **kw), args.n)
            emit({"name": name, "kernel": kernel, "W": W, "N": N, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": err, "card": smi, **extra}, out)

        timed("v1_rows", "fused_pair_v1_rows", **{n: getattr(fusedpair, n) for n in names},
              elems=fusedpair.v1_elems(N))
        timed("v1_rows_generic", "fused_pair_v1_rows_generic")
        timed("rows_floor_bf16", "fused_pair_rows_floor", elems=fusedpair.bf16_elems(N))
        if not args.sweep:
            continue
        with kept(fusedpair, *names):
            for setting in V1_SWEEP:
                for n, v in zip(names, setting):
                    setattr(fusedpair, n, v)
                timed("v1_rows", "fused_pair_v1_rows", **dict(zip(names, setting)),
                      elems=fusedpair.v1_elems(N))


# (elems, w_item) of the w-lane W-loop kernel
WLOOP_F64_ITEMS = ((32, 10), (32, 5), (16, 5))
OH_F64_THREADS = (256, 384)  # the range kernel's threads in f64
# the range kernel beside the chunk kernel: camera counts at R 1 000 000,
# and observation counts at N 1024 and 64
OH_SCAN_N = (1024, 1536, 2048, 3072, 4096, 6144, 9000, 12288, 18000, 24576, 36000)
OH_SCAN_R = (5_590, 12_784, 32_768, 65_536, 131_072, 262_144)
OH_SCAN_R_N = (1024, 64)
OH_SCAN_MAX_RANGES = 128

# the w-lane kernel at any plan, its cols side on or compiled out
LANES_PROBE_SRC = r'''
#include "fused_pair_wloop.cu"

extern "C" int probe_wloop_lanes_bf16_f64(const void* ids, const void* blocks, const void* pcol,
                                          const void* prow, void* rows, void* cols, int W,
                                          int N, int S, int grid, int elems, int w_item,
                                          int merge_min, int with_cols, void* stream) {
  const auto launch = with_cols ? launch_wloop_lanes<__nv_bfloat16, double, true>
                                : launch_wloop_lanes<__nv_bfloat16, double, false>;
  return static_cast<int>(launch(ids, blocks, pcol, prow, rows, cols, W, N, S, grid, elems,
                                 w_item, merge_min, static_cast<cudaStream_t>(stream)));
}
'''


@functools.lru_cache(maxsize=1)
def lanes_probe_lib():
    """The scratch build of csrc/fused_pair_wloop.cu with the probe's
    export (one nvcc, a few seconds)."""
    from thallo_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "wloop_lanes_probe.cu", out / "wloop_lanes_probe.so"
    src.write_text(LANES_PROBE_SRC)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda._CSRC), "-o",
                    str(so), str(src)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_wloop_lanes_bf16_f64.argtypes = (P,) * 6 + (I,) * 8 + (P,)
    lib.probe_wloop_lanes_bf16_f64.restype = I
    return lib


def lanes_probe(ids, blocks, pcol, prow, *, Ci, Cj, S, plan, with_cols):
    """The w-lane kernel at plan (elems, w_item, grid), as the route's
    wrapper launches it, without its cols side where with_cols is False
    (cols stay zero)."""
    from thallo_tpu_torch.ops import _cuda, fusedpair

    W, N = ids.shape
    elems, w_item, grid = plan
    dev = ids.device
    rows = (torch.empty if w_item >= W > 0 else torch.zeros)((Ci, N), dtype=torch.float64,
                                                             device=dev)
    cols = torch.zeros((Cj, S), dtype=torch.float64, device=dev)
    code = lanes_probe_lib().probe_wloop_lanes_bf16_f64(
        ids.data_ptr(), blocks.data_ptr(), pcol.data_ptr(), prow.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), W, N, S, grid, elems, w_item, fusedpair.MERGE_MIN, int(with_cols),
        _cuda.stream(ids))
    _cuda.check(code, "probe_wloop_lanes_bf16_f64")
    return rows, cols


def sweep_wloop_f64(args, smi, out):
    from thallo_tpu_torch.ops import _cuda, fusedpair

    rng = np.random.default_rng(7)
    kw = dict(Ci=3, Cj=9, S=1024)
    sms = _cuda.sm_count(torch.device("cuda"))
    cases = [("w10_n100000", random_ids(rng, 10, 100_000, kw["S"]))]
    cases += [(n, ids) for n, ids in skew_tables(None) if ids.shape[0] >= fusedpair.WLOOP_MIN_W]
    for name, ids in cases:
        W, N = ids.shape
        f32 = f32_operands(rng, ids, **kw)
        ops = (ids, f32[1].bfloat16(), f32[2].double(), f32[3].double())
        f64 = (ids, f32[1].bfloat16().double(), *ops[2:])
        ref = fusedpair.fused_pair_apply_reference(*ops, **kw)
        plan = fusedpair.wloop_lanes_plan(W, N, sms)
        route = fusedpair.fused_pair_route(W, N, **kw, bf16=True, dtype=torch.float64)

        def timed(kernel, fn, operands=ops, exact=True, **extra):
            got = fn(*operands, **kw)
            err = max_rel_err(got, ref) if exact else None
            eager, graph = per_launch_ms(lambda: fn(*operands, **kw), args.n)
            emit({"name": name, "kernel": kernel, "W": W, "N": N, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": err, "card": smi, "route": route, **extra}, out)

        def probe(kernel, with_cols=True, pl=plan, **extra):
            timed(kernel, lambda *a, **k: lanes_probe(*a, **k, plan=pl, with_cols=with_cols),
                  exact=with_cols, plan=list(pl), **extra)

        timed("lanes", fusedpair.fused_pair_apply_wloop_bf16_f64, plan=list(plan))
        timed("gathered", fusedpair.fused_pair_apply_wloop_bf16_f64_gathered,
              plan=list(fusedpair.wloop_plan(W, N, kw["S"], sms, 8)))
        timed("wloop_f64", fusedpair.fused_pair_apply_wloop_f64, f64)
        timed("wloop_f32", fusedpair.fused_pair_apply_wloop, f32, exact=False,
              rel_err_f32=max_rel_err(fusedpair.fused_pair_apply_wloop(*f32, **kw),
                                      fusedpair.fused_pair_apply_reference(*f32, **kw)))
        if not args.sweep:
            continue
        probe("probe_nocols", False)
        for elems, wi in WLOOP_F64_ITEMS:
            if wi <= W:
                probe("lanes", pl=(elems, wi, plan[2]))


def sweep_oh_f64(args, smi, out):
    from thallo_tpu_torch.ops import _cuda, ohsetup

    rng = np.random.default_rng(8)
    C = SKEW_1M[0]
    sms = _cuda.sm_count(torch.device("cuda"))
    cases = [("ba_1m_cameras", torch.from_numpy(
        rng.integers(0, C, 1_000_000).astype(np.int32)).cuda()),
             ("skew_1m_cameras", skew_camera_ids())]

    class _Count:  # the swept launches count on no wrapper
        __name__ = "oh_setup_products_ranges_swept"
        launches = 0

    for name, ids in cases:
        R = ids.shape[0]
        ops = tuple(torch.from_numpy(rng.normal(size=(k, R))).cuda() for k in (2, 18)) + (ids,)
        ops32 = (ops[0].float(), ops[1].float(), ids)
        ref = ohsetup.oh_setup_products_reference(*ops, N=C, recipe=OH_RECIPE)
        ref32 = ohsetup.oh_setup_products_reference(*ops32, N=C, recipe=OH_RECIPE)

        def timed(kernel, fn, operands=ops, r=ref, **extra):
            err = max_rel_err((fn(*operands, N=C, recipe=OH_RECIPE),), (r,))
            eager, graph = per_launch_ms(lambda: fn(*operands, N=C, recipe=OH_RECIPE), args.n)
            emit({"name": name, "kernel": kernel, "R": R, "N": C, "eager_ms": eager,
                  "graph_ms": graph, "rel_err": err, "card": smi, **extra}, out)

        def ranges(threads, itemsize):
            plan = ohsetup.products_ranges_plan(OH_RECIPE, 2, 18, C, threads,
                                                ohsetup.PRODUCTS_SMEM, itemsize)
            return plan, lambda rT, J, i, N, recipe: ohsetup._launch_products_ranges(
                _Count, rT, J, i, N, plan, threads)

        plan = ohsetup.products_ranges_plan(OH_RECIPE, 2, 18, C,
                                            ohsetup.PRODUCTS_RANGE_THREADS_F64,
                                            ohsetup.PRODUCTS_SMEM)
        timed("ranges_f64", ohsetup.oh_setup_products_f64, n_ranges=plan.n_ranges,
              span=plan.span,
              grid=ohsetup.products_ranges_grid(plan, R, ohsetup.PRODUCTS_RANGE_THREADS_F64,
                                                sms))
        timed("chunked_f64", ohsetup.oh_setup_products_chunked_f64)
        timed("atomics_f64", ohsetup.oh_setup_products_atomics_f64)
        timed("ranges_f32", ohsetup.oh_setup_products, ops32, ref32,
              threads=ohsetup.PRODUCTS_RANGE_THREADS)
        timed("chunked_f32", ohsetup.oh_setup_products_chunked, ops32, ref32)
        if not args.sweep:
            continue
        for threads in OH_F64_THREADS:
            plan_t, fn_t = ranges(threads, 8)
            timed("ranges_f64", fn_t, threads=threads, n_ranges=plan_t.n_ranges)
        plan32, fn32 = ranges(512, 4)
        timed("ranges_f32", fn32, ops32, ref32, threads=512, n_ranges=plan32.n_ranges)
    if args.sweep:
        scan_oh(args, smi, out, rng)


def scan_oh(args, smi, out, rng):
    """The range kernel (launched at its plan, whatever the route, up to
    OH_SCAN_MAX_RANGES ranges) beside the chunk kernel (and, from 6 144
    cameras, the first body) over N at R 1 000 000 and over R at N 1024
    and 64, in f64 and f32."""
    from thallo_tpu_torch.ops import ohsetup

    class _Count:  # the scan's launches count on no wrapper
        __name__ = "oh_setup_products_ranges_scanned"
        launches = 0

    shapes = [(N, 1_000_000) for N in OH_SCAN_N] + [(N, R) for N in OH_SCAN_R_N
                                                     for R in OH_SCAN_R]
    for dt in (torch.float64, torch.float32):
        f64 = dt == torch.float64
        threads = ohsetup.PRODUCTS_RANGE_THREADS_F64 if f64 else ohsetup.PRODUCTS_RANGE_THREADS
        chunked = (ohsetup.oh_setup_products_chunked_f64 if f64
                   else ohsetup.oh_setup_products_chunked)
        first = (ohsetup.oh_setup_products_atomics_f64 if f64
                 else ohsetup.oh_setup_products_atomics)
        for N, R in shapes:
            ids = torch.from_numpy(rng.integers(0, N, R).astype(np.int32)).cuda()
            ops = tuple(torch.from_numpy(rng.normal(size=(k, R))).to("cuda", dt)
                        for k in (2, 18)) + (ids,)
            ref = ohsetup.oh_setup_products_reference(*ops, N=N, recipe=OH_RECIPE)
            with kept(ohsetup, "PRODUCTS_MAX_RANGES", "PRODUCTS_MAX_RANGES_F64"):
                ohsetup.PRODUCTS_MAX_RANGES = ohsetup.PRODUCTS_MAX_RANGES_F64 = OH_SCAN_MAX_RANGES
                plan = ohsetup.products_ranges_plan.__wrapped__(
                    OH_RECIPE, 2, 18, N, threads, ohsetup.PRODUCTS_SMEM, 8 if f64 else 4)
            chunks = ohsetup.products_plan(
                OH_RECIPE, 2, 18, N,
                ohsetup.PRODUCTS_THREADS_F64 if f64 else ohsetup.PRODUCTS_THREADS,
                ohsetup.PRODUCTS_SMEM, 8 if f64 else 4)
            route = ohsetup.products_route(OH_RECIPE, 2, 18, N, dt, R)
            fns = [("chunked", chunked)] + ([("atomics", first)] if N >= 6144 else [])
            if plan is not None:
                fns.insert(0, ("ranges", lambda rT, J, i, N, recipe, plan=plan:
                               ohsetup._launch_products_ranges(_Count, rT, J, i, N, plan,
                                                               threads)))
            for kernel, fn in fns:
                try:
                    got = fn(*ops, N=N, recipe=OH_RECIPE)
                except ValueError:  # no chunk plan at this N
                    continue
                err = max_rel_err((got,), (ref,))
                eager, graph = per_launch_ms(lambda: fn(*ops, N=N, recipe=OH_RECIPE), args.n)
                emit({"name": "scan", "kernel": f"{kernel}_{'f64' if f64 else 'f32'}", "R": R,
                      "N": N, "eager_ms": eager, "graph_ms": graph, "rel_err": err,
                      "card": smi, "route": route,
                      "n_ranges": plan.n_ranges if plan else None,
                      "n_chunks": chunks.n_chunks if chunks else None}, out)


GROUPS = {"pairs": sweep_pairs, "wloop": sweep_wloop, "oh": sweep_oh, "segsum": sweep_segsum,
          "staged": sweep_staged, "slots": sweep_slots, "fullrepeat": sweep_fullrepeat, "aggregate": sweep_aggregate, "bf16": sweep_bf16,
          "bf16_slots": sweep_bf16_slots,
          "variants": sweep_variants, "v1": sweep_v1, "wloop_f64": sweep_wloop_f64,
          "oh_f64": sweep_oh_f64}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20, help="calls per timing")
    ap.add_argument("--sweep", action="store_true", help="also vary the kernels' constants")
    ap.add_argument("--only", nargs="+", choices=sorted(GROUPS), help="run these groups only")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    smi = card()
    out = open(args.out, "a") if args.out else None
    try:
        for name, fn in GROUPS.items():
            if args.only is None or name in args.only:
                fn(args, smi, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
