"""The redesigned fused pair and segment sum on the card, beside what
they replaced, and the sweeps behind their constants.

    python3 scripts/torch_redesign_sweep.py [--n 20] [--sweep] [--out FILE]

Fused pair (f32 blocks, 3 x 9, S 1024), at the uniform 1M BA shape
(W 4, N 250 000, random ids) and at the skewed 1M scene's real level-0
and level-1 col tables:
  persistent  fused_pair_apply (csrc/fused_pair.cu, the persistent kernel)
  atomics     fused_pair_apply_atomics (one global atomic per cols value)
  wloop       fused_pair_apply_wloop
  rows_floor  the persistent kernel without its cols side
With --sweep the persistent kernel is also timed over its block size and
blocks per SM (THREADS, BLOCKS_PER_SM) and over the warp-merge threshold
(MERGE_MIN; 33 = never merge).
Segment sum, on maps with the 1M scenes' statistics (points: 250 000
segments of 4 sorted rows, 3 channels; cameras: 1024 segments of ~977
scattered rows, 9 channels; the skewed scene's real oToC, one camera with
half the rows), data channel-major transposed (as the solver passes it)
and row-major: segment_sum against torch.zeros(...).index_add_.  With
--sweep also the sorted runs alone over TARGET_PIECES, and the staged
kernel over STAGED_ROWS, on the skewed map too (which staged_eligible
refuses: a thread sums the hot camera's share of a chunk alone).  One JSON line per timing: ms per call
over n calls eager and in one CUDA graph (CUDA events; a replayed graph
finds everything below 50 MB warm in L2), and the error against the
plain torch version.  Needs CUDA.
"""
import argparse
import sys

import numpy as np
import torch

from torch_measure import (SKEW_1M, card, emit, max_rel_err, per_launch_ms, random_ids,
                           skew_tables)

PAIR_KERNELS = [("persistent", "fused_pair_apply"), ("atomics", "fused_pair_apply_atomics"),
                ("wloop", "fused_pair_apply_wloop"), ("rows_floor", "fused_pair_rows_floor")]
PAIR_SWEEP = [((256, 1), (256, 2), (256, 3), (256, 4), (256, 5), (256, 6), (256, 8),
               (128, 4), (128, 8), (128, 12), (512, 1), (512, 2), (512, 3), (512, 4),
               (1024, 1), (1024, 2)),  # (THREADS, BLOCKS_PER_SM)
              (2, 4, 33)]  # MERGE_MIN
PIECES_SWEEP = (1024, 2048, 4096, 8192, 16384, 32768)
STAGED_ROWS_SWEEP = (1024, 1536, 2048, 3072, 4096)


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
        kept = fusedpair.THREADS, fusedpair.BLOCKS_PER_SM, fusedpair.MERGE_MIN
        try:
            for fusedpair.THREADS, fusedpair.BLOCKS_PER_SM in PAIR_SWEEP[0]:
                swept = dict(THREADS=fusedpair.THREADS, BLOCKS_PER_SM=fusedpair.BLOCKS_PER_SM)
                timed("persistent", "fused_pair_apply", **swept)
                timed("rows_floor", "fused_pair_rows_floor", **swept)
            fusedpair.THREADS, fusedpair.BLOCKS_PER_SM = kept[:2]
            for fusedpair.MERGE_MIN in PAIR_SWEEP[1]:
                timed("persistent", "fused_pair_apply", MERGE_MIN=fusedpair.MERGE_MIN)
        finally:
            fusedpair.THREADS, fusedpair.BLOCKS_PER_SM, fusedpair.MERGE_MIN = kept


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
            kept = (segsum.TARGET_PIECES, segsum.STAGED_MAX_SEGMENTS, segsum.STAGED_ROWS,
                    segsum.STAGED_MAX_SHARE)
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
                for v in STAGED_ROWS_SWEEP:
                    segsum.STAGED_ROWS = v
                    swept = segsum.build_plan(ids, S, device="cuda")
                    timed("segment_sum", lambda: segsum.segment_sum(data, swept),
                          modes=swept.modes, staged=True, STAGED_ROWS=v)
            finally:
                (segsum.TARGET_PIECES, segsum.STAGED_MAX_SEGMENTS, segsum.STAGED_ROWS,
                 segsum.STAGED_MAX_SHARE) = kept


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20, help="calls per timing")
    ap.add_argument("--sweep", action="store_true", help="also vary the kernels' constants")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    smi = card()
    out = open(args.out, "a") if args.out else None
    try:
        sweep_pairs(args, smi, out)
        sweep_segsum(args, smi, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
