"""Where the fused pair's cols output costs time, on the card: the
counterpart of scripts/tpu_fused_variants.py.

    python3 scripts/torch_fused_variants.py [--n 50] [--out FILE]

The forms of the bf16-block fused pair:
  v0_atomics    both outputs, cols summed in a shared accumulator per
                block and flushed by one global atomic per nonzero entry
                per block (fused_pair_bf16, the micro script's pair: the
                bf16 persistent kernel of csrc/fused_pair.cu)
  v1_rows_only  no cols output: the rows kernel (csrc/fused_pair_rows.cu)
  v1_rows_only_generic
                its first body (csrc/fused_pair_variants.cu mode 1)
  v2_smem       the cluster kernel (csrc/fused_pair_cluster.cu): the
                blocks of a cluster sum their shared accumulators through
                distributed shared memory, one global atomic per nonzero
                entry per cluster
  v3_partials   the cluster kernel, one slab per cluster, the slabs
                summed by torch.sum
  v2_smem_generic, v3_partials_generic
                their first bodies (csrc/fused_pair_variants.cu modes 2, 3)
on the JAX script's cases (ba_1m_pt_cam, skew_level_w8: random ids) and
on the skewed 1M BA scene's real level-0 and widest col tables, where
the cameras' power-law degrees put many of a block's values on one
camera.  One JSON line per (case, variant): ms per launch over n
launches eager and in one CUDA graph (CUDA events), and the error
against the plain torch version.  Then one line per case with the split
of the cols side, each a CUDA-graph ms per launch, cumulative:
  floor      the bf16 persistent kernel without its cols side
             (fused_pair_rows_floor)
  additions  + the shared additions and the in-cluster sum
             (fused_pair_cluster_noflush: nothing leaves the cluster; at
             a cluster of 1 block for v0 and cluster1_atomics)
  flush      + the sum across clusters or blocks: the whole kernel
for v0 (fused_pair_bf16), v2 and v3 (at CLUSTER_SIZE), and
cluster1_atomics (v2's kernel at clusters of one block: the per-block
global flush of v0 in the cluster kernel).  Needs CUDA.
"""
import argparse
import sys

import numpy as np

from torch_measure import (JAX_CASES, card, emit, kept, max_rel_err, pair_operands,
                           per_launch_ms, random_ids, skew_tables)

VARIANTS = [("v0_atomics", "fused_pair_bf16"), ("v1_rows_only", "fused_pair_v1_rows"),
            ("v1_rows_only_generic", "fused_pair_v1_rows_generic"),
            ("v2_smem", "fused_pair_v2_smem"), ("v3_partials", "fused_pair_v3_partials"),
            ("v2_smem_generic", "fused_pair_v2_smem_generic"),
            ("v3_partials_generic", "fused_pair_v3_partials_generic")]


def split(fusedpair, ops, kw, n, graph):
    """{form: {"floor", "additions", "flush"}} in CUDA-graph ms per launch;
    graph: the variants' graph ms already measured."""
    def ms(fname):
        fn = getattr(fusedpair, fname)
        return per_launch_ms(lambda: fn(*ops, **kw), n)[1]

    floor = ms("fused_pair_rows_floor")
    additions = ms("fused_pair_cluster_noflush")
    with kept(fusedpair, "CLUSTER_SIZE"):
        fusedpair.CLUSTER_SIZE = 1
        additions1 = ms("fused_pair_cluster_noflush")
        flush1 = ms("fused_pair_v2_smem")
    return {"v0_atomics": {"floor": floor, "additions": additions1, "flush": graph["v0_atomics"]},
            "v2_smem": {"floor": floor, "additions": additions, "flush": graph["v2_smem"]},
            "v3_partials": {"floor": floor, "additions": additions, "flush": graph["v3_partials"]},
            "cluster1_atomics": {"floor": floor, "additions": additions1, "flush": flush1}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50, help="launches per timing")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    smi = card()
    from thallo_tpu_torch.ops import fusedpair

    rng = np.random.default_rng(0)
    cases = [(name, random_ids(rng, W, N, S), Ci, Cj, S) for name, Ci, Cj, W, S, N in JAX_CASES
             if name in ("ba_1m_pt_cam", "skew_level_w8")]
    cases += [(name, ids, 3, 9, 1024) for name, ids in skew_tables()]
    out = open(args.out, "a") if args.out else None
    try:
        for name, ids, Ci, Cj, S in cases:
            ops = pair_operands(rng, ids, Ci, Cj, S)
            kw = dict(Ci=Ci, Cj=Cj, S=S)
            ref = fusedpair.fused_pair_apply_reference(*ops, **kw)
            graph = {}
            for vname, fname in VARIANTS:
                fn = getattr(fusedpair, fname)
                got = fn(*ops, **kw)
                err = max_rel_err((got,) if vname.startswith("v1_") else got, ref)
                eager, graph[vname] = per_launch_ms(lambda: fn(*ops, **kw), args.n)
                emit({"name": name, "variant": vname, "W": ids.shape[0], "N": ids.shape[1],
                      "S": S, "eager_ms": eager, "graph_ms": graph[vname], "rel_err": err,
                      "card": smi}, out)
            emit({"name": name, "W": ids.shape[0], "N": ids.shape[1], "S": S,
                  "cluster_size": fusedpair.CLUSTER_SIZE,
                  "split_graph_ms": split(fusedpair, ops, kw, args.n, graph), "card": smi}, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
