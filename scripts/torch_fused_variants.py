"""Where the fused pair's cols output costs time, on the card: the
counterpart of scripts/tpu_fused_variants.py.

    python3 scripts/torch_fused_variants.py [--n 50] [--out FILE]

Four forms of the bf16-block fused pair (csrc/fused_pair_variants.cu):
  v0_atomics   both outputs, cols by one global atomic per value
               (fused_pair_bf16, the micro script's kernel)
  v1_rows_only no cols output
  v2_smem      cols summed in a shared [Cj, S] accumulator per block, one
               global atomic per nonzero entry per block
  v3_partials  per-block cols slabs [G, Cj, S], summed outside the kernel
on the JAX script's cases (ba_1m_pt_cam, skew_level_w8: random ids) and
on the skewed 1M BA scene's real level-0 and widest col tables, where
the cameras' power-law degrees put many of a block's values on one
camera.  One JSON line per (case, variant): ms per launch over n
launches eager and in one CUDA graph (CUDA events), and the error
against the plain torch version.  Needs CUDA.
"""
import argparse
import sys

import numpy as np

from torch_measure import (JAX_CASES, card, emit, max_rel_err, pair_operands, per_launch_ms,
                           random_ids, skew_tables)

VARIANTS = [("v0_atomics", "fused_pair_bf16"), ("v1_rows_only", "fused_pair_v1_rows"),
            ("v2_smem", "fused_pair_v2_smem"), ("v3_partials", "fused_pair_v3_partials")]


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
            for vname, fname in VARIANTS:
                fn = getattr(fusedpair, fname)
                got = fn(*ops, **kw)
                err = max_rel_err((got,) if vname == "v1_rows_only" else got, ref)
                eager, graph = per_launch_ms(lambda: fn(*ops, **kw), args.n)
                emit({"name": name, "variant": vname, "W": ids.shape[0], "N": ids.shape[1],
                      "S": S, "eager_ms": eager, "graph_ms": graph, "rel_err": err,
                      "card": smi}, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
