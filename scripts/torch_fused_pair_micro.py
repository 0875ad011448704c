"""The fused cross pair with bf16 block storage on the card: the
counterpart of scripts/tpu_fused_pair_micro.py.

    python3 scripts/torch_fused_pair_micro.py [--n 50] [--out FILE]

For each of the JAX script's cases (ba_1m_pt_cam, ba_250k_pt_cam,
skew_level_w8, skew_level_w2: random ids, seeded) and for the skewed 1M
BA scene's real level-0 and widest col tables (after the residual sort;
random ids never show the hot camera's contention), it runs
``fused_pair_bf16`` (bf16 blocks, f32 elsewhere), checks it against the
plain torch version, and prints one JSON line: ms per launch over n
launches eager and in one CUDA graph (CUDA events), the plain version's
ms, and beside them the solver's f32 kernel on the same values
(the kernel fused_pair_route names for the shape), eager.  The JAX
script timed inside one lax.while_loop dispatch; the graph time is the
counterpart.  Needs CUDA.
"""
import argparse
import sys

import numpy as np

from torch_measure import (JAX_CASES, card, eager_ms, emit, max_rel_err, pair_operands,
                           per_launch_ms, random_ids, skew_tables)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50, help="launches per timing")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    smi = card()
    from thallo_tpu_torch.ops import fusedpair

    rng = np.random.default_rng(0)
    cases = [(name, random_ids(rng, W, N, S), Ci, Cj, S) for name, Ci, Cj, W, S, N in JAX_CASES]
    cases += [(name, ids, 3, 9, 1024) for name, ids in skew_tables()]
    out = open(args.out, "a") if args.out else None
    try:
        for name, ids, Ci, Cj, S in cases:
            W, N = ids.shape
            ops = pair_operands(rng, ids, Ci, Cj, S)
            f32 = (ops[0], ops[1].float(), *ops[2:])
            kw = dict(Ci=Ci, Cj=Cj, S=S)
            err = max_rel_err(fusedpair.fused_pair_bf16(*ops, **kw),
                              fusedpair.fused_pair_apply_reference(*ops, **kw))
            eager, graph = per_launch_ms(lambda: fusedpair.fused_pair_bf16(*ops, **kw), args.n)
            plain = eager_ms(lambda: fusedpair.fused_pair_apply_reference(*ops, **kw),
                             max(1, args.n // 10))
            f32_fn = getattr(fusedpair, fusedpair.fused_pair_route(W, N, Ci, Cj, S))
            f32_ms = eager_ms(lambda: f32_fn(*f32, **kw), args.n)
            block_mb = ops[1].numel() * 2 / 1e6
            emit({"name": name, "Ci": Ci, "Cj": Cj, "W": W, "S": S, "N": N,
                  "bf16_eager_ms": eager, "bf16_graph_ms": graph, "plain_ms": plain,
                  f"{f32_fn.__name__}_f32_ms": f32_ms, "block_mb": block_mb,
                  "bf16_graph_gbps": block_mb / 1e3 / (graph / 1e3), "rel_err": err,
                  "card": smi}, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
