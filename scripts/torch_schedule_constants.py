"""The machine constants of the port's autoscheduler
(thallo_tpu_torch/schedule.py), measured on the card.

    python3 scripts/torch_schedule_constants.py [--n 50] [--out FILE]

The schedule model prices each row of a graph slot's gather and scatter as
the bytes the card would stream in that time at HBM_BYTES_PER_S (3.35e12,
the H100's data-sheet rate), as thallo_tpu/schedule.py prices its TPU's:
time per row x HBM_BYTES_PER_S.  Timed here, with CUDA events over n calls
after a warm-up, at the graph slots of the two graph workloads at full size:

  BA 1M       [9, 1M] into 1024 cameras (each point's 4 cameras drawn as
              bundle_adjustment.synthetic_inputs draws them), [3, 1M] into
              250 000 points (4 observations each, point-major)
  ARAP 256²   [3, 261 120] into 65 536 vertices, at V0 and at V1
              (arap_mesh_deformation.synthetic_inputs(side=256))

  scatter     index_add_ along the rows of a channel-major [C, M] buffer
              (the port's scatter where no kernel route applies); beside
              it, the port's own route (lower.scatter_route: the
              aggregation kernel for the 1024 cameras, index_add_ else)
  gather      index_select of [C, N] at the M ids (the port's gather)

SCATTER_ROW_EQ_BYTES and GATHER_ROW_EQ_BYTES are the means of index_add_'s
and index_select's per-row costs over the four slots, each slot weighted
alike: the model charges one cost to every gathered slot.
EFFECTIVE_ELEMENTWISE_FLOPS is the rate of the port's eager elementwise
code: a chain of 32 unary and binary torch ops over [1M] f32, op-elements
per second.  One JSON line with every time and the derived constants,
and the card's name and power limit.  Needs CUDA.
"""
import argparse
import sys

import numpy as np
import torch

from torch_measure import card, eager_ms, emit

HBM_BYTES_PER_S = 3.35e12


def ba_ids(n_cameras=1024, n_points=250_000, obs_per_point=4, seed=0):
    """Camera and point ids of the BA 1M scene's observations, drawn as
    bundle_adjustment.synthetic_inputs draws them (point-major, each point
    seen by obs_per_point distinct cameras)."""
    rng = np.random.RandomState(seed)
    cams = np.concatenate([rng.choice(n_cameras, size=obs_per_point, replace=False)
                           for _ in range(n_points)])
    pts = np.repeat(np.arange(n_points), obs_per_point)
    return cams.astype(np.int32), pts.astype(np.int32)


def slot_cases():
    from thallo_tpu_torch.models import arap_mesh_deformation as arap

    cams, pts = ba_ids()
    ins = arap.synthetic_inputs(side=256)
    v0, v1 = (np.asarray(ins[k], np.int32) for k in ("V0", "V1"))
    return [("ba_1m_cameras", 9, cams, 1024), ("ba_1m_points", 3, pts, 250_000),
            ("arap_256_v0", 3, v0, 65_536), ("arap_256_v1", 3, v1, 65_536)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50, help="timed calls per case")
    ap.add_argument("--out", type=argparse.FileType("a"), default=None)
    args = ap.parse_args()
    name = card()
    from thallo_tpu_torch.lower import ONEHOT_MAX_SEGMENTS, scatter_route

    rec = {"script": "torch_schedule_constants", "card": name, "n": args.n, "slots": []}
    g = torch.Generator(device="cuda").manual_seed(0)
    for tag, C, ids_np, N in slot_cases():
        M = len(ids_np)
        ids32 = torch.from_numpy(ids_np).cuda()
        idx = ids32.long()
        vals = torch.randn((C, M), generator=g, device="cuda")
        src = torch.randn((C, N), generator=g, device="cuda")
        out = torch.zeros((C, N), device="cuda")
        agg = ids32 if N <= ONEHOT_MAX_SEGMENTS and M > 4 * N else None
        t_add = eager_ms(lambda: out.zero_().index_add_(1, idx, vals), args.n) - \
            eager_ms(lambda: out.zero_(), args.n)
        t_route = eager_ms(lambda: scatter_route(vals, idx, None, agg, N), args.n)
        t_sel = eager_ms(lambda: src.index_select(1, idx), args.n)
        row = {"slot": tag, "C": C, "M": M, "N": N,
               "index_add_ms": t_add, "route_ms": t_route,
               "route": "oh_setup_aggregate" if agg is not None else "index_add_",
               "index_select_ms": t_sel}
        for k in ("index_add", "route", "index_select"):
            row[f"{k}_row_eq_bytes"] = row[f"{k}_ms"] * 1e-3 / M * HBM_BYTES_PER_S
        rec["slots"].append(row)
    N = 1_000_000
    x = torch.rand(N, generator=g, device="cuda")
    a = torch.rand(N, generator=g, device="cuda")

    def chain():
        v = x
        for _ in range(8):  # 4 ops a round, 32 in all
            v = torch.sin(v) * a
            v = torch.exp(-v) + a
        return v

    t_chain = eager_ms(chain, args.n)
    rec["elementwise"] = {"ops": 32, "elements": N, "ms": t_chain}
    rec["HBM_BYTES_PER_S"] = HBM_BYTES_PER_S
    rec["SCATTER_ROW_EQ_BYTES"] = float(np.mean([r["index_add_row_eq_bytes"]
                                                 for r in rec["slots"]]))
    rec["GATHER_ROW_EQ_BYTES"] = float(np.mean([r["index_select_row_eq_bytes"]
                                                for r in rec["slots"]]))
    rec["EFFECTIVE_ELEMENTWISE_FLOPS"] = 32 * N / (t_chain * 1e-3)
    print(name)
    emit(rec, args.out)


if __name__ == "__main__":
    sys.exit(main())
