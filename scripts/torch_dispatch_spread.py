"""How often chip_smoke.py's phase-24(d) rule (within_spread: a graphed run
within DISPATCH_SPREAD_X times the eager runs' spread, or the floors)
fails on small paths of scripts/torch_dispatch_paths.py with no fault,
and whether a path's graphed runs lie farther from its eager runs than
its eager runs lie from each other.

    python3 scripts/torch_dispatch_spread.py [TREE] [--path NAME ...] [--eager 24]
        [--graphed 8] [--steps 2] [--counts 5 12] [--draws 4000] [--device cuda]
        [--out FILE]

For each path: many eager runs (steps_per_dispatch=1) and graphed runs
(steps_per_dispatch=2, through warmup()'s capture) of it, each from
the same seeded inputs, run_steps(--steps); every run's distance from
every other (max|dU|/max|U|, relative cost: torch_dispatch_paths._dist).
Then, for each count m of eager runs in --counts, --draws random draws of
m eager runs, each held by the rule against one more run: a held-out
eager run (the null: nothing differs but the order of the atomics' sums)
and a graphed run.  The two failure rates are the rule's false-failure
rate at m eager runs and its rate on graphed runs; a fault in the graph
shows as a graphed rate well above the null's.  TREE: the checkout whose
package, chip_smoke.py and scripts run (default: this one's), so that a
change and its parent are read in one call.  One JSON line a path, with
the card's name and power limit, every distance, and the quantiles of the
tested run's farthest distance over the spread (unknowns, cost).  Needs CUDA, but for
--device cpu (the CPU's dispatch, no graph: a check of the script).
"""
import argparse
import json
import random
import subprocess
import sys
from pathlib import Path


def spread_of(cs, dp, make, args):
    """The record of one path (the module docstring) but its name."""
    import torch

    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    runs, kinds = [], []
    for kind, n, options in (("eager", args.eager, {}),
                             ("graphed", args.graphed, {"steps_per_dispatch": 2})):
        for _ in range(n):
            plan = make(args.device, **options)
            plan.warmup()
            plan.run_steps(args.steps)
            sync()
            runs.append(dp._state(plan))
            kinds.append(kind)
            del plan
    n = len(runs)
    dist = [[dp._dist(runs[i], runs[j]) if i != j else (0.0, 0.0) for j in range(n)]
            for i in range(n)]
    eager = [i for i, k in enumerate(kinds) if k == "eager"]
    graphed = [i for i, k in enumerate(kinds) if k == "graphed"]
    rng = random.Random(0)

    def held(chosen, t):
        """The rule of check_path and phase 24(d): spread over the chosen
        eager runs' pairs, the tested run's distance from the farthest."""
        pairs = [dist[a][b] for x, a in enumerate(chosen) for b in chosen[x + 1:]]
        spread = tuple(max(p[c] for p in pairs) for c in range(2))
        far = tuple(max(dist[e][t][c] for e in chosen) for c in range(2))
        return cs.within_spread(spread, far)[0], [f / max(s, 1e-30) for f, s in zip(far, spread)]

    def q(xs):
        return [[sorted(x[c] for x in xs)[int(f * (len(xs) - 1))] for f in (0.5, 0.9, 0.99)]
                for c in range(2)] if xs else None

    rates = {}
    for m in args.counts:
        if m + 1 > len(eager):
            continue
        null_fail = graph_fail = 0
        null_ratio, graph_ratio = [], []
        for _ in range(args.draws):
            pick = rng.sample(eager, m + 1)
            ok, r = held(sorted(pick[:m]), pick[m])
            null_fail += not ok
            null_ratio.append(r)
            if graphed:
                ok, r = held(sorted(pick[:m]), rng.choice(graphed))
                graph_fail += not ok
                graph_ratio.append(r)
        rates[m] = {"null_fail": null_fail / args.draws,
                    "graphed_fail": graph_fail / args.draws if graphed else None,
                    "null_far_over_spread_q50_q90_q99": q(null_ratio),
                    "graphed_far_over_spread_q50_q90_q99": q(graph_ratio)}
    return {"steps": args.steps, "eager": len(eager), "graphed": len(graphed),
            "floors": [cs.STEP_U_TOL, cs.STEP_COST_RTOL], "spread_x": cs.DISPATCH_SPREAD_X,
            "rates": rates, "kinds": kinds, "dist": dist}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--path", nargs="*", default=["ba skewed level tables LM"])
    ap.add_argument("--eager", type=int, default=24)
    ap.add_argument("--graphed", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--counts", type=int, nargs="*", default=[5, 12])
    ap.add_argument("--draws", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs an NVIDIA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    tree = str(Path(args.tree).resolve())
    sys.path[:0] = [tree, tree + "/scripts"]
    import chip_smoke as cs
    import thallo_tpu_torch as tt
    import torch_dispatch_paths as dp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip() \
        if args.device == "cuda" else "cpu"
    makes = dp.paths(tt)
    for path in args.path:
        rec = spread_of(cs, dp, makes[path], args)
        line = json.dumps({"tree": tree, "card": card, "path": path, **rec})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
