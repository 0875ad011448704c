"""How often the uniform 1M BA LM solve ends in each cost mode after 10
steps, eager and graphed: the reading behind chip_smoke.py's
DISPATCH_EAGER_RUNS.

    python3 scripts/torch_lm_modes.py [--runs 6] [--scene-cache FILE]

The scene of chip_smoke.py's phase 4 (synthetic_inputs(1024, 250000, 4,
seed=0)); each run a fresh plan, warmup(), run_steps(5) twice: eager
(steps_per_dispatch=1) and graphed (steps_per_dispatch=5) in turn,
--runs of each.  One JSON line: the costs after 5 and 10 steps of every
run.  Near convergence the LM accepts split the runs (the card's atomics
sum in another order each run) into a mode near 4.5 and one near 6.2
from c0 6 972 748.  --scene-cache keeps the generated scene (~1 min) in an
.npz for the next call.  Needs CUDA.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--scene-cache", default=None)
    a = ap.parse_args(argv)
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    if a.scene_cache and os.path.exists(a.scene_cache):
        with np.load(a.scene_cache) as z:
            inputs = {k: z[k] for k in z.files}
    else:
        inputs, _ = ba.synthetic_inputs(n_cameras=1024, n_points=250000, obs_per_point=4,
                                        seed=0)
        if a.scene_cache:
            np.savez(a.scene_cache, **inputs)
    dims = {"C": 1024, "P": 250000, "O": len(inputs["oToC"])}
    out = {"eager": [], "graphed": []}
    for _ in range(a.runs):
        for kind, k in (("eager", 1), ("graphed", 5)):
            plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt",
                                                  device="cuda", steps_per_dispatch=k)
            plan.set_solver_parameter("nIterations", 100)
            plan.init({n: np.copy(v) for n, v in inputs.items()})
            plan.warmup()
            costs = []
            for _ in range(2):
                plan.run_steps(5)
                costs.append(plan.cost())
            out[kind].append(costs)
            del plan
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
