"""End-to-end numbers of the checkout given, on the card, for comparing two
checkouts (a change against its parent) in one call: ARAP 256² GN
(grouped edges, lIterations 10) as chip_smoke.py's phases 16 and 24 time
it, the marginal PCG iteration eagerly and graphed (steps_per_dispatch 3;
steps at lIterations 10 and 110) and the graphed step (solve() at
steps_per_dispatch 10, the first step eager); and BA 1M INLINE in f64
under THALLO_SEGSUM=tiled (phase 23(b)'s solve, use_autoscheduler=4):
the step times of 1 + N_BA_STEPS LM steps.  Each number comes from the
checkout's own chip_smoke.py helpers and kernels.  Run them alternately:

    for t in PARENT . . PARENT; do python3 scripts/torch_slice_ab.py $t; done

The uniform 1M scene is generated once (seeded) and kept in
build/ab_scene.npz beside this script's checkout for the later runs.  One
JSON line per run, with the card's name and power limit.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N_BA_STEPS = 3
SCENE = Path(__file__).resolve().parents[1] / "build" / "ab_scene.npz"


def main(argv=None):
    tree = str(Path((argv or sys.argv[1:] or ["."])[0]).resolve())
    sys.path[:0] = [tree, tree + "/scripts"]
    import numpy as np
    import torch

    import chip_smoke as cs
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.ops import _cuda

    _cuda.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"tree": tree, "card": card}

    lo, hi = cs.ARAP_MARGINAL
    for k in (1, cs.ARAP_MARGINAL_STEPS):
        plan = cs.arap_plan(tt, cs.ARAP_SIDE, "grouped", "cuda", n_iter=1000,
                            steps_per_dispatch=k)
        times = {}
        for li in cs.ARAP_MARGINAL:
            plan.set_solver_parameter("lIterations", li)
            plan.run_steps(cs.ARAP_MARGINAL_STEPS)  # warm (k > 1: the capture)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.run_steps(cs.ARAP_MARGINAL_STEPS)
            torch.cuda.synchronize()
            times[li] = (time.perf_counter() - t0) / cs.ARAP_MARGINAL_STEPS
        out[f"arap_marginal_ms_k{k}"] = (times[hi] - times[lo]) / (hi - lo) * 1e3
        del plan
    plan = cs.arap_plan(tt, cs.ARAP_SIDE, "grouped", "cuda",
                        steps_per_dispatch=cs.DISPATCH_GRID_K)
    plan.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["arap_final_cost"] = plan.solve()
    out["arap_graphed_step_ms"] = (time.perf_counter() - t0) / plan.num_iterations * 1e3
    del plan

    if SCENE.exists():
        inputs = dict(np.load(SCENE))
    else:
        inputs = cs.make_scene(ba, *cs.BA_1M)[0]
        SCENE.parent.mkdir(parents=True, exist_ok=True)
        np.savez(SCENE, **inputs)
    dims = {"C": cs.BA_1M[0], "P": cs.BA_1M[1], "O": len(inputs["oToC"])}
    os.environ["THALLO_SEGSUM"] = "tiled"  # read by plan.init
    try:
        plan = cs.ba_plan(ba, tt, inputs, dims, "cuda", 1 + N_BA_STEPS, use_autoscheduler=4,
                          double=True)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
    finally:
        os.environ.pop("THALLO_SEGSUM", None)
    steps = []
    for _ in range(1 + N_BA_STEPS):
        t0 = time.perf_counter()
        plan.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    out["ba1m_inline_f64_tiled_step_ms"] = steps
    out["ba1m_inline_f64_tiled_cost"] = plan.cost()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
