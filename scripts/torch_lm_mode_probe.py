"""Whether the spread of the uniform BA LM solve's final cost belongs to
LM's own trajectory or to the port: the JAX package's CPU plan and the
port's CPU plan from the same perturbed starts, side by side.

    JAX_PLATFORMS=cpu python3 scripts/torch_lm_mode_probe.py --block-dtype bf16 \
        [--starts 6] [--steps 10] [--out FILE]
    JAX_PLATFORMS=cpu python3 scripts/torch_lm_mode_probe.py --block-dtype f32

Scene: synthetic_inputs(1024, 25000, 4, seed=0), the keep size of the
uniform 1M scene (1024 cameras, 9 216 camera unknowns, as at 1M; a tenth
of its points).  LM, nIterations --steps, lIterations 10 (the defaults of
chip_smoke.py's phases 4 and 9), block-Jacobi, block_dtype "bf16" or f32
blocks.  Start k (1 .. --starts) moves every camera and point coordinate
x to x + 1e-7 |x| g with g normal noise seeded by k, in numpy, and hands
the same f32 inputs to both packages.  One JSON line per run: the package,
the start, the cost after every step (steps 1 and 3 and the last also
under their own keys); then one line per package with the smallest and
largest cost after step 1, step 3 and the last step, and a last line
saying whether the port's final costs lie inside JAX's range.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SCENE = (1024, 25000, 4)
L_ITERATIONS = 10


def perturbed(inputs, start):
    rng = np.random.default_rng(start)
    out = {k: np.copy(v) for k, v in inputs.items()}
    for name in ("cameras", "points"):
        x = out[name].astype(np.float64)
        out[name] = (x + 1e-7 * np.abs(x) * rng.normal(size=x.shape)).astype(np.float32)
    return out


def run(package, inputs, dims, block_dtype, steps):
    if package == "jax":
        import thallo_tpu as pkg
        from thallo_tpu.models import bundle_adjustment as ba
        options = {}
    else:
        import thallo_tpu_torch as pkg
        from thallo_tpu_torch.models import bundle_adjustment as ba
        options = {"device": "cpu"}
    if block_dtype == "bf16":
        options["block_dtype"] = "bf16"
    plan = pkg.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", **options)
    plan.set_solver_parameter("nIterations", steps)
    plan.set_solver_parameter("lIterations", L_ITERATIONS)
    costs = [float(plan.init(inputs))]
    for _ in range(steps):
        plan.step()
        costs.append(float(plan.cost()))
    return costs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block-dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--starts", type=int, default=6)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    a = ap.parse_args(argv)
    from thallo_tpu_torch.models import bundle_adjustment as ba

    base, _ = ba.synthetic_inputs(*SCENE, seed=0)
    dims = {"C": SCENE[0], "P": SCENE[1], "O": len(base["oToC"])}
    sink = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    finals = {}
    for package in a.packages.split(","):
        runs = []
        for start in range(1, a.starts + 1):
            t0 = time.perf_counter()
            costs = run(package, perturbed(base, start), dims, a.block_dtype, a.steps)
            runs.append(costs)
            emit({"package": package, "block_dtype": a.block_dtype, "scene": SCENE,
                  "start": start, "step1": costs[1], "step3": costs[min(3, a.steps)],
                  "final": costs[-1], "costs": costs, "seconds": time.perf_counter() - t0})
        summary = {k: [min(c[i] for c in runs), max(c[i] for c in runs)]
                   for k, i in (("step1", 1), ("step3", min(3, a.steps)), ("final", -1))}
        finals[package] = summary["final"]
        emit({"package": package, "block_dtype": a.block_dtype, "starts": a.starts,
              "initial": runs[0][0], "range": summary})
    if "jax" in finals and "torch" in finals:
        lo, hi = finals["jax"]
        emit({"block_dtype": a.block_dtype,
              "torch_finals_inside_jax_range": lo <= finals["torch"][0] and
              finals["torch"][1] <= hi, "jax": finals["jax"], "torch": finals["torch"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
