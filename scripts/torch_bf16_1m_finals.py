"""The spread of chip_smoke.py phase 9's uniform 1M LM solve under
block_dtype="bf16" (and of phase 28(b)'s under double_precision): K solves
of the checkout given, each through that checkout's own chip_smoke.py
helpers and kernels, every step's cost, and whether each run passes the old
single end point (final cost at most 1e-2 x the initial).  The readings
behind chip_smoke.py's BF16_RULE.  To compare two checkouts, run them
alternately in one call:

    for t in PARENT . . PARENT; do python3 scripts/torch_bf16_1m_finals.py $t 6; done
    python3 scripts/torch_bf16_1m_finals.py . 12 --double [--scene w10]
    python3 scripts/torch_bf16_1m_finals.py TREE 6 --rule uniform

--scene uniform (the default) is synthetic_inputs(1024, 250000, 4), w10
synthetic_inputs(1024, 100000, 10) (phase 28); --double plans under
double_precision.  Each scene is generated once (seeded) and kept in
build/ beside this script's checkout (build/ab_scene.npz for the uniform
one, as scripts/torch_slice_ab.py keeps it).  --rule KEY also holds every
BF16_1M_RUNS consecutive runs by the checkout's hold_bf16_runs at
BF16_RULE[KEY] and reports which groups pass.  One JSON line per call,
with the card's name and power limit.  Needs CUDA.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

BUILD = Path(__file__).resolve().parents[1] / "build"
SCENES = {"uniform": ("BA_1M", BUILD / "ab_scene.npz"), "w10": ("BA_10", BUILD / "w10_scene.npz")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".")
    ap.add_argument("k", nargs="?", type=int, default=6)
    ap.add_argument("--double", action="store_true")
    ap.add_argument("--scene", choices=sorted(SCENES), default="uniform")
    ap.add_argument("--rule", help="a BF16_RULE key of the checkout's chip_smoke.py")
    a = ap.parse_args(argv)
    tree = str(Path(a.tree).resolve())
    sys.path[:0] = [tree, tree + "/scripts"]
    import numpy as np

    import chip_smoke as cs
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.ops import _cuda

    _cuda.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    shape, path = SCENES[a.scene]
    shape = getattr(cs, shape)
    if path.exists():
        inputs = dict(np.load(path))
    else:
        inputs = cs.make_scene(ba, *shape)[0]
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **inputs)
    dims = {"C": shape[0], "P": shape[1], "O": len(inputs["oToC"])}
    pair = ("fused_pair_apply_bf16_f64" if a.scene == "uniform" else
            "fused_pair_apply_wloop_bf16_f64") if a.double else "fused_pair_apply_bf16"
    runs = []
    for _ in range(a.k):
        costs = cs.solve_1m(ba, tt, (inputs, dims), "1M block-sparse bf16", (pair,),
                            block_dtype="bf16", double=a.double)[0]
        runs.append({"initial": costs[0], "step1": costs[1], "final": costs[-1],
                     "passes_gate": costs[-1] <= 1e-2 * costs[0], "costs": costs})
    out = {"tree": tree, "card": card, "scene": a.scene, "double": a.double, "runs": runs}
    if a.rule:
        n, held = cs.BF16_1M_RUNS, []
        for i in range(0, len(runs) - n + 1, n):
            try:
                cs.hold_bf16_runs(f"runs {i + 1}-{i + n}", [r["costs"] for r in runs[i:i + n]],
                                  cs.BF16_RULE[a.rule])
                held.append(True)
            except AssertionError as exc:
                print(f"rule {a.rule}: {exc}", file=sys.stderr)
                held.append(False)
        out["rule"] = {"key": a.rule, "limits": cs.BF16_RULE[a.rule], "groups_pass": held}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
