"""The spread of chip_smoke.py phase 9's uniform 1M LM solve under
block_dtype="bf16": K solves of the checkout given, each through that
checkout's own chip_smoke.py helpers and kernels, and their costs after
step 1 and after the last step, against phase 9's gate (final cost at most
1e-2 x the initial).  To compare two checkouts, run them alternately in
one call:

    for t in PARENT . . PARENT; do python3 scripts/torch_bf16_1m_finals.py $t 6; done

The uniform 1M scene is generated once (seeded) and kept in
build/ab_scene.npz beside this script's checkout, as
scripts/torch_slice_ab.py keeps it.  One JSON line per run, with the
card's name and power limit.  Needs CUDA.
"""
import json
import subprocess
import sys
from pathlib import Path

SCENE = Path(__file__).resolve().parents[1] / "build" / "ab_scene.npz"


def main(argv=None):
    argv = argv or sys.argv[1:]
    tree, k = str(Path(argv[0] if argv else ".").resolve()), int(argv[1] if len(argv) > 1 else 6)
    sys.path[:0] = [tree, tree + "/scripts"]
    import numpy as np

    import chip_smoke as cs
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.ops import _cuda

    _cuda.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    if SCENE.exists():
        inputs = dict(np.load(SCENE))
    else:
        inputs = cs.make_scene(ba, *cs.BA_1M)[0]
        SCENE.parent.mkdir(parents=True, exist_ok=True)
        np.savez(SCENE, **inputs)
    dims = {"C": cs.BA_1M[0], "P": cs.BA_1M[1], "O": len(inputs["oToC"])}
    runs = []
    for _ in range(k):
        costs = cs.solve_1m(ba, tt, (inputs, dims), "1M block-sparse bf16",
                            ("fused_pair_apply_bf16",), block_dtype="bf16")[0]
        runs.append({"initial": costs[0], "step1": costs[1], "final": costs[-1],
                     "passes_gate": costs[-1] <= 1e-2 * costs[0]})
    print(json.dumps({"tree": tree, "card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
