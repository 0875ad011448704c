"""Time the block-sparse path's f32 kernels of the checkout given, on the
card, at the uniform 1M scene's shapes: fused_pair_apply (the persistent
kernel, W 4, N 250 000, S 1 024), fused_pair_apply_atomics at ARAP 256²'s
(3, 3) shape ([4, 65 536]), oh_setup_products ([2 + 18, 1M] into 1 024
cameras), fullrepeat_setup (the point level, [2 + 24, 1M]) and
oh_setup_aggregate ([9, 1M] into 1 024).  Three `device_ms` readings each
(10 calls in a CUDA graph, 5 replays; scripts/torch_measure.py).  To
compare two checkouts (a change to a kernel source against its parent),
run them alternately in one call:

    for t in PARENT . . PARENT; do python3 scripts/torch_kernels_ab.py $t; done

One JSON line per run, with the card's name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None):
    tree = str(Path((argv or sys.argv[1:] or ["."])[0]).resolve())
    sys.path[:0] = [tree, tree + "/scripts", str(Path(__file__).resolve().parent)]
    import numpy as np
    import torch
    from thallo_tpu_torch.ops import _cuda, fullrepeat, fusedpair, ohsetup
    from torch_measure import graph_ms

    _cuda.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    R, N, P, W = 1_000_000, 1024, 250_000, 4
    ids = t(rng.integers(0, N, (W, P)), np.int32)
    pair = (ids, t(rng.normal(size=(W * 27, P))), t(rng.normal(size=(9, N))),
            t(rng.normal(size=(3, P))))
    S = 65536
    arap = (t(rng.integers(0, S, (4, S)), np.int32), t(rng.normal(size=(36, S))),
            t(rng.normal(size=(3, S))), t(rng.normal(size=(3, S))))
    cams = t(rng.integers(0, N, R), np.int32)
    prod = (t(rng.normal(size=(2, R))), t(rng.normal(size=(18, R))), cams)
    win = (t(rng.normal(size=(2, R))), t(rng.normal(size=(24, R))))
    parts = t(rng.normal(size=(9, R)))
    oh_recipe = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))
    fr_recipe = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 6, 9, 0), ("diag", 0, 3, 0, 3))
    calls = {
        "fused_pair_apply": lambda: fusedpair.fused_pair_apply(*pair, Ci=3, Cj=9, S=N),
        "fused_pair_apply_atomics": lambda: fusedpair.fused_pair_apply_atomics(
            *arap, Ci=3, Cj=3, S=S),
        "oh_setup_products": lambda: ohsetup.oh_setup_products(*prod, N=N, recipe=oh_recipe),
        "fullrepeat_setup": lambda: fullrepeat.fullrepeat_setup(*win, W=W, N_t=P,
                                                                recipe=fr_recipe),
        "oh_setup_aggregate": lambda: ohsetup.oh_setup_aggregate(parts, cams, N=N),
    }
    out = {"tree": tree, "card": card}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        out[name] = [graph_ms(fn, 10, 5) for _ in range(3)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
