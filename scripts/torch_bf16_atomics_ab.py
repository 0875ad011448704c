"""Time fused_pair_bf16_atomics (csrc/fused_pair_variants.cu mode 0, the
bf16 atomics body of the fused pair) of the checkout given, on the card:
BA's (3, 9) pair at [4, 250 000] into 1 024 cameras, and wide levels of 9
and 16 row channels at [12, 16 384] into as many columns (a checkout whose
body takes Ci <= 8 reports the refusal).  Three `device_ms` readings each
(10 calls in a CUDA graph, 5 replays; scripts/torch_measure.py).  To
compare two checkouts, run them alternately in one call:

    for t in PARENT . . PARENT; do python3 scripts/torch_bf16_atomics_ab.py $t; done

One JSON line per run, with the card's name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((4, 250000, 1024, 3, 9), (12, 16384, 16384, 9, 3), (12, 16384, 16384, 16, 3))


def main(argv=None):
    tree = str(Path((argv or sys.argv[1:] or ["."])[0]).resolve())
    sys.path[:0] = [tree, tree + "/scripts", str(Path(__file__).resolve().parent)]
    import numpy as np
    import torch
    from thallo_tpu_torch.ops import _cuda, fusedpair
    from torch_measure import graph_ms

    _cuda.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"tree": tree, "card": card}
    for W, N, S, Ci, Cj in SHAPES:
        ids = torch.from_numpy(rng.integers(0, S, size=(W, N)).astype(np.int32)).to(dev)
        blocks = torch.from_numpy(rng.normal(size=(W * Ci * Cj, N)).astype(np.float32)).to(
            dev).bfloat16()
        pcol = torch.from_numpy(rng.normal(size=(Cj, S)).astype(np.float32)).to(dev)
        prow = torch.from_numpy(rng.normal(size=(Ci, N)).astype(np.float32)).to(dev)

        def fn():
            return fusedpair.fused_pair_bf16_atomics(ids, blocks, pcol, prow, Ci=Ci, Cj=Cj, S=S)

        try:
            fn()
            torch.cuda.synchronize()
            out[f"{Ci}x{Cj}"] = [graph_ms(fn, 10, 5) for _ in range(3)]
        except ValueError as exc:
            out[f"{Ci}x{Cj}"] = f"refused: {exc}"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
