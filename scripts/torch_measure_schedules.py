"""The measure-every-candidate schedule search on the card: the port's
counterpart of scripts/measure_schedules.py.

    python3 scripts/torch_measure_schedules.py [--model image_warping|arap]
        [--max-candidates 8] [--side N] [--out-dir chiprun_out]

Plans the model with use_autoscheduler = 3, 4, ... (thallo_tpu_torch/
autotune.py), times 3 GN steps of each candidate (10 PCG iterations)
after one untimed step, and logs each candidate's measured ms a step
beside its estimated bytes to <out-dir>/schedules_<model>_cuda.txt; every
measurement goes to the store <out-dir>/measurements_cuda.json (unless
THALLO_MEASUREMENTS names another), which a later use_autoscheduler=1
plan reads.  The log's first line gives the card's name and power limit.
Needs CUDA.
"""
import argparse
import os
import sys
from pathlib import Path

from torch_measure import card


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("image_warping", "arap"), default="image_warping")
    ap.add_argument("--max-candidates", type=int, default=8)
    ap.add_argument("--side", type=int, default=None,
                    help="grid side (default 256 for image_warping, 64 for arap)")
    ap.add_argument("--out-dir", default="chiprun_out")
    args = ap.parse_args()
    name = card()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("THALLO_MEASUREMENTS", str(out / "measurements_cuda.json"))
    from thallo_tpu_torch.autotune import autoschedule_search

    if args.model == "image_warping":
        from thallo_tpu_torch.models import image_warping as m

        side = args.side or 256
        sizes = {"W": side, "H": side}

        def make():
            return m.synthetic_inputs(side, side)
    else:
        from thallo_tpu_torch.models import arap_mesh_deformation as m

        side = args.side or 64
        sizes = {"N": side * side, "E": len(m.synthetic_inputs(side=side)["V0"])}

        def make():
            return m.synthetic_inputs(side=side)
    log_path = out / f"schedules_{args.model}_cuda.txt"
    with open(log_path, "a") as f:
        f.write(f"=== measured autoschedule search: {args.model} {side} on {name} ===\n")
    _, results = autoschedule_search(m.make_spec, sizes, make, n_steps=3, l_iters=10,
                                     max_candidates=args.max_candidates,
                                     log_path=str(log_path), verbose=True, device="cuda")
    best = min(results, key=lambda r: r[2])
    with open(log_path, "a") as f:
        f.write(f"best: candidate {best[0]} {best[1]} {best[2] * 1e3:.3f} ms/step\n")
    print("wrote", log_path)


if __name__ == "__main__":
    sys.exit(main())
