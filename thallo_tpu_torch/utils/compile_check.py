"""Compile-only smoke harness: load an energy file, bind small dims, plan
it and run one step on zero-filled inputs, without a solve (counterpart of
``thallo_tpu/utils/compile_check.py``).

JAX's version traces the step abstractly (``jax.eval_shape``: no data,
no execution) on the default backend.  Eager PyTorch has no abstract
trace, so the port runs the step once instead, on the plan's device (the
card by default, as every entry point; ``device="cpu"`` runs the plain
versions of the kernels), on inputs of the planned shapes filled with
zeros (every sparse-map index 0, which is a valid index): every lowering
and shape error shows up as it would in a solve; the values it computes
are not looked at.  Without CUDA the default raises, as ``plan`` does.
Usable from the command line:

    python -m thallo_tpu_torch.utils.compile_check path/to/energy.py [dim ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def compile_check(path: str, default_dim: int = 32, dims=None, solver="levenberg_marquardt",
                  device="cuda"):
    """Returns the Plan (on `device`) after one nonlinear_step on zero
    inputs; raises on any lowering or shape error, and where the card is
    asked for without CUDA, as plan does (device="cpu" runs the plain
    versions)."""
    from ..lib_env import load_energy_file

    spec = load_energy_file(path)
    sizes = dims or {d.name: default_dim for d in spec.dims}
    plan = spec.plan(sizes, solver=solver, device=device)
    inputs = {}
    for im in list(spec.unknowns) + list(spec.arrays):
        inputs[im.name] = np.zeros(tuple(d.size for d in im.dims) + (im.channels,), np.float32)
    for sm in spec.sparse_maps:
        inputs[sm.name] = np.zeros(tuple(d.size for d in sm.in_dims) + (len(sm.out_dims),),
                                   np.int32)
    for p in spec.params:
        inputs[p.name] = 0.0
    plan.init(inputs)
    plan.compiled.nonlinear_step(plan._U, plan._lm, plan._step_inputs(), plan._sp(), plan._prep)
    return plan


def main(argv):
    if not argv:
        print("usage: python -m thallo_tpu_torch.utils.compile_check <energy.py> [N ...] "
              "[--device {cuda,cpu}]")
        return 2
    ap = argparse.ArgumentParser(prog="python -m thallo_tpu_torch.utils.compile_check")
    ap.add_argument("energy")
    ap.add_argument("dims", nargs="*", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the step runs (cuda needs an NVIDIA GPU; no fallback)")
    args = ap.parse_args(argv)
    plan = compile_check(args.energy, dims=args.dims or None, device=args.device)
    print(f"compile ok: {len(plan.compiled.groups)} group(s): "
          + ", ".join(f"{g.name}[{g.schedule.value}]" for g in plan.compiled.groups))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
