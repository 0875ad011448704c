"""Compile-only smoke harness: load an energy file, bind small dims, plan
it and run one step of the plain path on zero-filled inputs, without a
solve (counterpart of ``thallo_tpu/utils/compile_check.py``).

JAX's version traces the step abstractly (``jax.eval_shape``: no data,
no execution).  Eager PyTorch has no abstract trace, so the port runs the
step once instead, on the CPU, on inputs of the planned shapes filled with
zeros (every sparse-map index 0, which is a valid index): every lowering
and shape error shows up as it would in a solve; the values it computes
are not looked at.  Usable from the command line:

    python -m thallo_tpu_torch.utils.compile_check path/to/energy.py [dim ...]
"""
from __future__ import annotations

import sys

import numpy as np


def compile_check(path: str, default_dim: int = 32, dims=None, solver="levenberg_marquardt"):
    """Returns the Plan (on the CPU) after one nonlinear_step on zero
    inputs; raises on any lowering or shape error."""
    from ..lib_env import load_energy_file

    spec = load_energy_file(path)
    sizes = dims or {d.name: default_dim for d in spec.dims}
    plan = spec.plan(sizes, solver=solver, device="cpu")
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
        print("usage: python -m thallo_tpu_torch.utils.compile_check <energy.py> [N ...]")
        return 2
    dims = [int(a) for a in argv[1:]] or None
    plan = compile_check(argv[0], dims=dims)
    print(f"compile ok: {len(plan.compiled.groups)} group(s): "
          + ", ".join(f"{g.name}[{g.schedule.value}]" for g in plan.compiled.groups))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
