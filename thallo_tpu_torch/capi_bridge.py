"""Python side of the port's C API (thallo_tpu_torch/capi/): the
counterpart of ``thallo_tpu/capi_bridge.py``, an integer-handle registry
driven by the embedded-interpreter shim in
thallo_tpu_torch/capi/src/thallo_capi.cpp, with the same functions and
handles.

The analog of the reference's createwrapper.t problem/plan tables
(API/src/thallo.t:94-104 problemDefine/problemPlan and the void**
parameter marshalling, util.t:609-643): C passes raw host pointers;
shapes/dtypes come from the energy spec's declared inputs ordered by their
argument positions.  The plan runs on the card (``device="cuda"``) unless
``cpuOnly`` is set; without CUDA, planning raises and the C side returns
NULL.  ``doublePrecision`` plans in f64 (the f64 kernels on the card).
"""
from __future__ import annotations

import ctypes
import itertools

import numpy as np

_handles = itertools.count(1)
_states = {}
_problems = {}
_plans = {}


def new_state(double_precision=0, verbosity=0, timing=1, use_autoscheduler=0, cpu_only=0):
    h = next(_handles)
    _states[h] = {
        "double_precision": bool(double_precision),
        "verbosity": int(verbosity),
        "timing": int(timing),
        "use_autoscheduler": int(use_autoscheduler),
        "cpu_only": bool(cpu_only),
    }
    return h


def problem_define(state_h, filename, solverkind):
    h = next(_handles)
    _problems[h] = {"filename": filename, "solver": solverkind, "state": state_h}
    return h


def problem_delete(problem_h):
    _problems.pop(problem_h, None)


def problem_num_dims(problem_h):
    """Number of Dims() the energy declares (the length of the C
    `dimensions` array, reference Thallo_ProblemPlan)."""
    pr = _problems[problem_h]
    if "n_dims" not in pr:
        from .lib_env import load_energy_file
        from .spec import ProblemSpec

        spec = load_energy_file(pr["filename"], ProblemSpec())
        pr["n_dims"] = len(spec.dims)
        pr["n_params"] = len(_ordered_inputs(spec))
    return pr["n_dims"]


def plan_num_params(plan_h):
    return len(_ordered_inputs(_plans[plan_h]["spec"]))


def problem_plan(state_h, problem_h, dims):
    from .lib_env import load_energy_file
    from .spec import ProblemSpec

    st = _states[state_h]
    pr = _problems[problem_h]
    spec = load_energy_file(pr["filename"], ProblemSpec(double_precision=st["double_precision"]))
    solver = {"LM": "levenberg_marquardt", "LMGPU": "levenberg_marquardt",
              "gaussNewtonGPU": "gauss_newton"}.get(pr["solver"], pr["solver"])
    # extra plan options (linear_solver="schur_pcg", preconditioner,
    # block_dtype, ...) reach C-API consumers through one JSON env var —
    # the reference's init-params struct is fixed-layout (Thallo.h:10-36),
    # so new knobs can't extend it without breaking its ABI
    import json as _json
    import os as _os

    opts = {}
    raw = _os.environ.get("THALLO_TPU_PLAN_OPTIONS")
    if raw:
        opts = dict(_json.loads(raw))
    plan = spec.plan({d.name: int(s) for d, s in zip(spec.dims, dims)}, solver=solver,
                     use_autoscheduler=st["use_autoscheduler"],
                     timing_level=st["timing"], verbosity=st["verbosity"],
                     device="cpu" if st["cpu_only"] else "cuda", **opts)
    h = next(_handles)
    _plans[h] = {"plan": plan, "spec": spec, "buffers": None, "state": st}
    return h


def plan_free(plan_h):
    _plans.pop(plan_h, None)


def set_solver_parameter(plan_h, name, value):
    p = _plans[plan_h]["plan"]
    if name in ("nIterations", "lIterations", "residual_reset_period"):
        value = int(value)
    p.set_solver_parameter(name, value)


def get_solver_parameter(plan_h, name):
    return float(_plans[plan_h]["plan"].get_solver_parameter(name))


def _ordered_inputs(spec):
    """All declared inputs sorted by argument position (the order of the C
    void** array)."""
    items = []
    for im in list(spec.unknowns) + list(spec.arrays):
        items.append(("image", im))
    for sm in spec.sparse_maps:
        items.append(("sparse", sm))
    for pm in spec.params:
        items.append(("param", pm))
    items.sort(key=lambda kv: (1 << 30) if kv[1].argpos is None else kv[1].argpos)
    return items


def _wrap_pointers(entry, ptrs):
    """Wrap C pointers as numpy arrays (zero-copy views over host memory)."""
    spec = entry["spec"]
    st = entry["state"]
    ftype = ctypes.c_double if st["double_precision"] else ctypes.c_float
    inputs = {}
    buffers = {}
    for (kind, obj), addr in zip(_ordered_inputs(spec), ptrs):
        if kind == "image":
            shape = tuple(d.size for d in obj.dims) + (obj.channels,)
            n = int(np.prod(shape))
            buf = np.ctypeslib.as_array(ctypes.cast(addr, ctypes.POINTER(ftype)), (n,))
            inputs[obj.name] = buf.reshape(shape).copy()
            buffers[obj.name] = (buf, shape)
        elif kind == "sparse":
            shape = tuple(d.size for d in obj.in_dims) + (len(obj.out_dims),)
            n = int(np.prod(shape))
            buf = np.ctypeslib.as_array(ctypes.cast(addr, ctypes.POINTER(ctypes.c_int32)), (n,))
            inputs[obj.name] = buf.reshape(shape).copy()
        else:  # scalar param: pointer to one value
            buf = np.ctypeslib.as_array(ctypes.cast(addr, ctypes.POINTER(ftype)), (1,))
            inputs[obj.name] = float(buf[0])
    return inputs, buffers


def _writeback(entry):
    """Copy solved unknowns back into the caller's host buffers (the whole
    images, from the device)."""
    plan = entry["plan"]
    for name, (buf, shape) in (entry["buffers"] or {}).items():
        if name in plan._U:
            buf[:] = plan._U[name].cpu().numpy().reshape(-1)


def problem_init(plan_h, ptrs):
    entry = _plans[plan_h]
    inputs, buffers = _wrap_pointers(entry, ptrs)
    entry["buffers"] = buffers
    plan = entry["plan"]
    plan.init(inputs)
    unknown_names = {im.name for im in entry["spec"].unknowns}
    entry["const_snapshot"] = {
        k: v for k, v in inputs.items() if k not in unknown_names
    }


def problem_step(plan_h, ptrs):
    """One nonlinear iteration.  The reference re-binds every parameter
    pointer on each step (initParameters setGPUptr, gauss_newton.t:1559),
    so applications may mutate const arrays / scalar params / sparse maps
    between steps (weight schedules, bundle_fusion's nested solvers).
    This copy-based bridge matches that: it re-reads the caller's buffers
    and pushes any changed non-unknown input through
    Plan.update_inputs."""
    entry = _plans[plan_h]
    plan = entry["plan"]
    snap = entry.get("const_snapshot")
    if ptrs and snap is not None:
        new_inputs, _ = _wrap_pointers(entry, ptrs)
        changed = {
            k: v for k, v in new_inputs.items()
            if k in snap and not np.array_equal(v, snap[k])
        }
        if changed:
            plan.update_inputs(changed)
            snap.update(changed)
    cont = plan.step()
    _writeback(entry)
    return 1 if cont else 0


def problem_solve(plan_h, ptrs):
    entry = _plans[plan_h]
    inputs, buffers = _wrap_pointers(entry, ptrs)
    entry["buffers"] = buffers
    entry["plan"].solve(inputs)
    _writeback(entry)


def current_cost(plan_h):
    return float(_plans[plan_h]["plan"].cost())


def performance_summary(plan_h):
    """Returns the 5 canonical entries as a flat list of 25 doubles:
    (count, min, max, mean, stddev) x (Total, Nonlinear Iteration,
    Nonlinear Setup, Linear Solve, Nonlinear Finish) — the field order of
    Thallo_PerformanceSummary (reference Thallo.h:85-104)."""
    s = _plans[plan_h]["plan"].get_performance_summary()
    out = []
    for name in ["Total", "Nonlinear Iteration", "Nonlinear Setup", "Linear Solve",
                 "Nonlinear Finish"]:
        e = s.get(name) or {"count": 0, "min_ms": 0, "max_ms": 0, "mean_ms": 0, "stddev_ms": 0}
        out.extend([float(e["count"]), e["min_ms"], e["max_ms"], e["mean_ms"], e["stddev_ms"]])
    return out
