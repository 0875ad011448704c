"""Coarse-to-fine (pyramid) solving.

The reference's optical-flow-class applications run classical image
pyramids around the solver: solve at a downsampled resolution, upsample
the unknowns as the next level's initial guess (the reference leaves
this to the C++ app layer — e.g. examples/optical_flow downsamples via
its --downsampleFactor flag, main.cpp:43-49; BundleFusion's hierarchy
plays the same role).  This helper makes it a first-class utility.

Works on any grid problem: the named dims in `scaled_dims` halve per
level; float input arrays whose leading axes match those dims are
average-pooled; unknowns are bilinearly upsampled between levels.
Unknowns that *measure displacement in pixels* (optical flow, warp
offsets) must also be value-scaled by 2 per level — list them in
`pixel_valued`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def downsample2(arr: np.ndarray, n_axes: int) -> np.ndarray:
    """Average-pool the first n_axes axes by 2 (odd tails truncated)."""
    a = np.asarray(arr)
    for ax in range(n_axes):
        n = (a.shape[ax] // 2) * 2
        sl = [slice(None)] * a.ndim
        sl[ax] = slice(0, n)
        a = a[tuple(sl)]
        shape = a.shape[:ax] + (n // 2, 2) + a.shape[ax + 1:]
        a = a.reshape(shape).mean(axis=ax + 1)
    return a.astype(arr.dtype, copy=False)


def upsample2(arr: np.ndarray, target_shape: Sequence[int], n_axes: int) -> np.ndarray:
    """Bilinear upsample of the first n_axes axes to target_shape."""
    a = np.asarray(arr, np.float64)
    for ax in range(n_axes):
        src = a.shape[ax]
        dst = int(target_shape[ax])
        if src == dst:
            continue
        # sample positions in source coordinates (align corners-ish)
        pos = np.linspace(0, src - 1, dst)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, src - 1)
        frac = pos - lo
        a_lo = np.take(a, lo, axis=ax)
        a_hi = np.take(a, hi, axis=ax)
        shape = [1] * a.ndim
        shape[ax] = dst
        f = frac.reshape(shape)
        a = a_lo * (1 - f) + a_hi * f
    return a.astype(arr.dtype if hasattr(arr, "dtype") else np.float32, copy=False)


def solve_coarse_to_fine(
    make_spec: Callable,
    inputs: Dict[str, np.ndarray],
    dim_sizes: Dict[str, int],
    scaled_dims: Sequence[str],
    levels: int = 3,
    pixel_valued: Sequence[str] = (),
    solver: str = "gauss_newton",
    nonlinear_iters: int = 8,
    linear_iters: int = 10,
    plan_options: Optional[dict] = None,
    solver_parameters: Optional[dict] = None,
    input_downsample: Optional[Dict[str, Callable]] = None,
    verbose: bool = False,
):
    """Solve a grid problem coarse-to-fine.  Returns (plan, history):
    `plan` is the finest-level solved plan; history is a list of
    per-level dicts (sizes, initial/final cost).

    input_downsample: optional per-input override, f(array, level_shape)
    -> coarse array (e.g. to re-derive gradient images instead of
    pooling them)."""
    spec_probe = make_spec()
    dim_of_input: Dict[str, List[int]] = {}
    # which leading axes of each input array correspond to scaled dims
    for im in list(spec_probe.unknowns) + list(spec_probe.arrays):
        axes = [i for i, d in enumerate(im.dims) if d.name in scaled_dims]
        dim_of_input[im.name] = axes
    unknown_names = [im.name for im in spec_probe.unknowns]

    # per-level dim sizes, coarsest first
    level_sizes = []
    for lvl in range(levels - 1, -1, -1):
        s = dict(dim_sizes)
        for d in scaled_dims:
            s[d] = max(dim_sizes[d] >> lvl, 4)
        level_sizes.append(s)

    history = []
    carried: Dict[str, np.ndarray] = {}
    plan = None
    for li, sizes in enumerate(level_sizes):
        lvl_inputs = {}
        for k, v in inputs.items():
            axes = dim_of_input.get(k)
            arr = np.asarray(v)
            if axes is None or not axes or arr.ndim == 0:
                lvl_inputs[k] = v
                continue
            target = [sizes[d] for d in scaled_dims]
            if input_downsample and k in input_downsample:
                lvl_inputs[k] = input_downsample[k](arr, tuple(target))
                continue
            a = arr
            # pool the scaled axes down to this level's sizes
            while a.shape[axes[0]] > target[0] * 2 - 1:
                a = _pool_axes(a, axes)
            lvl_inputs[k] = _crop_axes(a, axes, target)
        # carry upsampled unknowns from the previous level as init
        for name, coarse in carried.items():
            axes = dim_of_input[name]
            target = [sizes[d] for d in scaled_dims]
            up = upsample2(coarse, target, len(axes))
            if name in pixel_valued:
                # displacement-valued unknowns (flow/warp offsets in
                # pixels) scale with resolution
                up = up * (target[0] / coarse.shape[axes[0]])
            lvl_inputs[name] = up.astype(np.asarray(inputs[name]).dtype)

        spec = make_spec()
        plan = spec.plan(sizes, solver=solver, **(plan_options or {}))
        plan.set_solver_parameter("nIterations", nonlinear_iters)
        plan.set_solver_parameter("lIterations", linear_iters)
        for k, v in (solver_parameters or {}).items():
            plan.set_solver_parameter(k, v)
        c0 = plan.init(lvl_inputs)
        final = plan.solve()
        history.append({"sizes": dict(sizes), "initial_cost": float(c0),
                        "final_cost": float(final)})
        if verbose:
            print(f"[pyramid] level {li}: {sizes} cost {c0:.4g} -> {final:.4g}")
        carried = {n: plan.get_unknown(n).detach().cpu().numpy() for n in unknown_names}
    return plan, history


def _pool_axes(a: np.ndarray, axes: List[int]) -> np.ndarray:
    for ax in axes:
        n = (a.shape[ax] // 2) * 2
        sl = [slice(None)] * a.ndim
        sl[ax] = slice(0, n)
        a = a[tuple(sl)]
        shape = a.shape[:ax] + (n // 2, 2) + a.shape[ax + 1:]
        a = a.reshape(shape).mean(axis=ax + 1).astype(a.dtype, copy=False)
    return a


def _crop_axes(a: np.ndarray, axes: List[int], target: List[int]) -> np.ndarray:
    for ax, t in zip(axes, target):
        sl = [slice(None)] * a.ndim
        sl[ax] = slice(0, t)
        a = a[tuple(sl)]
    return a
