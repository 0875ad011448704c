"""Plan: the compiled problem + solve driver (counterpart of
``thallo_tpu/plan.py``).

A plan lives on one explicit torch device: ``device="cuda"`` (the
default) raises when CUDA is not available, and ``device="cpu"`` runs
every kernel's plain torch version.  Nothing picks a device by itself.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import reorder
from .lower import Collection, LoweredGroup, inline_computed
from .solver.gn import (
    BLOCK_DTYPES,
    SOLVER_PARAMETER_DEFAULTS,
    CompiledSolver,
    GroupPlan,
    LMState,
    SolverParams,
    tree_zeros_like,
)
from .spec import JTJpSchedule, ProblemSpec

_KNOWN_OPTIONS = {"use_autoscheduler", "lin_iter_hint", "solver_parameters",
                  "timing_level", "verbosity", "guarded_invert_type",
                  "jacobi_scaling", "linear_solver", "schur_eliminate", "trace_dir",
                  "profile_compile", "debug_check_finite", "block_dtype",
                  "steps_per_dispatch", "preconditioner", "schur_dense_max",
                  "sort_residuals", "device"}

# options of thallo_tpu's Plan whose non-default values need a part of the
# JAX package that is not ported yet
_UNPORTED_OPTIONS = {
    "use_autoscheduler": (0, "the autoscheduler"),
    "linear_solver": ("pcg", "direct and Schur solves"),
    "steps_per_dispatch": (1, "multi-step dispatch"),
    "trace_dir": (None, "profiler traces"),
    "profile_compile": (False, "compile profiling"),
}


def make_plan(spec: ProblemSpec, dim_sizes, solver="gauss_newton", **options):
    return Plan(spec, dim_sizes, solver, **options)


def default_schedule(g: LoweredGroup) -> JTJpSchedule:
    """thallo_tpu/schedule.py default: graph groups (any slot needing a
    real gather) materialize JᵀJ block-sparse; stencil groups run
    matrix-free."""
    if g.uslots and any(g._roll_plan(s) is None for s in g.uslots):
        return JTJpSchedule.PRECOMPUTE_JTJ
    return JTJpSchedule.LINEARIZE


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain torch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    return dev


class Plan:
    def __init__(self, spec: ProblemSpec, dim_sizes: Dict[str, int], solver: str, **options):
        if spec.energy is None:
            raise ValueError("problem has no Residuals")
        self.spec = spec
        self.solver_kind = solver
        uses_lambda = solver in ("levenberg_marquardt", "LM", "lm", "LMGPU")
        if not uses_lambda and solver not in ("gauss_newton", "GN", "gn", "gaussNewtonGPU"):
            raise ValueError(
                f"unknown solver {solver!r}: expected 'gauss_newton' or "
                "'levenberg_marquardt' (aliases GN/gaussNewtonGPU, LM/LMGPU)")
        bad = set(options) - _KNOWN_OPTIONS
        if bad:
            raise ValueError(f"unknown plan option(s): {sorted(bad)}")
        if options.get("linear_solver", "pcg") not in (
                "pcg", "direct", "schur_pcg", "schur_dense"):
            raise ValueError("linear_solver must be 'pcg', 'direct', "
                             "'schur_pcg' or 'schur_dense'")
        if options.get("guarded_invert_type", "CERES") not in (
                "CERES", "MODIFIED_CERES", "EPSILON_ADD"):
            raise ValueError("invalid guarded_invert_type")
        if options.get("jacobi_scaling", "ONCE_PER_SOLVE") not in (
                "ONCE_PER_SOLVE", "EVERY_ITERATION", "NONE"):
            raise ValueError("invalid jacobi_scaling")
        if options.get("block_dtype") not in BLOCK_DTYPES:
            raise ValueError(f"block_dtype={options['block_dtype']!r}: expected one of "
                             f"{sorted(BLOCK_DTYPES, key=str)}")
        for name, (default, what) in _UNPORTED_OPTIONS.items():
            if options.get(name, default) != default:
                raise NotImplementedError(f"{name}={options[name]!r}: {what} is not ported yet")
        if spec.double_precision:
            raise NotImplementedError("double_precision is not ported yet: the port runs in f32")
        self.device = _resolve_device(options.get("device", "cuda"))
        self.dtype = torch.float32

        if isinstance(dim_sizes, (list, tuple)):
            dim_sizes = {d.name: s for d, s in zip(spec.dims, dim_sizes)}
        self.dim_sizes = dict(dim_sizes)
        for d in spec.dims:
            if d.name not in self.dim_sizes:
                raise ValueError(f"no size for dim {d.name}")
            new = int(self.dim_sizes[d.name])
            if d.size is not None and d.size != new:
                raise ValueError(
                    f"dim {d.name} already bound to {d.size} by an earlier "
                    f"plan; build a fresh spec to plan at size {new}")
            d.size = new

        groups = self._build_groups(spec)
        self.compiled = CompiledSolver(spec, groups, uses_lambda, self.dtype, options,
                                       self.device)
        self.group_names = [g.name for g in groups]
        self.solver_parameters = dict(SOLVER_PARAMETER_DEFAULTS)
        self.solver_parameters.update(options.get("solver_parameters", {}))
        self.verbosity = int(options.get("verbosity", 0))
        self.debug_check_finite = bool(options.get("debug_check_finite", False))
        # init-time residual-domain sort (reorder.py): "auto" sorts
        # order-free graph domains by their largest unstructured sparse
        # map, so the block-sparse row tables read contiguous runs; False
        # disables (also THALLO_SORT_RESIDUALS=0)
        self.sort_residuals = options.get("sort_residuals", "auto")
        self._residual_perms = {}
        self._inputs = None
        self._U = None
        self._lm = None
        self._finished = False
        self._iter = 0

    def _build_groups(self, spec):
        """Group residuals by identical external domains and schedule
        (thallo_tpu Plan._build_groups, directive mode)."""
        merged_names = {}
        energy = spec.energy
        for mg in energy._merges:
            for n in mg[1:]:
                merged_names[n] = mg[0]
        bucket, order = {}, []
        for nr in energy:
            tgt = merged_names.get(nr.name, nr.name)
            if tgt != nr.name or tgt in merged_names.values():
                key = ("merge", tgt)
            else:
                key = (self._group_signature(nr),)
            if key not in bucket:
                bucket[key] = (tgt if key[0] == "merge" else nr.name, [])
                order.append(key)
            bucket[key][1].append(nr)
        groups = []
        for key in order:
            name, nrs = bucket[key]
            exprs = [e for nr in nrs for e in nr.exprs]
            name = "_".join(nr.name for nr in nrs) if len(nrs) > 1 else name
            dorder = next((nr._reorder for nr in nrs if nr._reorder), None)
            lg = LoweredGroup(name, exprs, spec, self.dim_sizes, self.dtype,
                              domain_order=dorder)
            user_directed = any(any(nr._materialize.values()) or any(nr._sparse_mat.values())
                                for nr in nrs)
            schedule = nrs[0].get_schedule() if user_directed else default_schedule(lg)
            force_sparse = any(nr._sparse_mat.get("JtJ") or nr._sparse_mat.get("J")
                               for nr in nrs)
            groups.append(GroupPlan(name=name, group=lg, schedule=schedule,
                                    force_sparse=bool(force_sparse)))
        return groups

    @staticmethod
    def _group_signature(nr):
        col = Collection()
        for e in inline_computed(nr.exprs):
            col.walk(e, frozenset())
        doms = tuple(sorted(d.uid for d in col.ext_domains))
        sched = (nr.get_schedule().value, tuple(sorted(nr._compute_at_output.items())))
        return (doms, sched)

    # -- parameter API -------------------------------------------------------
    def set_solver_parameter(self, name: str, value):
        if name not in self.solver_parameters:
            raise KeyError(f"unknown solver parameter {name}")
        self.solver_parameters[name] = value

    def get_solver_parameter(self, name: str):
        return self.solver_parameters[name]

    def _sp(self):
        return SolverParams.from_dict(self.solver_parameters)

    def _scalar(self, v, dtype=None):
        return torch.tensor(np.asarray(v).item(), dtype=dtype or self.dtype, device=self.device)

    # -- data binding ----------------------------------------------------------
    def _normalize_inputs(self, inputs: Dict[str, np.ndarray]):
        """Unknowns, arrays and params as device tensors; sparse maps stay
        host int32 arrays (index tables are built from them on the host)."""
        out = {}
        for im in list(self.spec.unknowns) + list(self.spec.arrays):
            if im.name not in inputs:
                raise ValueError(f"missing input {im.name}")
            a = torch.as_tensor(np.asarray(inputs[im.name]), dtype=self.dtype)
            shape = tuple(d.size for d in im.dims) + (im.channels,)
            if a.ndim == len(im.dims) and im.channels == 1:
                a = a[..., None]
            if tuple(a.shape) != shape:
                raise ValueError(f"input {im.name}: expected {shape}, got {tuple(a.shape)}")
            out[im.name] = a.to(self.device)
        for sm in self.spec.sparse_maps:
            if sm.name not in inputs:
                raise ValueError(f"missing sparse map {sm.name}")
            raw = np.asarray(inputs[sm.name])
            if raw.size:
                cols = raw.reshape(-1, len(sm.out_dims))
                for j, d in enumerate(sm.out_dims):
                    cj = cols[:, j]
                    if cj.min() < 0 or cj.max() >= d.size:
                        raise ValueError(
                            f"sparse map {sm.name}: indices for out dim "
                            f"{d.name} must be in [0, {d.size}); got range "
                            f"[{cj.min()}, {cj.max()}]")
            out[sm.name] = np.asarray(raw, dtype=np.int32)
        for p in self.spec.params:
            if p.name not in inputs:
                raise ValueError(f"missing param {p.name}")
            out[p.name] = self._scalar(inputs[p.name])
        return out

    def _maybe_sort_residuals(self, inputs):
        """Init-time residual-domain sort (thallo_tpu/plan.py:439-473):
        relabel order-free graph domains so the largest unstructured
        sparse map is sorted.  The residual multiset, and so every cost
        and product, is unchanged up to summation order."""
        self._residual_perms = {}
        if not self.sort_residuals or os.environ.get("THALLO_SORT_RESIDUALS", "1") == "0":
            return inputs
        gps = self.compiled.groups
        want = {id(gp.group): self.compiled._wants_bsr(gp) for gp in gps}
        try:
            perms = reorder.choose_sort_keys(self.spec, [gp.group for gp in gps], inputs,
                                             lambda g: want.get(id(g), False))
            out = reorder.apply_perms(self.spec, inputs, perms)
        except (ValueError, IndexError, KeyError):
            if self.sort_residuals != "auto":
                raise
            return inputs  # "auto": the sort is an optimization only
        if perms and self.verbosity:
            print(f"[thallo_tpu_torch] residual sort: {sorted(perms)}")
        self._residual_perms = perms
        return out

    def init(self, inputs: Dict[str, np.ndarray]):
        """Bind user arrays and reset solver state.  Returns the initial cost."""
        inputs = self._maybe_sort_residuals(inputs)
        self._inputs = self._normalize_inputs(inputs)
        self._U = {im.name: self._inputs[im.name].clone() for im in self.spec.unknowns}
        self._const_inputs = {k: v for k, v in self._inputs.items() if k not in self._U}
        self._prep = self.compiled.prepare(self._inputs)
        c0 = self.cost()
        sp = self.solver_parameters
        self._lm = LMState(
            trust_region_radius=self._scalar(sp["trust_region_radius"]),
            radius_decrease_factor=self._scalar(sp["radius_decrease_factor"]),
            prev_cost=self._scalar(c0),
            n_iter=0,
            ssq=tree_zeros_like(self._U),
            finished=torch.zeros((), dtype=torch.bool, device=self.device),
        )
        self._finished = False
        self._iter = 0
        self._solve_t0 = time.perf_counter()
        if self.verbosity:
            print(f"[thallo_tpu_torch] initial cost: {c0:g}")
        return c0

    def _step_inputs(self):
        return self._const_inputs

    # -- stepping ----------------------------------------------------------------
    def step(self) -> bool:
        """One nonlinear iteration.  Returns True while the solve should
        continue.  LM reads its device-side stop flag once per step."""
        if self._finished:
            return False
        if self._iter >= int(self.solver_parameters["nIterations"]):
            self._finished = True
            return False
        U, lm, stop, _ = self.compiled.nonlinear_step(
            self._U, self._lm, self._step_inputs(), self._sp(), self._prep)
        self._U, self._lm = U, lm
        self._iter += 1
        if self.debug_check_finite:
            bad = [k for k, v in U.items() if not bool(torch.isfinite(v).all())]
            if bad:
                raise FloatingPointError(f"non-finite unknowns after iteration {self._iter}: {bad}")
        if self.compiled.uses_lambda and bool(stop):
            self._finished = True
            return False
        max_t = float(self.solver_parameters["max_solver_time_in_seconds"])
        if max_t > 0 and time.perf_counter() - self._solve_t0 > max_t:
            self._finished = True
            return False
        return True

    def solve(self, inputs: Optional[Dict] = None) -> float:
        """Full solve: (init +) steps until done.  Returns the final cost."""
        if inputs is not None:
            self.init(inputs)
        if self._inputs is None:
            raise RuntimeError("call init() first")
        while self.step():
            pass
        final = self.cost()
        if self.verbosity:
            print(f"[thallo_tpu_torch] final cost: {final:g} after {self._iter} iterations")
        return final

    def cost(self) -> float:
        return float(self.compiled.cost(self._U, self._step_inputs(), self._prep["consts"]))

    def reset_unknowns(self):
        """Restore unknowns to their initial values."""
        if self._inputs is None:
            raise RuntimeError("call init() first")
        self._U = {im.name: self._inputs[im.name].clone() for im in self.spec.unknowns}
        self._finished = False
        self._iter = 0

    def unknowns(self) -> Dict[str, torch.Tensor]:
        return dict(self._U)

    def get_unknown(self, name, squeeze=True):
        a = self._U[name]
        if squeeze and a.shape[-1] == 1:
            a = a[..., 0]
        return a

    # -- checkpoint / resume: the same .npz layout as thallo_tpu ---------------
    def save_state(self, path: str):
        """Snapshot unknowns + LM scalars + iteration counter to an .npz
        (readable by thallo_tpu's Plan.load_state and by this one)."""
        if self._U is None:
            raise RuntimeError("nothing to save: call init() first")
        payload = {f"U::{k}": v.cpu().numpy() for k, v in self._U.items()}
        payload.update({f"ssq::{k}": v.cpu().numpy() for k, v in self._lm.ssq.items()})
        payload.update(
            iter=np.asarray(self._iter),
            trust_region_radius=self._lm.trust_region_radius.cpu().numpy(),
            radius_decrease_factor=self._lm.radius_decrease_factor.cpu().numpy(),
            prev_cost=self._lm.prev_cost.cpu().numpy(),
            n_iter=np.asarray(self._lm.n_iter, np.int32),
            finished=np.asarray(self._finished),
        )
        np.savez(path, **payload)

    def load_state(self, path: str):
        """Restore a snapshot written by save_state (of either package);
        inputs must already be bound via init()."""
        if self._inputs is None:
            raise RuntimeError("bind inputs with init() before load_state()")
        with np.load(path) as z:
            def dev(a):
                return torch.as_tensor(np.asarray(a), dtype=self.dtype).to(self.device)

            self._U = {k[len("U::"):]: dev(z[k]) for k in z.files if k.startswith("U::")}
            ssq = {k[len("ssq::"):]: dev(z[k]) for k in z.files if k.startswith("ssq::")}
            self._lm = LMState(
                trust_region_radius=self._scalar(z["trust_region_radius"]),
                radius_decrease_factor=self._scalar(z["radius_decrease_factor"]),
                prev_cost=self._scalar(z["prev_cost"]),
                n_iter=int(z["n_iter"]),
                ssq=ssq,
                finished=torch.tensor(bool(z["finished"]), device=self.device),
            )
            self._iter = int(z["iter"])
            self._finished = bool(z["finished"])

    @property
    def num_iterations(self):
        return self._iter
