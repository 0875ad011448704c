"""Plan: the compiled problem + solve driver (counterpart of
``thallo_tpu/plan.py``).

A plan lives on one explicit torch device: ``device="cuda"`` (the
default) raises when CUDA is not available, and ``device="cpu"`` runs
every kernel's plain torch version.  Nothing picks a device by itself.

``ProblemSpec(double_precision=True)`` makes every array the plan
allocates or casts f64 (``self.dtype``; index arrays stay integer): on
the card the kernels run their f64 instantiations.  ``block_dtype="bf16"``
with it is allowed, as in JAX (bf16 cross blocks, f64 everything else),
on the CPU; on the card it raises NotImplementedError (no kernel takes
bf16 blocks with f64 values).

``use_autoscheduler`` (thallo_tpu/plan.py:115-228) picks the groups'
schedules: 0 (the default) the energy's directives and
``schedule.default_schedule``; 1 the heuristic of schedule.py (computed
arrays decided before lowering, measured timings from the store that
THALLO_MEASUREMENTS names ahead of the bytes model, weighed by
``lin_iter_hint`` PCG iterations, default lIterations); 2 LINEARIZE
everywhere; 3 + k the exhaustive candidate k (IndexError past the last;
autotune.py measures them).  The decisions are kept in
``schedule_log``.

The timer (utils/timer.py) keeps JAX's events: "Total" around
``solve``, "Nonlinear Iteration" around each step or ``run_steps`` batch,
"Nonlinear Setup" around ``init``'s cost and, at ``timing_level`` >= 2,
around each step's three phases ("Nonlinear Setup", "Linear Solve",
"Nonlinear Finish"), each ended by a device sync as JAX blocks there.
At the default level the timer reads host clocks only: no sync.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import reorder
from . import schedule as sched
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
from .utils.timer import PerfSummary, Timer

_KNOWN_OPTIONS = {"use_autoscheduler", "lin_iter_hint", "solver_parameters",
                  "timing_level", "verbosity", "guarded_invert_type",
                  "jacobi_scaling", "linear_solver", "schur_eliminate", "trace_dir",
                  "profile_compile", "debug_check_finite", "block_dtype",
                  "steps_per_dispatch", "preconditioner", "schur_dense_max",
                  "sort_residuals", "device"}

# options of thallo_tpu's Plan whose other values need a part of the JAX
# package that is not ported yet: the values the port takes
_UNPORTED_OPTIONS = {
    "steps_per_dispatch": ((1,), "multi-step dispatch (ROADMAP queue 1, item 2a)"),
    "trace_dir": ((None,), "profiler traces (ROADMAP queue 1, item 9)"),
    "profile_compile": ((False,), "compile profiling (ROADMAP queue 1, item 9)"),
    "timing_level": ((0, 1, 2), "per-kernel timing (ROADMAP queue 1, item 9)"),
}


def make_plan(spec: ProblemSpec, dim_sizes, solver="gauss_newton", **options):
    return Plan(spec, dim_sizes, solver, **options)


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
        for name, (allowed, what) in _UNPORTED_OPTIONS.items():
            if name in options and options[name] not in allowed:
                raise NotImplementedError(f"{name}={options[name]!r}: {what} is not ported yet")
        self.device = _resolve_device(options.get("device", "cuda"))
        self.dtype = torch.float64 if spec.double_precision else torch.float32
        if spec.double_precision and BLOCK_DTYPES[options.get("block_dtype")] is not None \
                and self.device.type == "cuda":
            raise NotImplementedError(
                "block_dtype='bf16' with double_precision on the card: no kernel takes bf16 "
                "blocks with f64 values (ROADMAP queue 2, item 7); the CPU runs it, as JAX")
        self.timing_level = int(options.get("timing_level", 1))
        self.timer = Timer()

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

        self.use_autoscheduler = int(options.get("use_autoscheduler", 0) or 0)
        self.schedule_log = []
        lin_hint = int(options.get("lin_iter_hint", SOLVER_PARAMETER_DEFAULTS["lIterations"]))
        groups = self._schedule(spec, self.use_autoscheduler, lin_hint)
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
        self._raw_inputs0 = None
        self._inputs = None
        self._U = None
        self._lm = None
        self._finished = False
        self._iter = 0

    def _schedule(self, spec, auto, lin_hint):
        """The groups and their schedules by the use_autoscheduler mode
        (thallo_tpu/plan.py:115-228): 0 the energy's directives and the
        default schedule; 1 the heuristic (computed arrays decided before
        lowering, then the schedules, the domain orders, compute_at_output);
        2 every directive cleared, LINEARIZE everywhere; >= 3 exhaustive
        candidate auto - 3 (IndexError past the last).  The decisions are
        kept in schedule_log."""
        if auto == 1:
            log = ["heuristic autoschedule:"]
            # inlining is baked into the lowered groups: decide first
            sched.select_ca_materialization(spec, log=log)
            groups = self._build_groups(spec, auto, merge_all=True)
            log.append(f"({len(groups)} groups)")
            schedules = sched.heuristic_schedule(groups, lin_hint, log=log)
            # recorded measurements decide the domain order first, then
            # the analytic prefix rule
            dorders = sched.select_measured_domain_orders(groups, schedules, log=log)
            a_orders = sched.analytic_domain_orders(groups, schedules, log=log)
            dorders = [m if m is not None else a for m, a in zip(dorders, a_orders)]
            if any(o is not None for o in dorders):
                groups = self._build_groups(spec, auto, merge_all=True, domain_orders=dorders)
            for gp, s in zip(groups, schedules):
                gp.schedule = s
            sched.choose_compute_at_output(groups, schedules, log=log)
            self.schedule_log = log
            return groups
        if auto < 3:
            return self._build_groups(spec, auto, merge_all=True)
        # merge/split x computed-array powerset x schedule combos x domain orders
        idx = auto - 3
        chosen = None
        for merge_all in (True, False):
            for ca_bits in range(1 << len(spec.computed)):
                for b, ca in enumerate(spec.computed):
                    ca.materialize = bool((ca_bits >> b) & 1)
                groups = self._build_groups(spec, auto, merge_all=merge_all)
                combos = sched.enumerate_schedules(groups)
                dorders = sched.enumerate_domain_orders(groups)
                total = len(combos) * len(dorders)
                if idx < total:
                    combo = combos[idx // len(dorders)]
                    dorder = dorders[idx % len(dorders)]
                    if any(o is not None for o in dorder):
                        groups = self._build_groups(spec, auto, merge_all=merge_all,
                                                    domain_orders=dorder)
                    chosen = (groups, combo, merge_all, ca_bits, dorder)
                    break
                idx -= total
            if chosen:
                break
        if chosen is None:
            raise IndexError(f"autoschedule index {auto - 3} exhausted")
        groups, combo, merge_all, ca_bits, dorder = chosen
        for gp, s in zip(groups, combo):
            gp.schedule = s
        self.schedule_log = [
            f"exhaustive candidate {auto - 3}: merge={merge_all} ca_bits={ca_bits:b} "
            + ", ".join(f"{gp.name}={s.value}" for gp, s in zip(groups, combo))
            + "".join(f" reorder[{gp.name}]=" + ">".join(d.name for d in o)
                      for gp, o in zip(groups, dorder) if o is not None)]
        return groups

    def _build_groups(self, spec, auto=0, merge_all=True, domain_orders=None):
        """Group residuals by identical external domains and schedule
        (thallo_tpu Plan._build_groups).  Explicit energy.merge() requests
        come first; merge_all=False (the exhaustive split candidates) keeps
        every named residual its own group.  Under the autoscheduler
        (auto >= 1) directives are cleared: groups merge by domains alone,
        start LINEARIZE and take domain_orders (per group, aligned with an
        identically keyed build) instead of the energy's reorder()."""
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
            elif not merge_all:
                key = ("name", nr.name)
            else:
                key = (self._group_signature(nr, ignore_schedule=auto >= 1),)
            if key not in bucket:
                bucket[key] = (tgt if key[0] == "merge" else nr.name, [])
                order.append(key)
            bucket[key][1].append(nr)
        groups = []
        for g_idx, key in enumerate(order):
            name, nrs = bucket[key]
            exprs = [e for nr in nrs for e in nr.exprs]
            name = "_".join(nr.name for nr in nrs) if len(nrs) > 1 else name
            if domain_orders is not None and g_idx < len(domain_orders):
                dorder = domain_orders[g_idx]
            elif auto == 0:
                dorder = next((nr._reorder for nr in nrs if nr._reorder), None)
            else:
                dorder = None  # the autoscheduler clears directives
            # split(domain, B) directives: contraction blocking
            con_splits = {sp[0]: sp[1] for nr in nrs for sp in getattr(nr, "_splits", [])
                          if isinstance(sp, tuple)}
            lg = LoweredGroup(name, exprs, spec, self.dim_sizes, self.dtype,
                              domain_order=dorder, con_splits=con_splits)
            if lg.mslots and not lg.ca_jac_ok:
                # a computed-array access inside a contraction fiber: JAX
                # differentiates the force-inlined twin of the group
                # (thallo_tpu/plan.py:337-350); the port plans that twin, whose
                # residuals are the same values
                lg = LoweredGroup(name, inline_computed(exprs, force=True), spec,
                                  self.dim_sizes, self.dtype, domain_order=dorder,
                                  con_splits=con_splits)
            user_directed = any(any(nr._materialize.values()) or any(nr._sparse_mat.values())
                                for nr in nrs)
            if auto >= 1:
                schedule = JTJpSchedule.LINEARIZE
            elif user_directed:
                schedule = nrs[0].get_schedule()
            else:
                schedule = sched.default_schedule(lg)
            force_sparse = any(nr._sparse_mat.get("JtJ") or nr._sparse_mat.get("J")
                               for nr in nrs)
            groups.append(GroupPlan(name=name, group=lg, schedule=schedule,
                                    force_sparse=bool(force_sparse)))
        return groups

    @staticmethod
    def _group_signature(nr, ignore_schedule=False):
        """(external-domain ids, schedule knobs): residuals with equal
        signatures lower into one group; the autoscheduler, which clears
        directives, merges by domains alone (ignore_schedule)."""
        col = Collection()
        for e in inline_computed(nr.exprs):
            col.walk(e, frozenset())
        doms = tuple(sorted(d.uid for d in col.ext_domains))
        if ignore_schedule:
            return (doms, ())
        return (doms, (nr.get_schedule().value, tuple(sorted(nr._compute_at_output.items()))))

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
        and product, is unchanged up to summation order.  The raw user
        inputs are kept for update_inputs."""
        self._raw_inputs0 = dict(inputs)
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
        with self.timer.event("Nonlinear Setup"):
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

    def update_inputs(self, inputs: Dict[str, np.ndarray]):
        """Update non-unknown inputs (const arrays, params, sparse maps)
        between nonlinear iterations, keeping the unknowns and the trust
        region (thallo_tpu/plan.py:554).  The update merges over the raw
        (pre-sort) user inputs and the residual sort applies again; the
        init-time preparation is rebuilt; LM's previous cost becomes the
        cost under the new inputs."""
        if self._inputs is None:
            raise RuntimeError("update_inputs before init()")
        unknown_names = {im.name for im in self.spec.unknowns}
        bad = sorted(set(inputs) & unknown_names)
        if bad:
            raise ValueError(
                f"update_inputs cannot rebind unknowns {bad}; use init() "
                "or load_state() to reset unknown values")
        merged = dict(self._raw_inputs0)
        merged.update(inputs)
        normalized = self._normalize_inputs(self._maybe_sort_residuals(merged))
        self._inputs = {k: (self._inputs[k] if k in unknown_names else v)
                        for k, v in normalized.items()}
        self._const_inputs = {k: v for k, v in self._inputs.items() if k not in unknown_names}
        self._prep = self.compiled.prepare(self._inputs)
        if self._lm is not None and self.compiled.uses_lambda:
            self._lm = self._lm._replace(prev_cost=self._scalar(self.cost()))

    # -- stepping ----------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _timed_phase(self, name):
        """A step's phase as a timer event ended by a device sync
        (timing_level >= 2, thallo_tpu/plan.py:636-648)."""
        with self.timer.event(name):
            yield
            self._sync()

    def step(self) -> bool:
        """One nonlinear iteration.  Returns True while the solve should
        continue.  LM reads its device-side stop flag once per step."""
        if self._finished:
            return False
        if self._iter >= int(self.solver_parameters["nIterations"]):
            self._finished = True
            return False
        phase = self._timed_phase if self.timing_level >= 2 else contextlib.nullcontext
        with self.timer.event("Nonlinear Iteration"):
            U, lm, stop, _ = self.compiled.nonlinear_step(self._U, self._lm, self._step_inputs(),
                                                          self._sp(), self._prep, phase)
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

    def run_steps(self, n: int) -> int:
        """n nonlinear iterations back to back (at most the nIterations
        left) with no host read between them (thallo_tpu/plan.py:674).
        LM reads its stop flag once, after the batch: as in thallo_tpu, a
        stop set by a step inside the batch does not end it, the steps
        after it run (and may accept), and only the last step's flag ends
        the solve.  Returns the number of steps run."""
        if self._finished or n <= 0:
            return 0
        n = min(n, max(int(self.solver_parameters["nIterations"]) - self._iter, 0))
        if n <= 0:
            self._finished = True
            return 0
        U, lm = self._U, self._lm
        cin, sp, prep = self._step_inputs(), self._sp(), self._prep
        with self.timer.event("Nonlinear Iteration"):
            for _ in range(n):
                U, lm, stop, _ = self.compiled.nonlinear_step(U, lm, cin, sp, prep)
        self._U, self._lm = U, lm
        self._iter += n
        if self.compiled.uses_lambda and bool(stop):
            self._finished = True
        if self._iter >= int(self.solver_parameters["nIterations"]):
            self._finished = True
        return n

    def warmup(self) -> None:
        """One throwaway step (and cost) on copies of the state, so the
        first real step pays no kernel build, no first-call set-up of the
        torch ops and no allocator growth (thallo_tpu/plan.py:761); the
        solver state is unchanged."""
        if self._inputs is None:
            raise RuntimeError("call init() first")
        U = {k: v.clone() for k, v in self._U.items()}
        self.compiled.cost(U, self._step_inputs(), self._prep["consts"])
        self.compiled.nonlinear_step(U, self._lm, self._step_inputs(), self._sp(), self._prep)
        self._sync()

    def solve(self, inputs: Optional[Dict] = None) -> float:
        """Full solve: (init +) steps until done.  Returns the final cost.
        GN (no device-side stop) runs its steps as one run_steps batch
        unless a host check per step is asked for, as thallo_tpu does."""
        if inputs is not None:
            self.init(inputs)
        if self._inputs is None:
            raise RuntimeError("call init() first")
        with self.timer.event("Total"):
            if not self.compiled.uses_lambda and not self.debug_check_finite and \
                    self.timing_level < 2 and \
                    float(self.solver_parameters["max_solver_time_in_seconds"]) == 0:
                # timing_level >= 2 wants per-phase stats: step() instead
                self.run_steps(int(self.solver_parameters["nIterations"]))
            while self.step():
                pass
            self._sync()
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

    def jacobian(self, dense: bool = False):
        """The Jacobian at the current unknowns (thallo_tpu/plan.py:883-896):
        COO (residuals, rows, cols, vals, (n_rows, n_cols)) as tensors on
        the plan's device, or, with dense=True, (residuals, J [n_rows,
        n_cols]).  Excluded unknowns' columns are zero."""
        if self._inputs is None:
            raise RuntimeError("call init() first")
        comp = self.compiled
        ins, consts = self._step_inputs(), self._prep["consts"]
        masks = comp.masks(ins, self._U, self._prep.get("masks_static"),
                           self._prep.get("exclude_consts"))
        if dense:
            return comp.dense_jacobian(self._U, ins, consts, masks)
        return comp.coo_jacobian(self._U, ins, consts, masks)

    def get_performance_summary(self) -> PerfSummary:
        """The timer's events (count, min, max, mean, stddev, total in ms)."""
        return self.timer.summary()

    @property
    def final_cost(self):
        return self.cost()

    @property
    def num_iterations(self):
        return self._iter
