"""Plan: the compiled problem + solve driver (counterpart of
``thallo_tpu/plan.py``).

A plan lives on one explicit torch device: ``device="cuda"`` (the
default) raises when CUDA is not available, and ``device="cpu"`` runs
every kernel's plain torch version.  Nothing picks a device by itself.

``ProblemSpec(double_precision=True)`` makes every array the plan
allocates or casts f64 (``self.dtype``; index arrays stay integer): on
the card the kernels run their f64 instantiations.  ``block_dtype="bf16"``
with it is allowed, as in JAX (bf16 cross blocks, f64 everything else):
on the card the fused pairs' ``_bf16_f64`` instantiations read them.

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
At the default level the timer reads host clocks only: no sync.  At
``timing_level`` 3 the first step of a solve adds the per-kernel probe
rows (``kernel_stats``); ``kernel_stats(interior=True)`` adds the
production step's own kernels from a torch.profiler trace;
``trace_dir`` writes a trace of each solve; ``profile_compile`` prints
cProfile's table of the solver build.

``steps_per_dispatch`` = k > 1 (thallo_tpu/plan.py:674-759): run_steps
runs its steps as dispatches of k guarded steps (under LM a step after a
stop changes nothing), then the rest unguarded.  On the card a dispatch
is k replays of one CUDA graph of the guarded step (``_StepGraph``);
a step the card cannot capture (``CompiledSolver.uncapturable``) raises
NotImplementedError at plan time instead.

Under a mesh (``parallel.shard_plan_inputs``; JAX's ``with mesh:``
becomes nothing: the plan holds its mesh) every rank runs the same calls
on its own shard: ``_U`` and ``_inputs`` hold the rank's owned blocks,
``_prep`` its residual block's tables; ``cost``, ``final_cost`` and
``get_unknown`` return global values (by collectives, so every rank
calls them), ``save_state`` gathers and writes from rank 0,
``load_state`` reads on rank 0 and hands each rank its blocks, and
``init`` and ``update_inputs`` shard anew.
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


def _lm_tensors(lm):
    """The tensor fields of an LMState, in a fixed order (ssq by name)."""
    return [lm.trust_region_radius, lm.radius_decrease_factor, lm.prev_cost, lm.finished,
            *(lm.ssq[k] for k in sorted(lm.ssq))]


def _clone_lm(lm):
    return lm._replace(trust_region_radius=lm.trust_region_radius.clone(),
                       radius_decrease_factor=lm.radius_decrease_factor.clone(),
                       prev_cost=lm.prev_cost.clone(), finished=lm.finished.clone(),
                       ssq={k: v.clone() for k, v in lm.ssq.items()})


class _StepGraph:
    """CompiledSolver.guarded_step captured once in a torch.cuda.CUDAGraph
    over static copies of U and the LM state: the captured body ends by
    copying its outputs into its inputs, so replays chain, and k steps are
    k replays with no host read.  One step replayed k times holds one
    step's memory pool, not k.  Captured at n_iter >= 1 (solve_setup and
    _finish_step pick the first step's diag(JᵀJ) on the host, by n_iter ==
    0): the plan runs the first step of a solve eagerly.  The solver
    parameters (`key`), the const inputs and the prepared tables are baked
    in, by value or by address: the plan drops the graph when one of them
    changes.  Capture follows torch's rule: one warm-up step on a side
    stream first (it builds every kernel and fills the wrappers' caches),
    on the static copies, so the solver state is not touched."""

    def __init__(self, comp, U, lm, cin, sp, prep):
        self.key = sp
        self.U = {k: v.clone() for k, v in U.items()}
        self.lm = _clone_lm(lm)._replace(n_iter=max(lm.n_iter, 1))
        self.ran = torch.zeros((), dtype=torch.int64, device=comp.device)
        args = (comp, cin, sp, prep)
        side = torch.cuda.Stream(comp.device)
        side.wait_stream(torch.cuda.current_stream(comp.device))
        with torch.cuda.stream(side):
            self._body(*args)
        torch.cuda.current_stream(comp.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body(*args)

    def _body(self, comp, cin, sp, prep):
        if comp.uses_lambda:
            self.ran.add_(~self.lm.finished)
        U2, lm2, _, _ = comp.guarded_step(self.U, self.lm, cin, sp, prep)
        for k, v in U2.items():
            self.U[k].copy_(v)
        for a, b in zip(_lm_tensors(self.lm), _lm_tensors(lm2)):
            a.copy_(b)

    def run(self, U, lm, ran, steps):
        """`steps` replays from (U, lm); adds the steps that ran to `ran`
        and returns new (U, lm), n_iter advanced by `steps`."""
        for k, v in U.items():
            self.U[k].copy_(v)
        for a, b in zip(_lm_tensors(self.lm), _lm_tensors(lm)):
            a.copy_(b)
        self.ran.zero_()
        for _ in range(steps):
            self.graph.replay()
        ran.add_(self.ran)
        U = {k: v.clone() for k, v in self.U.items()}
        return U, _clone_lm(self.lm)._replace(n_iter=lm.n_iter + steps)


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
        self.device = _resolve_device(options.get("device", "cuda"))
        self.dtype = torch.float64 if spec.double_precision else torch.float32
        self.timing_level = int(options.get("timing_level", 1))
        self.timer = Timer()
        # k nonlinear steps a dispatch (thallo_tpu/plan.py:674-749): on the
        # card one CUDA graph of the guarded step, replayed k times
        self.steps_per_dispatch = int(options.get("steps_per_dispatch", 1))
        # a torch.profiler trace of each solve, written into this directory
        self.trace_dir = options.get("trace_dir")
        self._graph = None

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
        prof = None
        if options.get("profile_compile"):
            # the build profiled (thallo_tpu/plan.py:229-241): the top 15
            # by cumulative time
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        self.compiled = CompiledSolver(spec, groups, uses_lambda, self.dtype, options,
                                       self.device)
        if prof is not None:
            import pstats

            prof.disable()
            pstats.Stats(prof).sort_stats("cumulative").print_stats(15)
        why = self.compiled.uncapturable()
        if self.steps_per_dispatch > 1 and self.device.type == "cuda" and why:
            raise NotImplementedError(
                f"steps_per_dispatch={self.steps_per_dispatch} on the card: {why}")
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
        # parallel.shard_plan_inputs: the mesh and dim name -> mesh axis
        self.mesh = None
        self._dim_axes = None

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
        self._graph = None  # its parameters are baked in

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

    def _bind(self, inputs):
        """Normalized global inputs -> _inputs and the prepared tables
        (under a mesh: this rank's view and its shard's tables)."""
        if self.mesh is None:
            self._inputs = inputs
            self._prep = self.compiled.prepare(inputs)
        else:
            from .parallel.mesh import bind_sharded

            self._inputs = bind_sharded(self, inputs)
        unknown_names = {im.name for im in self.spec.unknowns}
        self._const_inputs = {k: v for k, v in self._inputs.items() if k not in unknown_names}
        self._graph = None

    def _global_inputs(self):
        """The normalized global inputs, anew from the raw user inputs."""
        return self._normalize_inputs(self._maybe_sort_residuals(dict(self._raw_inputs0)))

    def init(self, inputs: Dict[str, np.ndarray]):
        """Bind user arrays and reset solver state.  Returns the initial cost."""
        inputs = self._maybe_sort_residuals(inputs)
        self._bind(self._normalize_inputs(inputs))
        self._U = {im.name: self._inputs[im.name].clone() for im in self.spec.unknowns}
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
        held = {k: self._inputs[k] for k in unknown_names}
        self._bind(self._normalize_inputs(self._maybe_sort_residuals(merged)))
        self._inputs.update(held)
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
        if self.timing_level >= 3 and self._iter == 0:
            # the per-kernel probe rows, once a solve (thallo_tpu/plan.py:628-632)
            self.kernel_stats()
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
        if max_t > 0 and self._out_of_time(max_t):
            self._finished = True
            return False
        return True

    def _out_of_time(self, max_t) -> bool:
        """The time limit, read on every rank's clock; under a mesh the
        ranks stop together, when the first of them is out of time."""
        late = time.perf_counter() - self._solve_t0 > max_t
        if self.mesh is None:
            return late
        from .parallel import comm

        return comm.all_min([int(not late)], self.device)[0] == 0

    def run_steps(self, n: int) -> int:
        """n nonlinear iterations back to back (at most the nIterations
        left) with no host read between them (thallo_tpu/plan.py:674-714).
        LM reads its stop flag once, after the batch: as in thallo_tpu, a
        stop set by a step inside the batch does not end it, the steps
        after it run (and may accept), and only the last step's flag ends
        the solve.  With steps_per_dispatch = k > 1, n // k dispatches of
        k guarded steps (thallo_tpu's _scan_step: under LM a step after a
        stop leaves the state as it was, and does not count in n_iter),
        then the n % k steps left unguarded, as JAX runs them; the count
        of steps run counts every step.  Returns the number of steps run."""
        if self._finished or n <= 0:
            return 0
        n = min(n, max(int(self.solver_parameters["nIterations"]) - self._iter, 0))
        if n <= 0:
            self._finished = True
            return 0
        comp = self.compiled
        U, lm = self._U, self._lm
        cin, sp, prep = self._step_inputs(), self._sp(), self._prep
        k = self.steps_per_dispatch
        with self.timer.event("Nonlinear Iteration"):
            if k > 1:
                ran = torch.zeros((), dtype=torch.int64, device=self.device)
                n0 = lm.n_iter
                U, lm = self._dispatch(U, lm, ran, (n // k) * k)
                stop = lm.finished
                for _ in range(n % k):
                    U, lm, stop, _ = comp.nonlinear_step(U, lm, cin, sp, prep)
            else:
                for _ in range(n):
                    U, lm, stop, _ = comp.nonlinear_step(U, lm, cin, sp, prep)
        self._U, self._lm = U, lm
        self._iter += n
        if comp.uses_lambda:
            if k > 1:  # the stop flag and the guarded steps that ran: one read
                stopped, n_ran = torch.stack([stop.to(torch.int64), ran]).tolist()
                self._lm = lm._replace(n_iter=n0 + n_ran + n % k)
            else:
                stopped = bool(stop)
            if stopped:
                self._finished = True
        if self._iter >= int(self.solver_parameters["nIterations"]):
            self._finished = True
        return n

    def _dispatch(self, U, lm, ran, steps):
        """`steps` guarded steps from (U, lm), adding those that ran (not
        frozen after an LM stop) to the device count `ran`: on the CPU one
        call of the guarded step each, on the card replays of its CUDA
        graph after an eager first step of a solve (n_iter == 0)."""
        comp = self.compiled
        cin, sp, prep = self._step_inputs(), self._sp(), self._prep

        def eager(U, lm):
            if comp.uses_lambda:
                ran.add_(~lm.finished)
            return comp.guarded_step(U, lm, cin, sp, prep)[:2]

        if self.device.type != "cuda":
            for _ in range(steps):
                U, lm = eager(U, lm)
            return U, lm
        if steps and lm.n_iter == 0:
            U, lm = eager(U, lm)
            steps -= 1
        if steps:
            U, lm = self._step_graph().run(U, lm, ran, steps)
        return U, lm

    def _step_graph(self) -> _StepGraph:
        """The plan's captured step, made anew when the solver parameters
        changed (set_solver_parameter, init, update_inputs, load_state and
        reset_unknowns drop it)."""
        sp = self._sp()
        if self._graph is None or self._graph.key != sp:
            self._graph = None  # the old pool goes before the new capture
            self._graph = _StepGraph(self.compiled, self._U, self._lm, self._step_inputs(), sp,
                                     self._prep)
        return self._graph

    def warmup(self) -> None:
        """One throwaway step (and cost) on copies of the state, so the
        first real step pays no kernel build, no first-call set-up of the
        torch ops and no allocator growth (thallo_tpu/plan.py:761-787); with
        steps_per_dispatch > 1 on the card, first the dispatch's graph,
        captured and replayed once on its copies (the capture empties the
        allocator's cache, which the throwaway step then refills).  The
        solver state is unchanged."""
        if self._inputs is None:
            raise RuntimeError("call init() first")
        if self.steps_per_dispatch > 1 and self.device.type == "cuda":
            self._step_graph().graph.replay()
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
        tracer = self._tracer() if self.trace_dir else contextlib.nullcontext()
        with tracer, self.timer.event("Total"):
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

    @contextlib.contextmanager
    def _tracer(self):
        """A torch.profiler trace of the block (CPU activity, and CUDA on
        the card) written into trace_dir as a Chrome trace
        (thallo_tpu/plan.py:797-800 writes jax.profiler's)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
            self._sync()
        prof.export_chrome_trace(os.path.join(
            self.trace_dir, f"thallo_solve_{os.getpid()}_{time.time_ns()}.json"))

    def cost(self) -> float:
        return float(self.compiled.cost(self._U, self._step_inputs(), self._prep["consts"]))

    def reset_unknowns(self):
        """Restore unknowns to their initial values."""
        if self._inputs is None:
            raise RuntimeError("call init() first")
        self._U = {im.name: self._inputs[im.name].clone() for im in self.spec.unknowns}
        self._graph = None
        self._finished = False
        self._iter = 0

    def unknowns(self) -> Dict[str, torch.Tensor]:
        """The unknowns as the plan holds them (under a mesh: this rank's
        owned blocks)."""
        return dict(self._U)

    def _whole(self, name, v):
        ctx = self.compiled.shard_ctx
        return v if ctx is None else ctx.whole(name, v)

    def get_unknown(self, name, squeeze=True):
        """The whole unknown image (under a mesh: gathered, on every rank)."""
        a = self._whole(name, self._U[name])
        if squeeze and a.shape[-1] == 1:
            a = a[..., 0]
        return a

    # -- checkpoint / resume: the same .npz layout as thallo_tpu ---------------
    def save_state(self, path: str):
        """Snapshot unknowns + LM scalars + iteration counter to an .npz
        (readable by thallo_tpu's Plan.load_state and by this one)."""
        if self._U is None:
            raise RuntimeError("nothing to save: call init() first")
        payload = {f"U::{k}": self._whole(k, v).cpu().numpy() for k, v in self._U.items()}
        payload.update({f"ssq::{k}": self._whole(k, v).cpu().numpy()
                        for k, v in self._lm.ssq.items()})
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return  # the ranks gathered with rank 0, which writes
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
        ctx = self.compiled.shard_ctx
        z = None
        if ctx is None or torch.distributed.get_rank() == 0:
            with np.load(path) as f:
                z = {k: f[k] for k in f.files}
        if ctx is not None:  # read on rank 0, every rank takes its blocks
            from .parallel import comm

            z = comm.broadcast_object(z, device=self.device)

        def dev(name, a):
            t = torch.as_tensor(np.asarray(a), dtype=self.dtype).to(self.device)
            return t if ctx is None else ctx.shard(name, t).clone()

        self._U = {k[len("U::"):]: dev(k[len("U::"):], v)
                   for k, v in z.items() if k.startswith("U::")}
        ssq = {k[len("ssq::"):]: dev(k[len("ssq::"):], v)
               for k, v in z.items() if k.startswith("ssq::")}
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
        self._graph = None

    def jacobian(self, dense: bool = False):
        """The Jacobian at the current unknowns (thallo_tpu/plan.py:883-896):
        COO (residuals, rows, cols, vals, (n_rows, n_cols)) as tensors on
        the plan's device, or, with dense=True, (residuals, J [n_rows,
        n_cols]).  Excluded unknowns' columns are zero.  Under a mesh
        every rank gets the unsharded plan's J (a collective)."""
        if self._inputs is None:
            raise RuntimeError("call init() first")
        if self.mesh is not None:
            from .parallel.mesh import global_jacobian

            return global_jacobian(self, dense)
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

    def kernel_stats(self, n_probe: int = 3, interior: bool = False) -> PerfSummary:
        """Per-kernel timing rows (thallo_tpu/plan.py:901-938): each
        solver-facing kernel of CompiledSolver.kernel_probe_fns (computeCost,
        PCGInit1, PCGStep1-3, PCGLinearUpdate) runs once to warm up, then
        n_probe times, each ended by a device sync, into the timer's stats.
        These are probes of each kernel alone; interior=True gives the
        production step's own kernels instead (_interior_kernel_stats).
        Runs on the first step at timing_level 3."""
        if self._U is None:
            raise RuntimeError("call init() before kernel_stats()")
        if interior:
            return self._interior_kernel_stats()
        U, lm, ins, sp, prep = self._U, self._lm, self._step_inputs(), self._sp(), self._prep
        probes = self.compiled.kernel_probe_fns()
        state = probes["PCGInit1"](U, lm, ins, sp, prep)
        calls = {
            "computeCost": lambda f: f(U, ins, prep),
            "PCGInit1": lambda f: f(U, lm, ins, sp, prep),
            "PCGStep1": lambda f: f(U, state, ins, sp, prep),
            "PCGStep2": lambda f: f(state),
            "PCGStep3": lambda f: f(state),
            "PCGLinearUpdate": lambda f: f(U, state),
        }
        for name, fn in probes.items():
            calls[name](fn)
            self._sync()
            for _ in range(n_probe):
                with self.timer.event(name):
                    calls[name](fn)
                    self._sync()
        return self.timer.summary()

    def _interior_kernel_stats(self, top_k: int = 20) -> PerfSummary:
        """The production step's own kernels (thallo_tpu/plan.py:940-980):
        one step to warm up, then one step under torch.profiler; the device
        kernels' durations summed by name (on a CPU plan the ops' own CPU
        time), the top_k pushed as "interior:<name>" rows.  Both steps
        advance the solve, as JAX's do."""
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self.step()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            self.step()
            self._sync()
        durs = {}
        if cuda:
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA and \
                        not getattr(e, "is_user_annotation", False) and \
                        not e.name.startswith("thallo::"):
                    durs[e.name] = durs.get(e.name, 0.0) + e.time_range.elapsed_us()
        else:
            for e in prof.key_averages():
                if not e.key.startswith("thallo::") and e.self_cpu_time_total > 0:
                    durs[e.key] = float(e.self_cpu_time_total)
        for name, us in sorted(durs.items(), key=lambda kv: -kv[1])[:top_k]:
            short = name.removeprefix("void ").replace("(anonymous namespace)::", "")
            self.timer.push(f"interior:{short[:48]}", us * 1e-6)
        return self.timer.summary()

    @property
    def final_cost(self):
        return self.cost()

    @property
    def num_iterations(self):
        return self._iter
