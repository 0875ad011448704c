"""Gauss-Newton / Levenberg-Marquardt outer loop with a preconditioned-
conjugate-gradient inner loop (counterpart of ``thallo_tpu/solver/gn.py``).

Each group runs one of these schedules of JᵀJ·p (``make_jtjp``):

* materialized JᵀJ, block-sparse (PRECOMPUTE_JTJ, the default for graph
  groups above the dense threshold): tables and blocks from the setup
  (solver/blocksparse.py), block-Jacobi preconditioner.  A group the
  tables refuse, as JAX's ``build_group_bsr`` does (a pure-stencil group,
  or tables over the padding budget), takes JAX's J-block path instead:
  its point Jacobians are stored and applied as under PRECOMPUTE_J below,
  under scalar Jacobi (the dense JᵀJ at <= 4096 unknowns);
* materialized JᵀJ, dense (PRECOMPUTE_JTJ at <= 4096 unknowns, any
  group): J by ``torch.func.jacfwd`` over the flattened unknowns, then
  A = JᵀJ and A·p by ``torch.matmul`` at the plan's full precision
  (``_matmul_full``: a global TF32 setting cannot leak into f32; f64
  products are f64);
* materialized J (PRECOMPUTE_J, from ``r.<name>.J.set_materialize(True)``,
  and APPLY_SEPARATELY, from ``r.<name>.Jp.set_materialize(True)``): the
  per-point Jacobians are stored at setup, JᵀF and diag(JᵀJ) (partial²
  per access, as thallo_tpu) are scattered from them, and every PCG
  iteration gathers p, forms J·p and scatters Jᵀ(J·p) (lower.py's
  ``scatter_slot``; a stencil slot's scatter is the roll back).  Eager
  torch materializes J·p between the two passes in both schedules, so
  APPLY_SEPARATELY's split (JAX's optimization barrier) is what
  PRECOMPUTE_J runs too.  No diag-pair blocks exist, so the
  preconditioner stays scalar Jacobi, as in thallo_tpu;
* LINEARIZE (the default for stencil groups) linearizes once per
  nonlinear step and applies J·p and Jᵀ(J·p) every PCG iteration.  In
  eager torch that linearization is the per-point Jacobians that
  ``jtf_and_diag`` computes anyway, so LINEARIZE applies JᵀJ·p from them
  as the materialized-J schedules do: about a hundred launches an
  iteration at image_warping 512², against six hundred for
  ``torch.func.jvp`` and ``vjp`` of the residual;
* INLINE (matrix-free): ``jvp`` and ``vjp`` of the residual anew every
  iteration.  A graph group's gathers are lower.py's ``SlotGather``, so
  the vjp's transposes take ``scatter_slot``'s route (the segment-sum
  kernel under ``THALLO_SEGSUM=tiled``, the aggregation kernel for a small
  image such as BA's cameras, else index_add_).  LINEARIZE on a graph
  group applies JᵀJ·p from the setup's point Jacobians through
  ``gather_slot``/``scatter_slot``, as on a stencil group.  Contraction
  groups, which JAX runs matrix-free, apply JᵀJ·p from their point
  Jacobians over the contracted slots ([rc, C, R, *dep]) under either;
* contraction blocking (a group with a ``con_block``, JAX's
  ``gn.py:517-525, 629-634``): −JᵀF and diag(JᵀJ) from
  ``blocked_jtf_diag`` and JᵀJ·p from ``blocked_jtjp`` every iteration,
  whatever the schedule, one contraction block's fiber at a time.

A group with materialized computed arrays takes its Jacobians over its
jac slots (the unknown slots and the composed ones, JAX's
``gn.py:550-556``): the block-sparse setup, the stored point Jacobians
and the scatters all run over ``g.jac_slots``.

Exclude masks (``Offset.Exclude(...)``) zero the excluded unknowns'
Jacobian columns in the setup, mask p on entry to and JᵀJ·p on exit
from ``apply_jtjp``, and mask the PCG's delta, as thallo_tpu does: an
excluded unknown never moves.  A mask whose expression reads no unknown
is evaluated once at ``prepare``.

Numerics follow the JAX solver step for step: -JᵀF and diag(JᵀJ),
Ceres-style LM damping with Jacobi scaling,
block-Jacobi inverses with unit-diagonal equilibration, PCG with the
residual reset and the Q/zeta early stop, and the trust-region
accept/revert.  The PCG loop runs ``lIterations`` iterations with no
host read: once the device-side ``stop`` flag is set, delta/r/p freeze
through ``torch.where`` (JAX exits its ``while_loop`` instead; the
results are the same).  Routing is at the plan's dtype everywhere (no
bf16 or f32-accumulated routing, as JAX has), so the zeta test
needs no noise floor.

``block_dtype="bf16"`` stores the block-sparse cross blocks as bf16 (as
JAX's ``.astype(block_dtype)``); the fused-pair kernels read them as
such, everything else upcasts, and all arithmetic stays at the plan's
dtype.

The linear solve of each step is PCG on the full system (the default),
or, by the plan option ``linear_solver`` (thallo_tpu/solver/gn.py:
211-229, 1032-1530): ``"schur_pcg"`` eliminates an unknown image whose
JᵀJ self-coupling is block-diagonal (BA points) and runs the same PCG on
the reduced keep system S = A_kk - A_ke A_ee⁻¹ A_ek, applied implicitly
through two damped block-sparse applies an iteration (so through the
fused-pair kernels); ``"schur_dense"`` assembles S densely from the
block-sparse blocks and solves it exactly (LU under LM; under GN, whose
S carries BA's gauge null space, the minimum-norm solution, as JAX's
``lstsq``); ``"direct"`` solves the dense damped normal equations from
the dense Jacobian.  ``schur_eliminate`` names the eliminated images
(default: the eligible image with the most elements) and
``schur_dense_max`` caps the kept system's DOF.

``double_precision`` (the plan's dtype f64) runs every array above in
f64: the unknowns, LM state, PCG vectors, block-sparse blocks and masks,
the Schur and direct solves, the dense JᵀJ; the kernels take their f64
instantiations on the card.

``coo_jacobian`` gives J as COO triplets from the setup's point
Jacobians and the slots' flat indices (the reference's J dump).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..lower import LoweredGroup, lower_pointwise
from ..schedule import DENSE_JTJ_MAX_UNKNOWNS
from ..ops import linalg
from ..spec import JTJpSchedule
from .blocksparse import bsr_apply, bsr_setup

# schedules that store the per-point Jacobians and apply JᵀJ·p from them
MATERIALIZED_J = (JTJpSchedule.PRECOMPUTE_J, JTJpSchedule.APPLY_SEPARATELY)
MATERIALIZED_JTJ = (JTJpSchedule.PRECOMPUTE_JTJ, JTJpSchedule.PRECOMPUTE_J_THEN_JTJ)
# schedules whose JᵀJ·p is applied from the per-point Jacobians that the
# setup stores (LINEARIZE: eager torch's linearization of a group)
POINT_JACOBIAN_APPLY = MATERIALIZED_J + (JTJpSchedule.LINEARIZE,)
# the block_dtype option (thallo_tpu/solver/gn.py:232-233): None keeps every
# JᵀJ block f32; "bf16" stores the block-sparse cross blocks as bf16 (diag
# blocks, -JᵀF and diag(JᵀJ) stay f32)
BLOCK_DTYPES = {None: None, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# unknown "super-vector" helpers: dicts name -> [*dims, C]
# ---------------------------------------------------------------------------
def tree_zeros_like(t):
    return {k: torch.zeros_like(v) for k, v in t.items()}


def tree_add(a, b):
    return {k: a[k] + b[k] for k in a}


def tree_sub(a, b):
    return {k: a[k] - b[k] for k in a}


def tree_scale(a, s):
    return {k: v * s for k, v in a.items()}


def tree_axpy(alpha, x, y):
    return {k: y[k] + alpha * x[k] for k in y}


def tree_mul(a, b):
    return {k: a[k] * b[k] for k in a}


def tree_dot(a, b):
    total = None
    for k in a:
        d = torch.dot(a[k].reshape(-1), b[k].reshape(-1))
        total = d if total is None else total + d
    return total


def tree_where(c, a, b):
    return {k: torch.where(c, a[k], b[k]) for k in a}


def apply_masks(t, masks):
    """t times the active mask ([*dims], 1 where the unknown may move) of
    each image that has one; images without an Exclude pass unchanged."""
    if not masks:
        return t
    return {k: v * masks[k][..., None] if k in masks else v for k, v in t.items()}


def _per_point(t, like):
    """[rc, R] per-point values against a Jacobian [rc, C, R, *dep]."""
    return t.reshape(t.shape[:1] + (1,) + t.shape[1:] + (1,) * (like.ndim - 3))


def _matmul_full(a, b):
    """torch.matmul at its operands' full precision: f32 with no TF32 on
    the card whatever the process-wide
    torch.backends.cuda.matmul.allow_tf32 (the flag is restored after), f64
    as f64 (TF32 never applies to it, and nothing rounds through f32).
    (torch.get_float32_matmul_precision is not read: it raises once the
    caller has mixed the legacy and the newer TF32 API.)"""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        flags.allow_tf32 = prev


def _cm_small_inv(M, C):
    """Inverse of N CxC blocks stored channel-major [C*C, N], C <= 3, by
    the adjugate formula: elementwise over the [*, N] rows."""
    m = [M[i] for i in range(C * C)]
    if C == 1:
        return (1.0 / m[0])[None, :]
    if C == 2:
        a, b, c, d = m
        inv = 1.0 / (a * d - b * c)
        return torch.stack([d * inv, -b * inv, -c * inv, a * inv])
    a, b, c, d, e, f, g, h, i = m
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    inv = 1.0 / (a * A + b * B + c * Cc)
    # adjugate transpose: inv[r, c] = cofactor[c, r] / det
    return torch.stack([A, D, G, B, E, H, Cc, F, I]) * inv


# ---------------------------------------------------------------------------
# solver parameters (reference defaults, thallo_tpu/solver/gn.py)
# ---------------------------------------------------------------------------
SOLVER_PARAMETER_DEFAULTS = {
    "residual_reset_period": 10,
    "min_relative_decrease": 1e-3,
    "min_trust_region_radius": 1e-32,
    "max_trust_region_radius": 1e16,
    "q_tolerance": 1e-4,
    "function_tolerance": 1e-6,
    "trust_region_radius": 1e4,
    "radius_decrease_factor": 2.0,
    "min_lm_diagonal": 1e-6,
    "max_lm_diagonal": 1e32,
    "max_solver_time_in_seconds": 0.0,
    "nIterations": 10,
    "lIterations": 10,
}


class SolverParams(NamedTuple):
    """Solver parameters as host scalars: they enter device arithmetic as
    Python numbers (no transfer) and the PCG iteration count is static."""

    residual_reset_period: int
    min_relative_decrease: float
    min_trust_region_radius: float
    max_trust_region_radius: float
    q_tolerance: float
    function_tolerance: float
    min_lm_diagonal: float
    max_lm_diagonal: float
    lIterations: int

    @staticmethod
    def from_dict(d):
        return SolverParams(
            residual_reset_period=int(d["residual_reset_period"]),
            min_relative_decrease=float(d["min_relative_decrease"]),
            min_trust_region_radius=float(d["min_trust_region_radius"]),
            max_trust_region_radius=float(d["max_trust_region_radius"]),
            q_tolerance=float(d["q_tolerance"]),
            function_tolerance=float(d["function_tolerance"]),
            min_lm_diagonal=float(d["min_lm_diagonal"]),
            max_lm_diagonal=float(d["max_lm_diagonal"]),
            lIterations=int(d["lIterations"]),
        )


class LMState(NamedTuple):
    """Per-solve mutable state: device scalars, except the host-known
    iteration count."""

    trust_region_radius: torch.Tensor
    radius_decrease_factor: torch.Tensor
    prev_cost: torch.Tensor
    n_iter: int
    ssq: Any  # saved diag(JᵀJ) at iter 0 (JacobiScaling ONCE_PER_SOLVE)
    finished: torch.Tensor


@dataclasses.dataclass
class GroupPlan:
    name: str
    group: LoweredGroup
    schedule: JTJpSchedule
    # user's set_sparse(True) hint: the block-sparse JᵀJ tables regardless
    # of the dense-size threshold
    force_sparse: bool = False
    # the autoscheduler's compute_at_output decision (schedule.py), recorded
    compute_at_output: bool = False


# ---------------------------------------------------------------------------
# the compiled solver
# ---------------------------------------------------------------------------
class CompiledSolver:
    """Lowered groups + the step for one problem at fixed dim sizes.

    Methods keep thallo_tpu's names and signatures (the twin_consts
    argument included, unused here), so a parity test calls the same
    function on both packages.  ``masks`` maps each image with an Exclude
    to its active mask [*dims]; images without one are absent."""

    def __init__(self, spec, groups: List[GroupPlan], uses_lambda: bool, dtype,
                 options, device):
        self.spec = spec
        self.groups = groups
        self.uses_lambda = uses_lambda
        self.dtype = dtype
        self.device = device
        self.use_preconditioner = spec.use_preconditioner
        self.guarded_invert_type = options.get("guarded_invert_type", "CERES")
        self.jacobi_scaling = options.get("jacobi_scaling", "ONCE_PER_SOLVE")
        self.block_dtype = BLOCK_DTYPES[options.get("block_dtype")]
        # linear_solver (thallo_tpu/solver/gn.py:211-229): "direct" solves
        # the dense normal equations; "schur_pcg"/"schur_dense" eliminate
        # the schur_eliminate images (default: auto-pick) and solve the
        # reduced system by PCG or densely (at most schur_dense_max DOF)
        ls = options.get("linear_solver", "pcg")
        self.direct_solve = ls == "direct"
        self.schur = ls in ("schur_pcg", "schur_dense")
        self.schur_dense = ls == "schur_dense"
        self.schur_dense_max = int(options.get("schur_dense_max", 8192))
        se = options.get("schur_eliminate")
        self.schur_eliminate = list(se) if se else None
        self.precond_kind = options.get("preconditioner", "auto")
        if self.precond_kind not in ("auto", "block_jacobi", "jacobi"):
            raise ValueError("preconditioner must be 'auto', 'block_jacobi' or 'jacobi'")
        # Exclude guards, lowered over their own domains (thallo_tpu's
        # _exclude_fns, gn.py:250-257)
        sizes = {d.name: d.size for d in spec.dims}
        self._exclude_fns = {
            im.name: lower_pointwise([im.exclude_expr], spec, sizes, dtype,
                                     name=f"exclude_{im.name}")
            for im in spec.unknowns if im.exclude_expr is not None}
        # set by parallel.mesh (thallo_tpu/solver/gn.py:243-249): the
        # rank's owned blocks and the step's collectives (a ShardCtx), with
        # `groups` the rank's views of the groups and _global_groups the
        # groups as planned; None without a mesh
        self.shard_ctx = None
        self._global_groups = None

    # -- layout ------------------------------------------------------------
    def unknown_layout(self):
        """(offsets dict, total) of each unknown image in the flattened
        super-vector."""
        offsets = {}
        total = 0
        for im in self.spec.unknowns:
            offsets[im.name] = total
            total += int(np.prod([d.size for d in im.dims])) * im.channels
        return offsets, total

    def flatten_U(self, t):
        return torch.cat([t[im.name].reshape(-1) for im in self.spec.unknowns])

    def unflatten_U(self, v):
        out, o = {}, 0
        for im in self.spec.unknowns:
            shape = tuple(d.size for d in im.dims) + (im.channels,)
            n = int(np.prod(shape))
            out[im.name] = v[o:o + n].reshape(shape)
            o += n
        return out

    def _wants_bsr(self, gp):
        """Whether this group materializes JᵀJ as block-sparse tables
        (graph groups above the dense threshold; any size under a Schur
        solve, which eliminates through the diag-pair blocks)."""
        if gp.schedule not in MATERIALIZED_JTJ:
            return False
        if gp.force_sparse or self.schur:
            return True
        return self.unknown_layout()[1] > DENSE_JTJ_MAX_UNKNOWNS

    def _onehot_exclude(self):
        """Images that must build row tables, not one-hot rows: the ones
        named to be eliminated (schur_dense reads an eliminated image's
        couplings from its row tables)."""
        if self.schur and self.schur_eliminate:
            return tuple(self.schur_eliminate)
        return ()

    def _is_dense(self, gp, c):
        """A materialized-JᵀJ group at <= DENSE_JTJ_MAX_UNKNOWNS unknowns
        whose tables (c, its prepared consts) were not built: JᵀJ as one
        dense matrix (thallo_tpu/solver/gn.py:643-651)."""
        return c["bsr"] is None and gp.schedule in MATERIALIZED_JTJ and \
            self.unknown_layout()[1] <= DENSE_JTJ_MAX_UNKNOWNS

    def _stores_jacs(self, gp, c):
        """Whether a group whose tables (c, its prepared consts) were not
        built applies JᵀJ·p from the point Jacobians its setup stores: the
        materialized-J schedules, LINEARIZE, and a materialized-JᵀJ group
        above the dense threshold (a pure-stencil group, or tables over the
        padding budget: JAX's J-block path, ``block_groups``,
        thallo_tpu/solver/gn.py:652-653, 689-713)."""
        return c["bsr"] is None and (gp.schedule in POINT_JACOBIAN_APPLY or (
            gp.schedule in MATERIALIZED_JTJ and not self._is_dense(gp, c)))

    def prepare(self, inputs):
        """Input-only precomputation, once per init: slot index tables,
        const-slot values, bounds and index-value arrays, per group the
        block-sparse tables or the scatter routes of the materialized-J
        schedules; the Exclude guards' constants and the masks of guards
        that read no unknown (evaluated here once, not every step)."""
        ex_consts = {name: g.prepared_consts(inputs, self.device)
                     for name, (g, _) in self._exclude_fns.items()}
        windows = self.shard_ctx.windows if self.shard_ctx is not None else None
        prep = {
            "consts": [gp.group.prepared_consts(inputs, self.device,
                                                want_bsr=self._wants_bsr(gp),
                                                onehot_exclude=self._onehot_exclude(),
                                                row_windows=windows)
                       for gp in self.groups],
            "twin_consts": [None] * len(self.groups),
            "exclude_consts": ex_consts,
        }
        prep["masks_static"] = {
            im.name: self._eval_mask(im, ex_consts, {})
            for im in self.spec.unknowns
            if im.name in self._exclude_fns and not self._exclude_fns[im.name][0].uslots}
        return prep

    # -- masks -----------------------------------------------------------------
    def _eval_mask(self, im, ex_consts, U):
        """[*dims] active mask of unknown image im: 0 where its Exclude
        guard is nonzero (thallo_tpu gn.py:385-402, the guard's domains
        mapped onto the image's dim order)."""
        g, fn = self._exclude_fns[im.name]
        v = fn(ex_consts[im.name], U)  # [*ext_shape, 1]
        ext_dims = [d.dim for d in g.ext_domains]
        if len(ext_dims) == len(im.dims) and all(any(dd is d for dd in ext_dims)
                                                 for d in im.dims):
            perm = [next(i for i, dd in enumerate(ext_dims) if dd is d) for d in im.dims]
            v = v.permute(*perm, v.ndim - 1)
        shape = tuple(d.size for d in im.dims)
        v = v.reshape(shape)
        return torch.where(v != 0, torch.zeros_like(v), torch.ones_like(v))

    def masks(self, inputs, U, static=None, ex_consts=None):
        """Active masks of the images with an Exclude: static ones from
        prepare, the rest (guards that read unknowns) from U."""
        out = dict(static or {})
        for im in self.spec.unknowns:
            if im.name in self._exclude_fns and im.name not in out:
                out[im.name] = self._eval_mask(im, ex_consts, U)
        return out

    def _mask_jacs_cm(self, g, jacsT, masks, consts):
        """Zero the Jacobian columns of excluded unknowns (thallo_tpu's
        _mask_jacs_cm): each slot's [rc, C, R] times its image's mask
        gathered at the slot."""
        if not masks:
            return jacsT
        out = []
        for i, slot in enumerate(g.jac_slots):
            m = masks.get(slot.image.name)
            out.append(jacsT[i] if m is None else jacsT[i] * g.gather_mask(i, m, consts))
        return out

    # -- residuals / cost ---------------------------------------------------
    def cost(self, U, inputs, consts):
        """0.5 * sum of squared residuals (under a mesh: U the owned
        shards; the ranks' parts summed by one all_reduce)."""
        sh = self.shard_ctx
        if sh is None:
            return self._cost_part(U, inputs, consts)
        return sh.allsum(self._cost_part(sh.gather_tree(U), inputs, consts))[0]

    def _cost_part(self, U, inputs, consts):
        """0.5 * this rank's sum of squared residuals at the whole U."""
        sh = self.shard_ctx
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for gi, (gp, c) in enumerate(zip(self.groups, consts)):
            if sh is not None and not sh.counts_cost(gi):
                continue
            r = gp.group.residuals_cm(U, inputs, c)
            total = total + torch.sum(r * r)
        return 0.5 * total

    def _targets(self, gi, whole, part):
        """Where group gi's per-unknown sums go: `whole` (complete sums:
        every group without a mesh, an unsharded group under one) or
        `part` (a sharded group's partial sums; zeros where this rank does
        not count the group, ShardCtx.target)."""
        sh = self.shard_ctx
        if sh is None or not sh.sharded[gi]:
            return whole
        if isinstance(part, tuple):
            return tuple(sh.target(gi, t) for t in part)
        return sh.target(gi, part)

    def _zeros_like_unknowns(self):
        return {im.name: torch.zeros(tuple(d.size for d in im.dims) + (im.channels,),
                                     dtype=self.dtype, device=self.device)
                for im in self.spec.unknowns}

    def jtf_and_diag(self, U, inputs, consts, masks, jac_store, twin_consts=None):
        """Returns (minus_jtf, diag, jac_store).  Block-sparse groups store
        their assembled blocks under jac_store[str(gi)]["bsr"]; the
        materialized-J and LINEARIZE groups store the per-point Jacobians
        under jac_store[str(gi)]["jacs"].  Every other group scatters Jᵀr and
        diag = partial² per access from its point Jacobians (thallo_tpu's
        semantics: two accesses of one residual aliasing one element add
        a² + b², not (a+b)²).  Excluded unknowns' columns are zeroed
        first.  Under a mesh U is what the rank's groups read (ShardCtx.
        gather: halo-extended blocks or whole images), masks over the same,
        and the sums come back as the rank's owned shards."""
        sh = self.shard_ctx
        if sh is None:
            mjtf, diag = self._zeros_like_unknowns(), self._zeros_like_unknowns()
        else:  # complete sums (unsharded groups) apart from partial ones
            mjtf, diag = {}, {}
        pj, pd = {}, {}

        def sub(t, name, v):
            t[name] = t[name] - v if name in t else -v

        def add(t, name, v):
            t[name] = t[name] + v if name in t else v

        for gi, (gp, c) in enumerate(zip(self.groups, consts)):
            g = gp.group
            tj, td = self._targets(gi, (mjtf, diag), (pj, pd))
            if g.con_block is not None:
                with record_function("thallo::blocked"):
                    _, jtr_d, d2_d, store = g.blocked_jtf_diag(U, inputs, c)
                jac_store[str(gi)] = {"blocked": store}
                for name, v in jtr_d.items():
                    sub(tj, name, v)
                for name, v in d2_d.items():
                    add(td, name, v)
                continue
            if not g.jac_slots:
                continue
            r, jacs = g.point_jacobians_cm(U, inputs, c)
            jacs = self._mask_jacs_cm(g, jacs, masks, c)
            if c["bsr"] is not None:
                jtr_d, d2_d, blocks = bsr_setup(c["bsr"], r, jacs, self.block_dtype)
                jac_store[str(gi)] = {"bsr": blocks}
                for name, v in jtr_d.items():
                    sub(tj, name, v)
                for name, v in d2_d.items():
                    add(td, name, v)
                continue
            if self._stores_jacs(gp, c):
                jac_store[str(gi)] = {"jacs": tuple(jacs)}
            for i, slot in enumerate(g.jac_slots):
                J = jacs[i]  # [rc, C, R, *dep]
                C = J.shape[1]
                # Jᵀr and partial² stacked, so one scatter carries both
                parts = torch.cat([(J * _per_point(r, J)).sum(0), (J * J).sum(0)])
                both = g.scatter_slot(i, parts, c)  # [*dims, 2C]
                name = slot.image.name
                sub(tj, name, both[..., :C])
                add(td, name, both[..., C:])
        if sh is not None:
            mjtf, diag = sh.own_tree(pj, mjtf), sh.own_tree(pd, diag)
        return mjtf, diag, jac_store

    def make_jtjp(self, U, inputs, consts, masks, jac_store, twin_consts=None,
                  U_whole=None, masks_whole=None):
        """Ap(p) = sum_g J_gᵀ J_g p for the current linearization point,
        honoring each group's schedule (thallo_tpu/solver/gn.py:608-716):
        the blocks assembled this step (block-sparse groups), a dense JᵀJ
        (<= DENSE_JTJ_MAX_UNKNOWNS), jvp then vjp anew (INLINE), or the
        per-point Jacobians stored this step (materialized J, LINEARIZE,
        and a materialized-JᵀJ group whose tables were not built: gather
        p, J·p, scatter Jᵀ(J·p)).  p is masked on entry and Ap on exit.
        Under a mesh U, p and Ap are owned shards (masks too: masks_whole
        are the whole images): p is gathered, a sharded group's products
        are partial sums brought to their owners, and a sharded group's
        dense JᵀJ is summed over the ranks once, here (U_whole: U
        gathered already)."""
        sh = self.shard_ctx
        pairs, jac_groups, dense_mats, inline, blocked = [], [], [], [], []
        if U_whole is None:
            U_whole = U if sh is None else sh.gather_tree(U)

        def residual_fn(g, c):
            return lambda X: g.residuals_cm(X, inputs, c)

        for gi, gp in enumerate(self.groups):
            g, c = gp.group, consts[gi]
            if not g.jac_slots:
                continue
            entry = jac_store.get(str(gi), {})
            if "blocked" in entry:
                blocked.append((gi, g, c, entry["blocked"]))
            elif "bsr" in entry:
                pairs.append((gi, c["bsr"], entry["bsr"]))
            elif self._stores_jacs(gp, c):
                jac_groups.append((gi, g, c, entry["jacs"]))
            elif self._is_dense(gp, c):
                _, J = self.dense_jacobian(U_whole, inputs, consts,
                                           masks if masks_whole is None else masks_whole, [gi])
                A = _matmul_full(J.T, J)
                if sh is not None and sh.sharded[gi]:
                    A = sh.all_reduce(A if sh.counted[gi] else torch.zeros_like(A))
                dense_mats.append(A)
            else:  # INLINE
                inline.append((gi, residual_fn(g, c)))

        def add(Ap, contrib):
            for name, v in contrib.items():
                Ap[name] = Ap[name] + v if name in Ap else v

        def apply_jtjp(p):
            pm = apply_masks(p, masks)
            if sh is None:
                Ap, part = tree_zeros_like(p), None
            else:
                pm, Ap, part = sh.gather_tree(pm), {}, {}
            for gi, bsr, blocks in pairs:
                add(self._targets(gi, Ap, part), bsr_apply(bsr, blocks, pm))
            if dense_mats:
                pflat = self.flatten_U(pm)
                acc = None
                for A in dense_mats:
                    v = _matmul_full(A, pflat)
                    acc = v if acc is None else acc + v
                add(Ap, self.unflatten_U(acc))
            for gi, res_fn in inline:
                _, Jp = torch.func.jvp(res_fn, (U_whole,), (pm,))
                add(self._targets(gi, Ap, part), torch.func.vjp(res_fn, U_whole)[1](Jp)[0])
            for gi, g, c, store in blocked:
                with record_function("thallo::blocked"):
                    add(self._targets(gi, Ap, part), g.blocked_jtjp(store, pm, c))
            for gi, g, c, jacs in jac_groups:
                Jp = None  # [rc, R]: sum over slots of J_slot · p_slot
                for i in range(len(g.jac_slots)):
                    term = (jacs[i] * g.gather_slot(i, pm, c)[None]).sum(1)
                    term = term.reshape(term.shape[0], g.R, -1).sum(-1)  # contracted axes
                    Jp = term if Jp is None else Jp + term
                for i, slot in enumerate(g.jac_slots):
                    contrib = (jacs[i] * _per_point(Jp, jacs[i])).sum(0)  # [C, R, *dep]
                    add(self._targets(gi, Ap, part),
                        {slot.image.name: g.scatter_slot(i, contrib, c)})
            if sh is not None:
                Ap = sh.own_tree(part, Ap)
            return apply_masks(Ap, masks)

        return apply_jtjp

    def dense_jacobian(self, U, inputs, consts, masks, group_indices=None):
        """J as a dense [n_residual_values, n_unknowns] matrix, rows in
        thallo_tpu's order (point-major, then residual channel), by
        torch.func.jacfwd over the flattened unknowns; excluded unknowns'
        columns zeroed.  Returns (r_all, J) (thallo_tpu gn.py:749-780)."""
        sel = range(len(self.groups)) if group_indices is None else group_indices
        u0 = self.flatten_U(U)
        mflat = None
        if masks:
            mflat = self.flatten_U(apply_masks(
                {k: torch.ones_like(v) for k, v in U.items()}, masks))
        rows, jmats = [], []
        for gi in sel:
            g, c = self.groups[gi].group, consts[gi]

            def res_flat(u, g=g, c=c):
                return g.residuals_cm(self.unflatten_U(u), inputs, c).T.reshape(-1)

            J = torch.func.jacfwd(res_flat)(u0)
            rows.append(res_flat(u0))
            jmats.append(J if mflat is None else J * mflat[None, :])
        return torch.cat(rows), torch.cat(jmats)

    def coo_jacobian(self, U, inputs, consts, masks):
        """J as COO (thallo_tpu gn.py:782-821): (residuals, rows, cols,
        vals, (n_rows, n_cols)).  Rows are numbered across groups, each
        group's point-major then residual channel (dense_jacobian's
        order); cols index the flattened unknown vector (unknown_layout).
        Built from the setup's point Jacobians [rc, C, R, *dep] and each
        jac slot's flat element indices (stencil slots wrap as their rolls
        do), excluded unknowns' entries zeroed as in the setup; an entry
        per (point, residual channel, slot, contracted index, channel),
        zeros included, as JAX lists them.  Index tensors are int64."""
        offsets, total = self.unknown_layout()
        dev = self.device
        rows_l, cols_l, vals_l, res_l = [], [], [], []
        row_base = 0
        for gp, c in zip(self.groups, consts):
            g = gp.group
            r, jacs = g.point_jacobians_cm(U, inputs, c)
            jacs = self._mask_jacs_cm(g, jacs, masks, c)
            R, rc = g.R, g.rc
            for i, slot in enumerate(g.jac_slots):
                J = jacs[i]  # [rc, C, R, *dep]
                C = J.shape[1]
                dep = tuple(J.shape[3:])
                flat = torch.from_numpy(g._slot_flat_indices(slot, inputs).astype(np.int64))
                flat = flat.to(dev).reshape((R,) + dep)
                # [R, rc, *dep, C], JAX's layout of a point Jacobian
                Jr = J.movedim(2, 0).movedim(2, -1)
                rows = row_base + torch.arange(R * rc, device=dev).reshape(
                    (R, rc) + (1,) * (len(dep) + 1))
                cols = offsets[slot.image.name] + flat[:, None, ..., None] * C + \
                    torch.arange(C, device=dev)
                rows_l.append(rows.expand(Jr.shape).reshape(-1))
                cols_l.append(cols.expand(Jr.shape).reshape(-1))
                vals_l.append(Jr.reshape(-1))
            res_l.append(r.T.reshape(-1))
            row_base += R * rc
        return (torch.cat(res_l), torch.cat(rows_l), torch.cat(cols_l), torch.cat(vals_l),
                (row_base, total))

    def model_cost(self, U, inputs, consts, delta):
        """0.5 |r + J delta|^2 through a forward-mode JVP (under a mesh: U
        and delta the owned shards)."""
        sh = self.shard_ctx
        if sh is None:
            return self._model_cost_part(U, inputs, consts, delta)
        return sh.allsum(self._model_cost_part(sh.gather_tree(U), inputs, consts,
                                               sh.gather_tree(delta)))[0]

    def _model_cost_part(self, U, inputs, consts, delta):
        """0.5 * this rank's |r + J delta|^2 at the whole U and delta."""
        sh = self.shard_ctx
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for gi, (gp, c) in enumerate(zip(self.groups, consts)):
            if sh is not None and not sh.counts_cost(gi):
                continue
            g = gp.group
            r, Jd = torch.func.jvp(lambda X: g.residuals_cm(X, inputs, c), (U,), (delta,))
            m = r + Jd
            total = total + torch.sum(m * m)
        return 0.5 * total

    def guarded_invert(self, t):
        kind = self.guarded_invert_type
        if kind == "MODIFIED_CERES":
            f = lambda p: 1.0 / (1.0 + p)  # noqa: E731
        elif kind == "EPSILON_ADD":
            eps = torch.finfo(self.dtype).eps
            f = lambda p: 1.0 / (eps + p)  # noqa: E731
        else:  # CERES (default)
            f = lambda p: 1.0 / torch.square(1.0 + torch.sqrt(p))  # noqa: E731
        return {k: f(v) for k, v in t.items()}

    # -- the nonlinear step --------------------------------------------------
    def solve_setup(self, U, lm: LMState, inputs, sp: SolverParams, prep):
        """Phase 1: r0 = -JᵀF, diag(JᵀJ), preconditioner, LM damping and
        the block-sparse JᵀJ assembly."""
        consts = prep["consts"]
        # under a mesh: the view of U the residuals read (the sums come
        # back owned), the masks whole, over that view and owned
        sh = self.shard_ctx
        Uw = U if sh is None else sh.gather_tree(U)
        masks_whole = self.masks(inputs, Uw, prep.get("masks_static"),
                                 prep.get("exclude_consts"))
        masks = masks_view = masks_whole
        if sh is not None:
            masks_view = {k: sh.window(k, m) for k, m in masks_whole.items()}
            masks = {k: sh.shard(k, m) for k, m in masks_whole.items()}
        jac_store = {}
        mjtf, rawdiag, jac_store = self.jtf_and_diag(Uw, inputs, consts, masks_view, jac_store)
        if self.uses_lambda:
            ssq = rawdiag if lm.n_iter == 0 else lm.ssq
            radius = lm.trust_region_radius
            unclamped = tree_scale(rawdiag, 1.0 / radius)
            scale_src = rawdiag if self.jacobi_scaling == "EVERY_ITERATION" else ssq
            CtC = {}
            for k, unc in unclamped.items():
                if self.jacobi_scaling == "NONE":
                    mult = 1.0 / radius
                else:
                    mult = (1.0 / torch.clamp(scale_src[k], min=1e-30)) / radius
                CtC[k] = torch.minimum(torch.maximum(unc, sp.min_lm_diagonal * mult),
                                       sp.max_lm_diagonal * mult)
            pre = {k: 1.0 / (CtC[k] + radius * unclamped[k]) for k in CtC}
        else:
            ssq = lm.ssq
            CtC = tree_zeros_like(rawdiag)
            pre = self.guarded_invert(rawdiag)
        if not self.use_preconditioner:
            pre = {k: torch.ones_like(v) for k, v in pre.items()}
        pre_block = {}
        if self.precond_kind in ("auto", "block_jacobi") and self.use_preconditioner:
            pre_block = self._block_preconditioner(consts, jac_store, rawdiag, CtC, lm)
        return {
            "masks": masks,
            "masks_whole": masks_whole,
            "jac_store": jac_store,
            "r0": mjtf,
            "pre": pre,
            "pre_block": pre_block,
            "CtC": CtC,
            "ssq": ssq,
            "rawdiag": rawdiag,
            "U_whole": Uw,
        }

    # -- block-Jacobi preconditioner -----------------------------------------
    def _block_preconditioner(self, consts, jac_store, rawdiag, CtC, lm):
        """Per-unknown-element CxC inverses of the damped JᵀJ block
        diagonal (from the setup's diag-pair blocks).  Images no
        block-sparse group touches get none: they stay scalar Jacobi."""
        B = self._diag_pair_blocks(consts, jac_store)
        return self._invert_damped_blocks(B, rawdiag, CtC)

    def _diag_pair_blocks(self, consts, jac_store, names=None):
        """The block diagonal of the groups' JᵀJ per unknown image (those
        in `names`, when given), channel-major [C*C, N] (under a mesh: the
        rank's owned elements, the sharded groups' blocks summed over the
        ranks)."""
        B, part = {}, {}
        for gi in range(len(self.groups)):
            bsr = consts[gi]["bsr"]
            if bsr is None:
                continue
            blocks = jac_store[str(gi)]["bsr"]
            tgt = self._targets(gi, B, part)
            for p_idx, pr in enumerate(bsr.pairs):
                if pr[2] != "diag":
                    continue
                name = bsr.slot_images[pr[0]]
                if bsr.slot_images[pr[1]] != name:
                    continue  # cross-image aliasing: off the block diagonal
                if names is not None and name not in names:
                    continue
                blk = bsr.diag_full(p_idx, blocks[p_idx])
                tgt[name] = tgt[name] + blk if name in tgt else blk
        sh = self.shard_ctx
        if sh is not None:
            B = {k: sh.own_blocks(k, part.get(k), B.get(k)) for k in sh.names
                 if k in part or k in B}
        return B

    def _invert_damped_blocks(self, B, rawdiag, CtC, guard_gn=True):
        """Invert per-element CxC blocks after damping their diagonals: LM
        adds diag(CtC) (the exact damped blocks, which the Schur
        elimination needs too); GN applies the CERES guarded transform
        (guard_gn: the preconditioner) or inverts the undamped blocks (the
        Schur elimination)."""
        out = {}
        for name, blk in B.items():
            C = int(round(blk.shape[0] ** 0.5))
            N = blk.shape[1]
            diag_ix = torch.arange(C, device=blk.device) * (C + 1)
            bdiag = blk[diag_ix]  # [C, N]
            raw = rawdiag[name].reshape(N, C).T
            extra = torch.clamp(raw - bdiag, min=0.0)  # other groups' diag
            if self.uses_lambda:
                new_diag = bdiag + extra + CtC[name].reshape(N, C).T
            elif guard_gn:
                new_diag = torch.square(1.0 + torch.sqrt(torch.clamp(bdiag + extra, min=0.0)))
            else:
                new_diag = bdiag + extra
            M = blk.clone()
            M[diag_ix] = new_diag
            # Jacobi equilibration: untouched elements carry ~1e24 damping,
            # whose determinant overflows f32; M = D M' D with unit-diagonal M'
            d = torch.sqrt(torch.clamp(new_diag, min=1e-30))  # [C, N]
            dd = (d[:, None, :] * d[None, :, :]).reshape(C * C, N)
            Mn = M / dd
            if C <= 3:
                inv_n = _cm_small_inv(Mn, C)
            else:
                # inv_ex reports a singular block in its info tensor instead
                # of raising: the block goes non-finite, as jnp.linalg.inv's
                # does, and the PCG's isfinite stop takes over; no host read
                Minv = torch.linalg.inv_ex(Mn.reshape(C, C, N).permute(2, 0, 1)).inverse
                inv_n = Minv.permute(1, 2, 0).reshape(C * C, N)
            out[name] = inv_n / dd
        return out

    @staticmethod
    def _block_apply(pb, v):
        """y = B v per element: pb [C*C, N] channel-major, v [..., C]."""
        C = v.shape[-1]
        rT = v.reshape(-1, C).T  # [C, N]
        zT = torch.sum(pb.reshape(C, C, -1) * rT[None, :, :], dim=1)
        return zT.T.reshape(v.shape)

    def precond_apply(self, state, r):
        """z = M^-1 r: block matvec for block-Jacobi images, scalar Jacobi
        for the rest."""
        pre_block = state.get("pre_block") or {}
        out = {}
        for k, v in r.items():
            pb = pre_block.get(k)
            out[k] = state["pre"][k] * v if pb is None else self._block_apply(pb, v)
        return out

    def linear_solve(self, U, state, inputs, sp: SolverParams, prep):
        """Phase 2: the damped normal equations -> masked delta, by the
        plan's linear_solver (thallo_tpu gn.py:1499-1530): PCG on the full
        system, PCG or a dense solve on the Schur-reduced system, or the
        dense direct solve."""
        consts, masks, CtC = prep["consts"], state["masks"], state["CtC"]
        if self.direct_solve:
            return apply_masks(self._direct_solve(U, state, inputs, consts), masks)
        apply_jtjp = self.make_jtjp(U, inputs, consts, masks, state["jac_store"],
                                    U_whole=state["U_whole"],
                                    masks_whole=state.get("masks_whole"))

        def damped(pvec):
            Ap = apply_jtjp(pvec)
            if self.uses_lambda:
                Ap = tree_add(Ap, tree_mul(CtC, pvec))
            return Ap

        if self.schur:
            delta = self._linear_solve_schur(state, sp, damped, consts)
        else:
            delta = self._pcg(damped, lambda r: self.precond_apply(state, r), state["r0"], sp)
        return apply_masks(delta, masks)

    def _pcg(self, A, precond, b, sp: SolverParams):
        """PCG on A(delta) = b from delta = 0: lIterations iterations with
        no host read, frozen through torch.where once the device-side
        `stop` flag is set (JAX exits its while_loop instead; the results
        are the same).  LM resets the residual every residual_reset_period
        iterations and stops on the Q/zeta test."""
        sh = self.shard_ctx
        if sh is None:
            dot, allsum = tree_dot, lambda *xs: xs
        else:  # a rank's part of each dot, the scalars of one point summed at once
            dot, allsum = sh.local_dot, sh.allsum
        p = precond(b)
        r = b
        alpha_num, = allsum(dot(b, p))
        delta = tree_zeros_like(b)
        Q0 = torch.zeros((), dtype=self.dtype, device=self.device)
        stop = torch.zeros((), dtype=torch.bool, device=self.device)

        def safe_div(num, den):
            if self.uses_lambda:
                return num / den
            ok = den != 0.0
            return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                               torch.zeros_like(num))

        for i in range(sp.lIterations):
            Ap = A(p)
            pAp, = allsum(dot(p, Ap))
            alpha = safe_div(alpha_num, pAp)
            delta_n = tree_axpy(alpha, p, delta)
            if self.uses_lambda and (i + 1) % sp.residual_reset_period == 0:
                r_n = tree_sub(b, A(delta_n))  # residual reset: r = b - A delta
            else:
                r_n = tree_axpy(-alpha, Ap, r)
            z = precond(r_n)
            if self.uses_lambda:
                beta_num, q = allsum(dot(z, r_n), dot(delta_n, tree_add(r_n, b)))
                Q1 = 0.5 * q
                zeta = (i + 1) * (Q1 - Q0) / Q1
                stop_q = ~torch.isfinite(Q1) | ~torch.isfinite(zeta)
                if sp.q_tolerance >= 0:
                    stop_q = stop_q | (zeta < sp.q_tolerance)
            else:
                beta_num, = allsum(dot(z, r_n))
                Q1, stop_q = Q0, torch.zeros_like(stop)
            p_n = tree_add(z, tree_scale(p, safe_div(beta_num, alpha_num)))
            active = ~stop
            delta = tree_where(active, delta_n, delta)
            r = tree_where(active, r_n, r)
            p = tree_where(active, p_n, p)
            alpha_num = torch.where(active, beta_num, alpha_num)
            Q0 = torch.where(active, Q1, Q0)
            stop = stop | stop_q
        return delta

    def _direct_solve(self, U, state, inputs, consts):
        """The dense direct solve (thallo_tpu gn.py:1515-1530): J from
        dense_jacobian, (JᵀJ + diag(CtC)) delta = -Jᵀr in full f32, with
        identity rows for excluded unknowns so the system stays regular.
        solve_ex runs no info check (no host read): a singular system
        gives a non-finite delta, as jnp.linalg.solve's.  Under a mesh
        (every owned image read whole) each rank's groups give their part
        of JᵀJ and Jᵀr, summed by one all_reduce; every rank solves and
        keeps its owned part."""
        sh = self.shard_ctx
        masks = state.get("masks_whole", state["masks"])
        Uw, CtC = U, state["CtC"]
        if sh is None:
            r_all, J = self.dense_jacobian(U, inputs, consts, masks)
            A, g = _matmul_full(J.T, J), _matmul_full(J.T, r_all)
        else:
            Uw, CtC = state["U_whole"], sh.whole_tree(CtC)
            sel = [gi for gi in range(len(self.groups)) if sh.counts_cost(gi)]
            K = self.unknown_layout()[1]
            Ag = torch.zeros((K, K + 1), dtype=self.dtype, device=self.device)
            if sel:
                r_all, J = self.dense_jacobian(Uw, inputs, consts, masks, sel)
                Ag = torch.cat([_matmul_full(J.T, J), _matmul_full(J.T, r_all)[:, None]], 1)
            Ag = sh.all_reduce(Ag)
            A, g = Ag[:, :K], Ag[:, K]
        mflat = self.flatten_U(apply_masks({k: torch.ones_like(v) for k, v in Uw.items()},
                                           masks))
        if self.uses_lambda:
            A = A + torch.diag(self.flatten_U(CtC))
        A = A + torch.diag(1.0 - mflat)
        delta = self.unflatten_U(torch.linalg.solve_ex(A, -g).result)
        return delta if sh is None else {k: sh.shard(k, v) for k, v in delta.items()}

    # -- Schur-complement reduced solves ---------------------------------------
    def _schur_partition(self, consts, jac_store):
        """(keep, elim) unknown-image names (thallo_tpu gn.py:1032-1107),
        from the tables alone (no device value): an eliminated image's
        JᵀJ self-coupling must be exactly block-diagonal (every group
        that reads it is block-sparse, with only "diag" self-pairs; BA
        points), it must not run in one-hot row mode under schur_dense,
        and eliminated images must not couple to each other.
        schur_eliminate overrides the pick of the eligible image with the
        most elements."""
        elements = {im.name: int(np.prod([d.size for d in im.dims]))
                    for im in self.spec.unknowns}
        touched_non_bsr, self_offdiag, has_diag_blocks, onehot_imgs = set(), set(), set(), set()
        cross = {}
        for gi, gp in enumerate(self.groups):
            g = gp.group
            if not g.jac_slots:
                continue
            bsr = consts[gi]["bsr"]
            if bsr is None or "bsr" not in jac_store.get(str(gi), {}):
                touched_non_bsr.update(s.image.name for s in g.uslots)
                continue
            for pr in bsr.pairs:
                a, b = bsr.slot_images[pr[0]], bsr.slot_images[pr[1]]
                if a == b:
                    (has_diag_blocks if pr[2] == "diag" else self_offdiag).add(a)
                else:
                    cross.setdefault(a, set()).add(b)
            onehot_imgs.update(bsr.slot_images[i] for i, x in enumerate(bsr.oh_idxs)
                               if x is not None)
        eligible = [n for n in elements
                    if n in has_diag_blocks and n not in self_offdiag
                    and n not in touched_non_bsr
                    and not (self.schur_dense and n in onehot_imgs)]
        if self.schur_eliminate is not None:
            elim = list(self.schur_eliminate)
            bad = [n for n in elim if n not in eligible]
            if bad:
                raise ValueError(
                    f"schur_eliminate images {bad} are not block-diagonal-"
                    f"eliminable (eligible: {eligible}); each must be "
                    "referenced only by block-sparse groups with purely "
                    "diagonal self-coupling")
        else:
            if not eligible:
                raise ValueError(
                    "linear_solver='schur_pcg' found no eliminable unknown "
                    "image (needs a graph unknown whose J^T J self-coupling "
                    "is block-diagonal, e.g. BA points)")
            elim = [max(eligible, key=lambda n: elements[n])]
        for a in elim:
            coupled = cross.get(a, set()) & set(elim)
            if coupled:
                raise ValueError(
                    f"schur_eliminate images couple to each other: {a} <-> "
                    f"{sorted(coupled)}; the eliminated block must stay "
                    "block-diagonal")
        keep = [n for n in elements if n not in elim]
        if not keep:
            raise ValueError("schur_pcg must keep at least one unknown image")
        return keep, elim

    def _linear_solve_schur(self, state, sp, damped, consts):
        """The reduced keep system S = A_kk - A_ke A_ee⁻¹ A_ek (A: the
        damped JᵀJ; thallo_tpu gn.py:1374-1478), then back-substitution
        δ_e = A_ee⁻¹ (b_e - A_ek δ_k).  A_ee⁻¹ is the eliminated images'
        block diagonal inverted (LM: damped; GN: undamped, unguarded).
        schur_pcg applies S implicitly, two damped applies and one block
        apply an iteration, in the PCG of the full system with the keep
        images' block Jacobi; schur_dense assembles S and solves it."""
        jac_store = state["jac_store"]
        keep, elim = self._schur_partition(consts, jac_store)
        Einv = self._invert_damped_blocks(
            self._diag_pair_blocks(consts, jac_store, names=set(elim)),
            state["rawdiag"], state["CtC"], guard_gn=False)
        bfull = state["r0"]

        def pad(part):
            return {k: part[k] if k in part else torch.zeros_like(v) for k, v in bfull.items()}

        def einv(t):
            return {k: self._block_apply(Einv[k], t[k]) for k in elim}

        def keep_of(t):
            return {k: t[k] for k in keep}

        # reduced right-hand side: b_k - A_ke A_ee⁻¹ b_e
        b = tree_sub(keep_of(bfull), keep_of(damped(pad(einv(bfull)))))
        if self.schur_dense:
            # under a mesh S is summed over the ranks and solved on each,
            # each keeping its owned part
            sh = self.shard_ctx
            S = self._schur_dense_matrix(state, consts, keep, elim, Einv)
            bw = b if sh is None else {n: sh.whole(n, b[n]) for n in keep}
            flat = self._dense_solve(S, torch.cat([bw[n].reshape(-1) for n in keep]))
            delta_k, o = {}, 0
            for n in keep:
                v = flat[o:o + bw[n].numel()].reshape(bw[n].shape)
                delta_k[n] = v if sh is None else sh.shard(n, v)
                o += bw[n].numel()
        else:
            def S_apply(xk):
                t = damped(pad(xk))
                return tree_sub(keep_of(t), keep_of(damped(pad(einv(t)))))

            # the keep images' (block) Jacobi: precond_apply reads r's images only
            delta_k = self._pcg(S_apply, lambda r: self.precond_apply(state, r), b, sp)
        w = damped(pad(delta_k))
        return pad({**delta_k, **einv(tree_sub(bfull, w))})

    def _dense_solve(self, S, b):
        """S x = b for the assembled Schur complement: LU under LM
        (solve_ex: no info check, no host read); under GN, whose S is
        singular to working precision (BA's gauge null space), the
        minimum-norm least-squares solution that JAX's lstsq gives, from
        the eigendecomposition of the symmetric S with lstsq's cutoff
        (|λ| >= eps · K · max|λ|).  ops/linalg.eigh leaves cuSOLVER's info
        on the device up to SYEV_CAPTURE_MAX rows, so a CUDA graph holds
        the solve there.  (A Cholesky factor of S + δI does not give this
        solution: the spectrum of BA's S runs on across the cutoff, and
        any shift damps the kept directions near it; PERF.md §6.)"""
        if self.uses_lambda:
            return torch.linalg.solve_ex(S, b).result
        lam, V = linalg.eigh(S)
        mag = lam.abs()
        ok = (mag > 0) & (mag >= torch.finfo(S.dtype).eps * S.shape[0] * mag.max())
        inv = torch.where(ok, 1.0 / torch.where(ok, lam, torch.ones_like(lam)),
                          torch.zeros_like(lam))
        return _matmul_full(V, inv * _matmul_full(V.T, b))

    def _schur_dense_matrix(self, state, consts, keep, elim, Einv):
        """S = A_kk - A_ke A_ee⁻¹ A_ek assembled densely, [K, K] over the
        keep images' flattened unknowns (thallo_tpu gn.py:1109-1353), from
        the blocks the setup made this step (bf16 cross blocks upcast):
        the keep-keep cross blocks, one-hot "transpose" pairs read from
        their partner's blocks; the correction of each eliminated element
        p, -B_uᵀ A_pp⁻¹ B_v summed at the keep-element pair (cols_u[., p],
        cols_v[., p]) for each two of its keep couplings u, v (levels
        aligned on the smaller level's lanes); and the keep block diagonal
        with the exact damping and identity rows for excluded elements.
        Every col block is stored w-major [W*Ci*Cj, N_t] in the port.
        Under a mesh each rank assembles the part of its counted groups,
        at global element ids (a window's rows from its start), with the
        eliminated images' inverse blocks of its owned elements: exact
        where every eliminated element's residuals lie on its owner rank
        (local-complete); one all_reduce sums the parts and the keep block
        diagonals, and each rank adds the damping."""
        dtype, dev = self.dtype, self.device
        jac_store = state["jac_store"]
        masks = state.get("masks_whole", state["masks"])
        sh = self.shard_ctx
        elements = {im.name: (int(np.prod([d.size for d in im.dims])), im.channels)
                    for im in self.spec.unknowns}
        if sh is not None:
            Einv = dict(Einv)
            for e in elim:
                if sh.owned.get(e) is None:
                    if sh.size > 1:
                        raise ValueError(
                            f"linear_solver='schur_dense' under a mesh eliminates {e!r}, which "
                            "is replicated: map one of its dims to the mesh axis of the "
                            "residuals that read it")
                    continue
                if e not in sh.complete or e not in sh.windows:
                    raise ValueError(
                        f"linear_solver='schur_dense' under a mesh needs every residual of an "
                        f"eliminated element of {e!r} on the rank that owns the element: map "
                        "the residual dim to the same axis and sort the residuals by owner "
                        "(sort_edges_by_owner)")
                lo, hi = sh.windows[e]  # the owned elements
                Einv[e] = torch.nn.functional.pad(Einv[e], (lo, elements[e][0] - hi))
        offs, K = {}, 0
        for n in keep:
            offs[n] = K
            K += elements[n][0] * elements[n][1]
        if K > self.schur_dense_max:
            raise ValueError(
                f"linear_solver='schur_dense': kept system has {K} DOF > "
                f"schur_dense_max={self.schur_dense_max}; use schur_pcg "
                "or raise the plan option schur_dense_max")

        kk_diag = {}                          # keep image -> [C*C, N]
        kk_cross = []                         # (a, b, vals [M, Ca, Cb], ia [M], ib [M])
        couplings = {e: [] for e in elim}     # elim -> [(B [Ce, Ck, D, N_t], cols, keep, sel)]
        for gi, gp in enumerate(self.groups):
            if not gp.group.jac_slots or (sh is not None and not sh.counts_cost(gi)):
                continue
            bsr = consts[gi]["bsr"]
            entry = jac_store.get(str(gi), {})

            def rows_of(t, Nt, bsr=bsr):
                """Row table t's element ids (global: a window's count
                from its start), or None for every element in order."""
                sel, win = bsr.row_sels[t], bsr.window(t)
                if win is None:
                    return sel
                return (sel if sel is not None else torch.arange(Nt, device=dev)) + win[0]

            if bsr is None or "bsr" not in entry:
                raise ValueError(
                    "linear_solver='schur_dense' requires every residual "
                    f"group on the block-sparse path; group {gp.name} is "
                    "not (schedule it with JtJ.set_sparse(True))")
            blocks = entry["bsr"]
            for p_idx, pr in enumerate(bsr.pairs):
                i, j = pr[0], pr[1]
                a, b2 = bsr.slot_images[i], bsr.slot_images[j]
                Ca, Cb = bsr.slot_channels[i], bsr.slot_channels[j]
                Na = elements[a][0]
                if pr[2] == "transpose":
                    # the partner (j, i) col pair's blocks, B_ij = B_jiᵀ,
                    # laid out on the partner's row table
                    if a in elim:
                        raise ValueError(
                            f"schur_dense cannot eliminate {a!r}: it runs "
                            "in one-hot row mode (small image); set "
                            "THALLO_ONEHOT_ROWS=0 or eliminate the large "
                            "image instead")
                    if b2 in elim:
                        continue  # the partner pair carries this coupling
                    ct = bsr.col_gathers[bsr.pairs[pr[3]][3]][0]
                    W, Nt = bsr.cols[ct].shape
                    sel = rows_of(bsr.col_row[ct], Nt)
                    rows_b = sel if sel is not None else torch.arange(Nt, device=dev)
                    vals = blocks[pr[3]].to(dtype).reshape(W, Cb, Ca, Nt).permute(0, 3, 2, 1)
                    kk_cross.append((a, b2, vals.reshape(W * Nt, Ca, Cb),
                                     bsr.cols[ct].reshape(-1),
                                     rows_b[None, :].expand(W, Nt).reshape(-1)))
                    continue
                blk = blocks[p_idx].to(dtype)
                if pr[2] == "diag":
                    cols, sel = None, None
                    blk = bsr.diag_full(p_idx, blk)
                    B = blk.reshape(Ca, Cb, 1, Na)
                else:
                    ct = bsr.col_gathers[pr[3]][0]
                    cols = bsr.cols[ct]  # [W, N_t]
                    W, Nt = cols.shape
                    sel = rows_of(bsr.col_row[ct], Nt)
                    B = blk.reshape(W, Ca, Cb, Nt).permute(1, 2, 0, 3)  # [Ca, Cb, W, N_t]
                if a in elim:
                    if b2 in keep:
                        cu = cols if cols is not None else torch.arange(Na, device=dev)[None, :]
                        couplings[a].append((B, cu, b2, sel))
                    continue  # elim-elim: the (damped, inverted) Einv
                if b2 in elim:
                    continue  # the transpose of an elim-keep pair
                if a == b2 and pr[2] == "diag":
                    kk_diag[a] = kk_diag[a] + blk if a in kk_diag else blk
                    continue
                W, Nt = B.shape[2], B.shape[3]
                rows_a = sel if sel is not None else torch.arange(Nt, device=dev)
                ia = rows_a[None, :].expand(W, Nt).reshape(-1)
                ib = cols.reshape(-1) if cols is not None else rows_a
                kk_cross.append((a, b2, B.permute(2, 3, 0, 1).reshape(W * Nt, Ca, Cb), ia, ib))

        S = torch.zeros((K, K), dtype=dtype, device=dev)

        def block_view(a, bname):
            """S's (a, bname) block as [Na, Ca, Nb, Cb]."""
            (Na, Ca), (Nb, Cb) = elements[a], elements[bname]
            return S[offs[a]:offs[a] + Na * Ca,
                     offs[bname]:offs[bname] + Nb * Cb].view(Na, Ca, Nb, Cb)

        def segment_blocks(a, bname, vals, ia, ib):
            """vals [M, Ca*Cb] summed at element pair (ia, ib): [Na, Nb,
            Ca*Cb] (jax.ops.segment_sum's counterpart, index_add_)."""
            Na, Nb = elements[a][0], elements[bname][0]
            seg = torch.zeros((Na * Nb, vals.shape[1]), dtype=dtype, device=dev)
            seg.index_add_(0, ia.long() * Nb + ib.long(), vals)
            return seg.view(Na, Nb, elements[a][1], elements[bname][1])

        for (a, bname, vals, ia, ib) in kk_cross:
            block_view(a, bname).add_(
                segment_blocks(a, bname, vals.reshape(vals.shape[0], -1), ia, ib)
                .permute(0, 2, 1, 3))

        # the correction -A_ke A_ee⁻¹ A_ek, one (u, v) coupling pair at a
        # time on the smaller level's lanes; an element outside either
        # level has no observation in its rank range, so masked lanes
        # are exactly the empty products
        for e in elim:
            cps = couplings[e]
            if not cps:
                continue
            Ne, Ce = elements[e]
            G3 = Einv[e].reshape(Ce, Ce, Ne)
            GB = []
            for (B, _c, _k, sel) in cps:
                Gl = G3 if sel is None else G3.index_select(2, sel)
                GB.append(sum(Gl[:, c, None, None, :] * B[c][None] for c in range(Ce)))
            for (Bu, colsu, ku, selu) in cps:
                for (_Bv, colsv, kv, selv), GBv in zip(cps, GB):
                    valid = None
                    if selu is None and selv is None:
                        Bu_c, cu_c, GBv_c, cv_c = Bu, colsu, GBv, colsv
                    else:
                        u_fine = selv is None or (selu is not None
                                                  and Bu.shape[3] <= GBv.shape[3])
                        fine_sel, coarse_sel = (selu, selv) if u_fine else (selv, selu)
                        if coarse_sel is None:
                            pos = fine_sel
                        else:
                            pos = torch.searchsorted(coarse_sel, fine_sel).clamp_(
                                0, coarse_sel.shape[0] - 1)
                            valid = coarse_sel.index_select(0, pos) == fine_sel
                        if u_fine:
                            Bu_c, cu_c = Bu, colsu
                            GBv_c, cv_c = GBv.index_select(3, pos), colsv.index_select(1, pos)
                        else:
                            Bu_c, cu_c = Bu.index_select(3, pos), colsu.index_select(1, pos)
                            GBv_c, cv_c = GBv, colsv
                    if valid is not None:
                        GBv_c = GBv_c * valid.to(dtype)
                    Cku, Ckv, Dv, Nc = Bu_c.shape[1], GBv_c.shape[1], GBv_c.shape[2], \
                        GBv_c.shape[3]
                    Nb = elements[kv][0]
                    acc = torch.zeros((elements[ku][0] * Nb, Cku * Ckv), dtype=dtype, device=dev)
                    cv_l = cv_c.long()
                    for du in range(Bu_c.shape[2]):
                        T = sum(Bu_c[c, :, du, None, None, :] * GBv_c[c, None]
                                for c in range(Ce))  # [Cku, Ckv, Dv, Nc]
                        ids = cu_c[du].long()[None, :] * Nb + cv_l
                        acc.index_add_(0, ids.reshape(-1),
                                       T.permute(2, 3, 0, 1).reshape(Dv * Nc, Cku * Ckv))
                    block_view(ku, kv).sub_(
                        acc.view(elements[ku][0], Nb, Cku, Ckv).permute(0, 2, 1, 3))

        def damped(n, b, base):
            """base + the exact damping of keep image n's block diagonal b
            [Cn, Nn] (as _invert_damped_blocks) + identity rows for
            excluded elements."""
            Nn, Cn = elements[n]

            def whole(t):
                return t if sh is None else sh.whole(n, t)

            nd = base + torch.clamp(whole(state["rawdiag"][n]).reshape(Nn, Cn).T - b, min=0.0)
            if self.uses_lambda:
                nd = nd + whole(state["CtC"][n]).reshape(Nn, Cn).T
            if n in masks:
                nd = nd + (1.0 - masks[n].reshape(-1))[None, :]
            return nd

        # the keep block diagonal with its damping; under a mesh the damping
        # is added once the ranks' parts are summed
        bdiag = {}
        for n in keep:
            Nn, Cn = elements[n]
            bd = kk_diag.get(n)
            bd = torch.zeros((Cn * Cn, Nn), dtype=dtype, device=dev) if bd is None else bd.clone()
            diag_ix = torch.arange(Cn, device=dev) * (Cn + 1)
            bdiag[n] = bd[diag_ix]
            if sh is None:
                bd[diag_ix] = damped(n, bdiag[n], bdiag[n])
            torch.diagonal(block_view(n, n), dim1=0, dim2=2).add_(bd.view(Cn, Cn, Nn))
        if sh is None:
            return S
        flat = sh.all_reduce(torch.cat([S.reshape(-1)] + [bdiag[n].reshape(-1) for n in keep]))
        S, o = flat[:K * K].view(K, K), K * K
        for n in keep:
            b = flat[o:o + bdiag[n].numel()].view(bdiag[n].shape)
            o += b.numel()
            d = torch.diagonal(block_view(n, n), dim1=0, dim2=2)  # [Cn, Cn, Nn]
            torch.diagonal(d, dim1=0, dim2=1).add_(damped(n, b, 0.0).T)
        return S

    def finish_step(self, U, lm: LMState, state, delta, inputs, sp: SolverParams, prep):
        """Phase 3: X += delta (+ LM model cost, accept/revert, radius)."""
        return self._finish_step(U, lm, inputs, prep["consts"], delta, sp, state["ssq"],
                                 state["U_whole"])

    def nonlinear_step(self, U, lm: LMState, inputs, sp: SolverParams, prep,
                       phase=contextlib.nullcontext):
        """One GN / LM iteration: setup + PCG + update.  The three phases
        are named ranges in a torch.profiler trace; ``phase(name)`` wraps
        each of them too, by the timer's event name (the plan's timed
        phases at timing_level >= 2)."""
        with record_function("thallo::setup"), phase("Nonlinear Setup"):
            state = self.solve_setup(U, lm, inputs, sp, prep)
        with record_function("thallo::pcg"), phase("Linear Solve"):
            delta = self.linear_solve(U, state, inputs, sp, prep)
        with record_function("thallo::finish"), phase("Nonlinear Finish"):
            return self.finish_step(U, lm, state, delta, inputs, sp, prep)

    def guarded_step(self, U, lm: LMState, inputs, sp: SolverParams, prep):
        """One step of a multi-step dispatch (the body of thallo_tpu's
        _scan_step, thallo_tpu/plan.py:716-749): GN's plain step; under LM
        a step taken once lm.finished is set leaves U and every tensor
        field of lm as they were and returns lm.prev_cost as its cost (JAX's
        lax.cond frozen branch), by torch.where, with no host read.  n_iter
        counts the step either way: the plan corrects it by the steps that
        ran."""
        U2, lm2, stop, cost = self.nonlinear_step(U, lm, inputs, sp, prep)
        if not self.uses_lambda:
            return U2, lm2, stop, cost
        done = lm.finished

        def keep(old, new):
            return torch.where(done, old, new)

        lm2 = LMState(
            trust_region_radius=keep(lm.trust_region_radius, lm2.trust_region_radius),
            radius_decrease_factor=keep(lm.radius_decrease_factor, lm2.radius_decrease_factor),
            prev_cost=keep(lm.prev_cost, lm2.prev_cost),
            n_iter=lm2.n_iter,
            ssq=tree_where(done, lm.ssq, lm2.ssq),
            finished=done | lm2.finished,
        )
        return tree_where(done, U, U2), lm2, lm2.finished, keep(lm.prev_cost, cost)

    def uncapturable(self):
        """The part of this plan's step that a CUDA graph cannot hold (it
        reads the device from the host), named for a NotImplementedError
        at plan time, or None (steps_per_dispatch > 1 on the card): GN's
        schur_dense when its kept system (the unknowns but those named in
        schur_eliminate, or but the largest image) exceeds
        SYEV_CAPTURE_MAX rows."""
        if not (self.schur_dense and not self.uses_lambda):
            return None
        elements = {im.name: int(np.prod([d.size for d in im.dims])) for im in self.spec.unknowns}
        elim = self.schur_eliminate or [max(elements, key=elements.get)]
        K = sum(elements[im.name] * im.channels for im in self.spec.unknowns
                if im.name not in elim)
        if K <= linalg.SYEV_CAPTURE_MAX:
            return None
        return (f"linear_solver='schur_dense' under Gauss-Newton with a kept system of {K} "
                f"rows: cuSOLVER's eigensolvers read the host above "
                f"{linalg.SYEV_CAPTURE_MAX} rows (ops/linalg.py)")

    def kernel_probe_fns(self):
        """Probes of the solver-facing kernels for the per-kernel timing
        table (thallo_tpu/solver/gn.py:275-330; Plan.kernel_stats, timing
        level 3), by the reference's kernel names: each logical kernel
        alone, on the state of one setup.  PCGStep1, PCGStep2 and PCGStep3
        apply the preconditioner the PCG applies (block-Jacobi where the
        plan has one)."""
        def compute_cost(U, inputs, prep):
            return self.cost(U, inputs, prep["consts"])

        def pcg_step1(U, state, inputs, sp, prep):
            # JᵀJ p + damping + the alpha denominator (PCGStep1)
            apply_jtjp = self.make_jtjp(U, inputs, prep["consts"], state["masks"],
                                        state["jac_store"], prep["twin_consts"])
            p0 = self.precond_apply(state, state["r0"])
            Ap = apply_jtjp(p0)
            if self.uses_lambda:
                Ap = tree_add(Ap, tree_mul(state["CtC"], p0))
            return Ap, tree_dot(p0, Ap)

        def pcg_step2(state):
            # x/r/z updates + the beta numerator (PCGStep2)
            r0 = state["r0"]
            delta = tree_scale(r0, 0.5)
            r = tree_axpy(-0.5, r0, r0)
            z = self.precond_apply(state, r)
            return delta, r, z, tree_dot(z, r)

        def pcg_step3(state):
            # p = z + beta p (PCGStep3)
            z = self.precond_apply(state, state["r0"])
            return tree_axpy(0.25, state["r0"], z)

        def linear_update(U, state):
            # X += delta (PCGLinearUpdate)
            return tree_axpy(1.0, state["r0"], U)

        return {
            "computeCost": compute_cost,
            "PCGInit1": self.solve_setup,
            "PCGStep1": pcg_step1,
            "PCGStep2": pcg_step2,
            "PCGStep3": pcg_step3,
            "PCGLinearUpdate": linear_update,
        }

    def _finish_step(self, U, lm, inputs, consts, delta, sp, ssq, U_whole=None):
        newU = tree_add(U, delta)
        if not self.uses_lambda:
            nan = torch.full((), float("nan"), dtype=self.dtype, device=self.device)
            return newU, lm._replace(n_iter=lm.n_iter + 1), torch.zeros_like(lm.finished), nan
        sh = self.shard_ctx
        if sh is None:
            model_cost = self.model_cost(U, inputs, consts, delta)
            new_cost = self.cost(newU, inputs, consts)
        else:  # both costs' parts summed by one all_reduce
            Uw = sh.gather_tree(U) if U_whole is None else U_whole
            dw = sh.gather_tree(delta)
            model_cost, new_cost = sh.allsum(
                self._model_cost_part(Uw, inputs, consts, dw),
                self._cost_part(tree_add(Uw, dw), inputs, consts))
        model_cost_change = lm.prev_cost - model_cost
        cost_change = lm.prev_cost - new_cost
        relative_decrease = cost_change / model_cost_change
        accept = (cost_change >= 0) & (relative_decrease > sp.min_relative_decrease)

        # Ceres-style radius update
        tmp_factor = 1.0 - (2.0 * relative_decrease - 1.0) ** 3
        radius_accept = torch.clamp(
            lm.trust_region_radius / torch.clamp(tmp_factor, min=1.0 / 3.0),
            max=sp.max_trust_region_radius)
        radius_reject = lm.trust_region_radius / lm.radius_decrease_factor
        new_radius = torch.where(accept, radius_accept, radius_reject)
        new_decrease = torch.where(accept, torch.full_like(lm.radius_decrease_factor, 2.0),
                                   2.0 * lm.radius_decrease_factor)
        outU = tree_where(accept, newU, U)
        new_prev_cost = torch.where(accept, new_cost, lm.prev_cost)

        func_tol = accept & (cost_change <= lm.prev_cost * sp.function_tolerance)
        radius_too_small = (~accept) & (new_radius < sp.min_trust_region_radius)
        stop = func_tol | radius_too_small
        new_lm = LMState(
            trust_region_radius=new_radius,
            radius_decrease_factor=new_decrease,
            prev_cost=new_prev_cost,
            n_iter=lm.n_iter + 1,
            ssq=ssq if lm.n_iter == 0 else lm.ssq,
            finished=stop,
        )
        return outU, new_lm, stop, new_cost
