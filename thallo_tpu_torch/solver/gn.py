"""Gauss-Newton / Levenberg-Marquardt outer loop with a preconditioned-
conjugate-gradient inner loop (counterpart of ``thallo_tpu/solver/gn.py``,
graph groups).

Each group runs one of two schedules of JᵀJ·p:

* materialized JᵀJ (PRECOMPUTE_JTJ, the default for graph groups above
  the dense threshold): block-sparse tables and blocks from the setup
  (solver/blocksparse.py), block-Jacobi preconditioner;
* materialized J (PRECOMPUTE_J, from ``r.<name>.J.set_materialize(True)``,
  and APPLY_SEPARATELY, from ``r.<name>.Jp.set_materialize(True)``): the
  per-point Jacobians are stored at setup, JᵀF and diag(JᵀJ) (partial²
  per access, as thallo_tpu) are scattered from them, and every PCG
  iteration gathers p, forms J·p and scatters Jᵀ(J·p) (lower.py's
  ``scatter_slot``).  Eager torch materializes J·p between the two passes
  in both schedules, so APPLY_SEPARATELY's split (JAX's optimization
  barrier) is what PRECOMPUTE_J runs too.  No diag-pair blocks exist, so
  the preconditioner stays scalar Jacobi, as in thallo_tpu.

Numerics follow the JAX solver step for step: -JᵀF and diag(JᵀJ),
Ceres-style LM damping with Jacobi scaling,
block-Jacobi inverses with unit-diagonal equilibration, PCG with the
residual reset and the Q/zeta early stop, and the trust-region
accept/revert.  The PCG loop runs ``lIterations`` iterations with no
host read: once the device-side ``stop`` flag is set, delta/r/p freeze
through ``torch.where`` (JAX exits its ``while_loop`` instead; the
results are the same).  Routing is f32 everywhere, so the zeta test
needs no noise floor.

Not ported yet (NotImplementedError at plan time): the dense JᵀJ path
(<= 4096 unknowns), direct/Schur solves, the INLINE and LINEARIZE
schedules, Exclude masks, bf16 block storage and double precision.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..lower import LoweredGroup
from ..spec import JTJpSchedule
from .blocksparse import bsr_apply, bsr_setup

DENSE_JTJ_MAX_UNKNOWNS = 4096  # thallo_tpu/schedule.py: smaller problems go dense
# schedules that store the per-point Jacobians and apply JᵀJ·p from them
MATERIALIZED_J = (JTJpSchedule.PRECOMPUTE_J, JTJpSchedule.APPLY_SEPARATELY)


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


# ---------------------------------------------------------------------------
# the compiled solver
# ---------------------------------------------------------------------------
class CompiledSolver:
    """Lowered groups + the step for one problem at fixed dim sizes.

    Methods keep thallo_tpu's names and signatures (the masks/twin_consts
    arguments included, unused here), so a parity test calls the same
    function on both packages."""

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
        self.precond_kind = options.get("preconditioner", "auto")
        if self.precond_kind not in ("auto", "block_jacobi", "jacobi"):
            raise ValueError("preconditioner must be 'auto', 'block_jacobi' or 'jacobi'")
        excluded = [im.name for im in spec.unknowns if im.exclude_expr is not None]
        if excluded:
            raise NotImplementedError(f"Exclude masks on {excluded} are not ported yet")
        for gp in groups:
            if not gp.group.supports_cm:
                raise NotImplementedError(
                    f"group {gp.name!r} has stencil (grid-offset) accesses; the "
                    "matrix-free grid path is not ported yet")
            if not self._wants_bsr(gp) and gp.schedule not in MATERIALIZED_J:
                _, total = self.unknown_layout()
                why = (f"schedule {gp.schedule.value}"
                       if gp.schedule is not JTJpSchedule.PRECOMPUTE_JTJ
                       else f"{total} unknowns <= {DENSE_JTJ_MAX_UNKNOWNS} (dense JᵀJ)")
                raise NotImplementedError(
                    f"group {gp.name!r}: {why} is not ported yet; only the "
                    "block-sparse materialized JᵀJ and the materialized-J "
                    "schedules (PRECOMPUTE_J, APPLY_SEPARATELY) are")

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

    def _wants_bsr(self, gp):
        """Whether this group materializes JᵀJ as block-sparse tables
        (graph groups above the dense threshold)."""
        if gp.schedule not in (JTJpSchedule.PRECOMPUTE_JTJ,
                               JTJpSchedule.PRECOMPUTE_J_THEN_JTJ):
            return False
        if gp.force_sparse:
            return True
        return self.unknown_layout()[1] > DENSE_JTJ_MAX_UNKNOWNS

    def prepare(self, inputs):
        """Input-only precomputation, once per init: slot index tables,
        const-slot values, and per group the block-sparse tables or the
        scatter routes of the materialized-J schedules."""
        return {
            "consts": [gp.group.prepared_consts(inputs, self.device,
                                                want_bsr=self._wants_bsr(gp))
                       for gp in self.groups],
            "twin_consts": [None] * len(self.groups),
        }

    # -- residuals / cost ---------------------------------------------------
    def cost(self, U, inputs, consts):
        """0.5 * sum of squared residuals."""
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for gp, c in zip(self.groups, consts):
            r = gp.group.residuals_cm(U, inputs, c)
            total = total + torch.sum(r * r)
        return 0.5 * total

    def _zeros_like_unknowns(self):
        return {im.name: torch.zeros(tuple(d.size for d in im.dims) + (im.channels,),
                                     dtype=self.dtype, device=self.device)
                for im in self.spec.unknowns}

    def jtf_and_diag(self, U, inputs, consts, masks, jac_store, twin_consts=None):
        """Returns (minus_jtf, diag, jac_store).  Block-sparse groups store
        their assembled blocks under jac_store[str(gi)]["bsr"]; the
        materialized-J groups store the per-point Jacobians under
        jac_store[str(gi)]["jacs"] and scatter Jᵀr and diag = partial² per access (thallo_tpu's
        semantics: two accesses of one residual aliasing one element add
        a² + b², not (a+b)²)."""
        mjtf = self._zeros_like_unknowns()
        diag = self._zeros_like_unknowns()
        for gi, (gp, c) in enumerate(zip(self.groups, consts)):
            g = gp.group
            r, jacs = g.point_jacobians_cm(U, inputs, c)
            if c["bsr"] is not None:
                jtr_d, d2_d, blocks = bsr_setup(c["bsr"], r, jacs)
                jac_store[str(gi)] = {"bsr": blocks}
                for name, v in jtr_d.items():
                    mjtf[name] = mjtf[name] - v
                for name, v in d2_d.items():
                    diag[name] = diag[name] + v
                continue
            jac_store[str(gi)] = {"jacs": tuple(jacs)}
            for i, slot in enumerate(g.uslots):
                J = jacs[i]  # [rc, C, R]
                C = J.shape[1]
                # Jᵀr and partial² stacked, so one scatter carries both
                parts = torch.cat([(J * r[:, None]).sum(0), (J * J).sum(0)])
                both = g.scatter_slot(i, parts, c)  # [*dims, 2C]
                name = slot.image.name
                mjtf[name] = mjtf[name] - both[..., :C]
                diag[name] = diag[name] + both[..., C:]
        return mjtf, diag, jac_store

    def make_jtjp(self, U, inputs, consts, masks, jac_store, twin_consts=None):
        """Ap(p) = sum_g J_gᵀ J_g p: from the blocks assembled this step
        (block-sparse groups) or the stored per-point Jacobians
        (materialized-J groups: gather p, J·p, scatter Jᵀ(J·p))."""
        pairs, jac_groups = [], []
        for gi, gp in enumerate(self.groups):
            entry = jac_store[str(gi)]
            if "bsr" in entry:
                pairs.append((consts[gi]["bsr"], entry["bsr"]))
            else:
                jac_groups.append((gp.group, consts[gi], entry["jacs"]))

        def apply_jtjp(p):
            Ap = tree_zeros_like(p)
            for bsr, blocks in pairs:
                for name, v in bsr_apply(bsr, blocks, p).items():
                    Ap[name] = Ap[name] + v
            for g, c, jacs in jac_groups:
                Jp = None  # [rc, R]: sum over slots of J_slot · p_slot
                for i in range(len(g.uslots)):
                    term = (jacs[i] * g.gather_slot(i, p, c)[None]).sum(1)
                    Jp = term if Jp is None else Jp + term
                for i, slot in enumerate(g.uslots):
                    contrib = (jacs[i] * Jp[:, None]).sum(0)  # [C, R]
                    name = slot.image.name
                    Ap[name] = Ap[name] + g.scatter_slot(i, contrib, c)
            return Ap

        return apply_jtjp

    def model_cost(self, U, inputs, consts, delta):
        """0.5 |r + J delta|^2 through a forward-mode JVP."""
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for gp, c in zip(self.groups, consts):
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
        jac_store = {}
        mjtf, rawdiag, jac_store = self.jtf_and_diag(U, inputs, consts, None, jac_store)
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
            "masks": None,
            "jac_store": jac_store,
            "r0": mjtf,
            "pre": pre,
            "pre_block": pre_block,
            "CtC": CtC,
            "ssq": ssq,
            "rawdiag": rawdiag,
        }

    # -- block-Jacobi preconditioner -----------------------------------------
    def _block_preconditioner(self, consts, jac_store, rawdiag, CtC, lm):
        """Per-unknown-element CxC inverses of the damped JᵀJ block
        diagonal (from the setup's diag-pair blocks).  Images no
        block-sparse group touches get none: they stay scalar Jacobi."""
        B = self._diag_pair_blocks(consts, jac_store)
        return self._invert_damped_blocks(B, rawdiag, CtC)

    def _diag_pair_blocks(self, consts, jac_store):
        """The block diagonal of the groups' JᵀJ per unknown image,
        channel-major [C*C, N]."""
        B = {}
        for gi in range(len(self.groups)):
            bsr = consts[gi]["bsr"]
            if bsr is None:
                continue
            blocks = jac_store[str(gi)]["bsr"]
            for p_idx, pr in enumerate(bsr.pairs):
                if pr[2] != "diag":
                    continue
                name = bsr.slot_images[pr[0]]
                if bsr.slot_images[pr[1]] != name:
                    continue  # cross-image aliasing: off the block diagonal
                B[name] = B[name] + blocks[p_idx] if name in B else blocks[p_idx]
        return B

    def _invert_damped_blocks(self, B, rawdiag, CtC):
        """Invert per-element CxC blocks after damping their diagonals (LM
        adds diag(CtC); GN applies the CERES guarded transform)."""
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
            else:
                new_diag = torch.square(1.0 + torch.sqrt(torch.clamp(bdiag + extra, min=0.0)))
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
        """Phase 2: PCG, lIterations iterations, frozen once `stop` is set."""
        consts = prep["consts"]
        r0, CtC = state["r0"], state["CtC"]
        b = r0
        p = self.precond_apply(state, r0)
        r = r0
        alpha_num = tree_dot(r0, p)
        delta = tree_zeros_like(r0)
        Q0 = torch.zeros((), dtype=self.dtype, device=self.device)
        stop = torch.zeros((), dtype=torch.bool, device=self.device)
        apply_jtjp = self.make_jtjp(U, inputs, consts, state["masks"], state["jac_store"])

        def damped(pvec):
            Ap = apply_jtjp(pvec)
            if self.uses_lambda:
                Ap = tree_add(Ap, tree_mul(CtC, pvec))
            return Ap

        def safe_div(num, den):
            if self.uses_lambda:
                return num / den
            ok = den != 0.0
            return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                               torch.zeros_like(num))

        for i in range(sp.lIterations):
            Ap = damped(p)
            alpha = safe_div(alpha_num, tree_dot(p, Ap))
            delta_n = tree_axpy(alpha, p, delta)
            if self.uses_lambda and (i + 1) % sp.residual_reset_period == 0:
                r_n = tree_sub(b, damped(delta_n))  # residual reset: r = b - A delta
            else:
                r_n = tree_axpy(-alpha, Ap, r)
            z = self.precond_apply(state, r_n)
            beta_num = tree_dot(z, r_n)
            if self.uses_lambda:
                Q1 = 0.5 * tree_dot(delta_n, tree_add(r_n, b))
                zeta = (i + 1) * (Q1 - Q0) / Q1
                stop_q = ~torch.isfinite(Q1) | ~torch.isfinite(zeta)
                if sp.q_tolerance >= 0:
                    stop_q = stop_q | (zeta < sp.q_tolerance)
            else:
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

    def finish_step(self, U, lm: LMState, state, delta, inputs, sp: SolverParams, prep):
        """Phase 3: X += delta (+ LM model cost, accept/revert, radius)."""
        return self._finish_step(U, lm, inputs, prep["consts"], delta, sp, state["ssq"])

    def nonlinear_step(self, U, lm: LMState, inputs, sp: SolverParams, prep):
        """One GN / LM iteration: setup + PCG + update.  The three phases
        are named ranges in a torch.profiler trace."""
        with record_function("thallo::setup"):
            state = self.solve_setup(U, lm, inputs, sp, prep)
        with record_function("thallo::pcg"):
            delta = self.linear_solve(U, state, inputs, sp, prep)
        with record_function("thallo::finish"):
            return self.finish_step(U, lm, state, delta, inputs, sp, prep)

    def _finish_step(self, U, lm, inputs, consts, delta, sp, ssq):
        newU = tree_add(U, delta)
        if not self.uses_lambda:
            nan = torch.full((), float("nan"), dtype=self.dtype, device=self.device)
            return newU, lm._replace(n_iter=lm.n_iter + 1), torch.zeros_like(lm.finished), nan
        model_cost = self.model_cost(U, inputs, consts, delta)
        model_cost_change = lm.prev_cost - model_cost
        new_cost = self.cost(newU, inputs, consts)
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
