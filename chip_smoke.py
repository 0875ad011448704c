"""End-to-end smoke run of thallo_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Two 1M-observation BA scenes are generated once, on the host, from a
seed, and each solve gets its own copy: the uniform one (1024 cameras,
250 000 points, 4 observations per point) and the degree-skewed one
(``skewed_inputs(1024, 250000, target_obs=1_000_000)``: 953 157 shuffled
observations, power-law point and camera degrees).  Phases (each prints
its seconds; any failure exits non-zero):
  1. build the CUDA kernels from thallo_tpu_torch/csrc (one nvcc per
     source, in parallel) and print nvcc's register/spill report;
  2. each kernel against its plain torch version on the card, at the
     shapes its path gives it (the uniform scene's, the segment sum with
     plans built from its oToP and oToC; the fused pair at each level of
     the skewed scene's sorted tables by every kernel, the solver taking
     the one fused_pair_route names; oh_setup_products and its first
     body at the uniform and the skewed camera ids; fullrepeat_setup and
     its first body (fullrepeat_setup_thread) at the uniform point level,
     a ragged one and W = 9; oh_setup_aggregate and its first body
     (oh_setup_aggregate_atomics) at the uniform and the skewed camera
     ids; the measurement scripts' kernels at the JAX scripts' BA-1M
     shape; fused_pair_apply_atomics at ARAP 256²'s (3, 3) levels, the
     record's shape; every kernel phases 15 and 17 launch on a
     block-sparse plan, at the shapes, recipes and tables of one step of
     that plan on the card: model_kernel_cases) and at a small ragged
     shape with out-of-range ids or padded plan lanes; kernel, plain and
     library times in ms, each kernel and library call twice: `ms` over
     20 eager calls (host and device) and `device_ms` over the same call
     captured 10 times in one CUDA graph and replayed (the device alone; everything under 50 MB is
     warm in L2 there, as the solver's caller finds pcol and the plans,
     while the 108 MB of blocks stay cold).  At every fused-pair shape
     (uniform W = 4, the skewed levels) the pair is timed five ways: the
     persistent kernel (fused_pair_apply), the kept global-atomics body
     (fused_pair_apply_atomics), the persistent W-loop kernel
     (fused_pair_apply_wloop), the first W-loop body
     (fused_pair_apply_wloop_chunked), and the persistent kernel without
     its cols side (the rows-only floor); on the same values as bf16
     blocks (block_dtype="bf16") six ways: the bf16 persistent kernel
     (fused_pair_apply_bf16), the bf16 W-loop kernel
     (fused_pair_apply_wloop_bf16), the first bf16 body
     (fused_pair_bf16_atomics), the bf16 rows-only floor and the cluster
     kernel of the variants v2 and v3 (fused_pair_v2_smem,
     fused_pair_v3_partials; at the skewed levels their hot camera).  The
     loop-floor kernel is held against torch.add.  The segment sum is also held
     against index_add_ on the
     skewed scene's camera map (one segment with half the rows), on a
     ragged map with empty segments, and on row-major data;
  3. the small BA scene solved with LM on the card and on the CPU (the
     plain versions): per-step unknowns and costs agree; then the small
     skewed scene (``skewed_inputs(16, 1400, 5600)``: point levels
     W = 8, 24, 273), under scalar and block Jacobi: each level launches
     the kernel fused_pair_route names for it; then the grid path:
     image_warping 64 x 64 with an excluded 16 x 16 square, 3 LM steps
     through run_steps on the card and on the CPU: unknowns and costs
     agree, the excluded unknowns never move (bit for bit);
  4. the 1M LM solve, block-sparse materialized JᵀJ: its three kernels
     launched, costs finite, final cost <= 1e-2 x initial;
  5. the 1M LM solve under PRECOMPUTE_J (``J.set_materialize(True)``),
     scalar Jacobi: cameras scatter through the aggregation kernel
     (launched), points through index_add_; costs finite and never
     rising; its first 3 steps agree with the block-sparse solve run with
     preconditioner="jacobi" (the same JᵀJ·p and preconditioner);
  6. the 1M LM solve under APPLY_SEPARATELY (``Jp.set_materialize(True)``)
     with THALLO_SEGSUM=tiled: both scatters through the segment-sum
     kernel (launched); costs finite and never rising; its first 3 steps
     agree with phase 5's;
  7. the skewed 1M LM solve, block-sparse JᵀJ over level tables after
     the residual sort: each level launches the fused-pair kernel
     fused_pair_route names for it, and oh_setup_products launched, costs
     never rising, final cost <= 1e-2 x initial; launches per level shape
     (W, N_t), each read from the wrapper's own count around its calls;
  8. the measurement scripts (scripts/torch_fused_pair_micro.py,
     torch_fused_variants.py, torch_loop_floor.py, torch_redesign_sweep.py)
     run through their main() with few launches per timing: the bf16 fused
     pair, its three variants (v2 and v3 by the cluster kernel), the
     loop-floor kernel (one tile and 64 tiles), the global-atomics fused
     pair and the six first bodies the redesigns replaced (the chunked
     W-loop kernel, the global-atomics oh_setup_products,
     fullrepeat_setup_thread, oh_setup_aggregate_atomics, and the first
     bodies of v2 and v3) launched;
  9. the 1M LM solve, block-sparse JᵀJ under block_dtype="bf16": the bf16
     persistent kernel (fused_pair_apply_bf16), oh_setup_products and
     fullrepeat_setup launched, no f32 or atomics fused pair; costs never
     rising, final cost <= 1e-2 x initial, logged beside phase 4's;
 10. the skewed 1M scene under block_dtype="bf16" for BF16_SKEW_STEPS LM
     steps: each level launches the bf16 instantiation of the kernel
     fused_pair_route names for it (the W-loop one at every wide level);
     costs never rising;
 11. image_warping at 512 x 512 (JAX's bench.py configuration), GN, 16
     PCG iterations, LINEARIZE over stencil rolls (no
     hand-written kernel: the JAX package runs no Pallas kernel there
     either): plan.warmup(), run_steps(1) three times, run_steps(7),
     plan.final_cost; every unknown finite, the costs after steps 1-3
     and 10 within GRID_TRAJ_RTOL of the JAX package's f32 trajectory
     (GRID_JAX_COSTS; f32 rounding alone moves it by percents); after
     step 3, the cost, -JᵀF, diag(JᵀJ) and JᵀJ·p on the card against
     the port's CPU path at the same unknowns (GRID_LINEAR_RTOL); logs
     the step median of steps 2-10 and the device kernels per step and
     per PCG iteration;
 12. the Schur-complement solves on small scenes, card vs CPU, 5 LM
     steps: linear_solver="schur_pcg" and "schur_dense" on test_schur's
     8-camera scene (``synthetic_inputs(8, 64, 4, seed=3)``) and on the
     small skewed scene, step 1 within phase 3's bounds (the skewed
     block-Jacobi ones there), steps 1-5 within SCHUR_TRAJ, costs never
     rising, a fused-pair kernel launched; schur_dense's first step
     against linear_solver="direct" on the card within EXACT_TOL;
 13. the uniform 1M LM solve under schur_pcg (SCHUR_L_ITERATIONS PCG
     iterations on the reduced camera system, 10 steps):
     fused_pair_apply, oh_setup_products and fullrepeat_setup launched,
     costs never rising, final cost <= 1e-2 x initial; then schur_dense
     (the 9216-DOF camera system assembled and solved by LU,
     schur_dense_max=16384) for SCHUR_DENSE_STEPS steps, costs never
     rising, the assembly and the solve timed apart;
 14. the skewed 1M LM solve under schur_pcg, 10 steps: fused_pair_apply,
     fused_pair_apply_wloop and oh_setup_products launched, costs never
     rising; then, printed and not gated, the time to target cost on
     the uniform 1M scene by bench.py's rule (bench_ba_time_to_target:
     q_tolerance and function_tolerance 0, target c0 - 0.95 (c0 - the
     cost after 25 steps), a cold restart, one warm step, a cold
     restart, then steps until the cost reaches the target) for pcg and
     schur_pcg at lIterations 4 and 16 and schur_dense, and in the same
     timed runs the time to TTT_COMMON x the initial cost;
 15. the eleven copied models (thallo_tpu_torch/models/cases.py's
     CASES; the five graph models above the 4096-unknown dense threshold,
     on block-sparse tables, the rest at tests/test_models*.py's sizes),
     then image_warping 72² and 16² with JᵀJ materialized (a pure-stencil
     group without tables: its stored point Jacobians, the dense JᵀJ), on
     the card and on the CPU, MODEL_STEPS steps with the Q-ratio stop off:
     unknowns and costs agree at phase 3's bounds (MODEL_TOL where
     measured wider), each block-sparse plan's routed kernels launched,
     sparse_bundle_fusion's kernels logged;
 16. ARAP at side 256 (bench.py:306-330), GN, lIterations 10, in the
     generator's direction-grouped edge order and shuffled: warmup(),
     run_steps(1) three times, run_steps(7); costs after steps 1-3 and 10
     within ARAP_TRAJ_RTOL of the JAX package's f32 trajectory
     (ARAP_JAX_COSTS) and of the other order's; after step 3 the linear
     parts card vs CPU (GRID_LINEAR_RTOL); fused_pair_apply_atomics
     launched (the reg group's two (3, 3) col pairs) and no other fused
     pair; logs the step median, its launches per step and per PCG
     iteration, and the marginal cost of a PCG iteration (lIterations 10
     against 110);
 17. the io readers: examples/data/sample_scene.bal.txt (io/bal.py) as
     bundle adjustment and sample_mesh.ply (io/ply.py) as ARAP, card vs
     CPU as in phase 15.
Each solve's and phase 8's kernel counts are set to 0 just before it and
read just after.

Needs CUDA: exits 1 without printing a result when none is available.
The last lines are the kernels' JSON record (each kernel's launches on
the run named beside it, and on each run of phases 15-17 that launched
it), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""
import collections
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# phase 2: f32 on both sides; only the order of (atomic) sums differs
KERNEL_TOL = 1e-5
# ... except on the skewed scene, whose hot camera sums up to ~1e6 terms
# into one output: an f32 sum of n terms in another order moves by about
# 2^-24 sqrt(n/3) x the sum of their magnitudes (measured: 19 on the
# hot camera's d2, 478k positive terms, far beyond KERNEL_TOL x max|ref|).
# There each output is held to KERNEL_SUM_TOL sqrt(n) x the sum of its
# terms' magnitudes (n and that sum from the plain version on ones and on
# |inputs|): 4 x 2^-24, about 10x above that measured error.
KERNEL_SUM_TOL = 4 * 2.0 ** -24
# phase 3: the unknowns after each LM step agree to f32 trajectory noise;
# near convergence this scene's cost moves ~2e-3 relative under such
# changes of the unknowns (measured CPU-port vs CPU-JAX), hence the cost
# tolerance.  Phases 5 and 6 hold their first 3 steps to the same bounds:
# the two solves compared apply the same JᵀJ·p and preconditioner and
# differ only in f32 summation order (atomics, assembly order).
STEP_U_TOL = 1e-4
STEP_COST_RTOL = 1e-2
# The skewed small scene under block-Jacobi: its ill-conditioned 3x3
# point blocks (points seen by 2 near-parallel cameras) carry f32 summation
# noise into each step far more.  scripts/torch_skew_small_spread.py,
# card vs CPU on an H100 over seeds 0-7 x 3 card runs, 5 steps each: at
# most 4.1e-4 of max|U| and 2.4e-2 of the cost (seed 7, step 3, near
# convergence at 2e-7 of the initial cost; this scene, seed 0: at most
# 1.6e-2); under scalar Jacobi 3.5e-6 and 3.7e-4, so the phase-3 bounds
# hold there.
SKEW_BLOCK_U_TOL = 2e-3
SKEW_BLOCK_COST_RTOL = 3e-2
CROSS_STEPS = 3
BA_1M = (1024, 250_000, 4)
SKEW_1M = (1024, 250_000, 1_000_000)  # cameras, points, target observations
SKEW_SMALL = (16, 1400, 5600)
N_STEPS_1M = 10
BF16_SKEW_STEPS = 3  # phase 10: enough to launch every level's kernel
# phases 12-14: the Schur-complement solves.  Phase 12's scene is
# tests/test_schur.py's test_schur_dense_matches_direct_on_ba scene;
# EXACT_TOL is that test's bound on schur_dense's first step against the
# direct solve (both exact solvers, x max|U|).
SCHUR_SMALL = (8, 64, 4, 3)  # cameras, points, observations per point, seed
SCHUR_SMALL_STEPS = 5
EXACT_TOL = 5e-5
# Step 1, card vs CPU, is held to phase 3's bounds (STEP_U_TOL /
# STEP_COST_RTOL; SKEW_BLOCK_* on the skewed scene).  The later steps of
# an exact (or nearly exact) reduced solve near convergence drift further
# along BA's flat directions, and an accept on one device against a
# reject on the other splits the LM trajectories.
# scripts/torch_skew_small_spread.py --scene schur_small|skewed
# --linear-solver schur_pcg|schur_dense, 3 card runs against the CPU on an
# H100: on this uniform scene (seed 3) at most 6.7e-5 of max|U| and 4.9e-3
# of the cost over 5 steps; on the skewed scene (seed 0) 2.4e-3 and
# 2.0e-2 (other seeds of the skewed scene, under schur_dense, up to 4.5e-2
# and costs 99x apart: seed 4 stalls on rejected steps in every run).
# SCHUR_TRAJ holds steps 1-5 at about twice those.
SCHUR_TRAJ = {"small": (2e-4, 1e-2), "small skewed": (5e-3, 5e-2)}  # (x max|U|, cost)
SCHUR_L_ITERATIONS = 16  # bench.py's lIterations for BA 1M
SCHUR_DENSE_STEPS = 3
SCHUR_DENSE_MAX = 16384  # bench.py:467-468: the 1M camera system has 9216 DOF
# time to target (bench.py:94-137): (linear_solver, lIterations)
TTT_VARIANTS = (("pcg", 4), ("pcg", 16), ("schur_pcg", 4), ("schur_pcg", 16),
                ("schur_dense", 1))
TTT_STEPS = 25
# bench.py's target (95% of the variant's own 25-step decrease) falls
# inside the first LM step of every variant on the uniform 1M scene, so
# each timed run also reports a target common to all variants
TTT_COMMON = 1e-6  # x initial cost
# phase 3, the grid path on a small scene: image_warping 64 x 64 with an
# excluded 16 x 16 square, LM, card against the port's CPU path, held to
# STEP_U_TOL-style bounds (GRID_U_TOL x max|U| per image, costs
# GRID_COST_TOL); the port's own CPU steps move by at most 8.5e-5 of
# max|Angle| when its unknowns are moved by 1e-7 x max|U| (three seeds:
# scripts/torch_grid_trajectory.py --package torch --device cpu --size 64
# --mask 24:40 --steps 3 --solver levenberg_marquardt --perturb SEED),
# inside GRID_U_TOL
GRID_SMALL = 64
GRID_MASK = (slice(24, 40), slice(24, 40))
GRID_SMALL_STEPS = 3
GRID_U_TOL = 1e-4
GRID_COST_TOL = 1e-3
# phase 11: image_warping at 512 x 512, GN, lIterations 16, 10 steps (JAX's
# bench.py configuration, synthetic_inputs(512, 512, w_fit=100.0,
# w_reg=0.01)), against the JAX package's f32 trajectory on a CPU, costs
# after steps 0-10 (GRID_JAX_COSTS; GRID_JAX_F64_COSTS: the same in f64,
# logged beside it):
#   JAX_PLATFORMS=cpu python3 scripts/torch_grid_trajectory.py --package jax [--double]
# f32 rounding moves this trajectory a lot: JAX's own f32 run lies 1.9e-2,
# 8.4e-3, 2.5e-2 and 4.4e-3 from its f64 run after steps 1, 2, 3 and 10.
# Ten f32 runs of the port's CPU path (1-8 threads, unknowns moved by
# 1e-7 x max|U|; --package torch --device cpu [--perturb SEED]) lie at most
# 4.3e-3, 1.04e-2, 1.87e-2 and 1.14e-2 from JAX's f32 run there, and up to
# 2.8e-2 at steps 4-9.  GRID_TRAJ_RTOL is about twice those (step 10:
# twice the worst of steps 4-10), so it catches a wrong step, not
# rounding; GRID_LINEAR_RTOL holds what rounding does not move (the cost,
# -JᵀF, diag(JᵀJ) and JᵀJ·p at the same unknowns, card vs the port's CPU
# path, max|diff| / max|ref|), and the initial cost against JAX's.
GRID_SIZE = 512
GRID_L_ITERATIONS = 16
GRID_STEPS = 10
GRID_JAX_COSTS = (2966286.0, 1107.7957763671875, 909.3623657226562, 866.0934448242188,
                  827.853271484375, 817.5474243164062, 800.853759765625, 793.07470703125,
                  765.5115356445312, 770.9002685546875, 758.538818359375)
GRID_JAX_F64_COSTS = (2966286.093314577, 1086.7743789304482, 901.8160334220377,
                      844.6820533678567, 810.9208239041382, 800.145728766788, 784.374971477801,
                      775.5058966841228, 756.201589398889, 751.8364308316061, 755.228738909175)
GRID_TRAJ_RTOL = {1: 1e-2, 2: 2e-2, 3: 4e-2, GRID_STEPS: 6e-2}
GRID_LINEAR_RTOL = 1e-5
# phase 15: the eleven copied models (thallo_tpu_torch/models/cases.py's
# CASES: the graph models above the 4096-unknown dense threshold, the rest
# at tests/test_models*.py's sizes) and image_warping's two table-less
# materialized-JᵀJ cases (72² above the dense threshold, 16² below it),
# MODEL_STEPS steps with the Q-ratio stop off, card vs the port's CPU path
# at phase 3's bounds; below MODEL_COST_FLOOR x the initial cost a cost is
# f32 noise (procrustes reaches ~1e-13 from 38.5)
MODEL_STEPS = 3
MODEL_COST_FLOOR = 1e-10
# shape_and_shading's nine lighting coefficients (one element broadcast
# over the depth image) move 7.1e-4 of max|ell| card vs CPU on an H100
# (5.7e-4 between the JAX package's and the port's CPU runs,
# tests/test_torch_models.py) while the costs agree to 4e-6; every other
# model stays within 2.0e-5 of max|U| (ARAP 48²).  (x max|U|, cost) bounds
# of the models that need their own, about twice the measured spread:
MODEL_TOL = {"shape_and_shading": (2e-3, STEP_COST_RTOL)}
TABLELESS_IW = ((72, "set_materialize"), (16, "set_sparse"))
# phase 16: ARAP at side 256 (bench.py:306-330: 65 536 vertices, 261 120
# directed edges, 393 216 unknowns), GN, lIterations 10, in the generator's
# direction-grouped edge order and in shuffle_edges(seed=0)'s; the JAX
# package's f32 trajectories on a CPU, costs after steps 0-10:
#   JAX_PLATFORMS=cpu python3 scripts/torch_model_trajectory.py --package jax [--shuffle]
# Eight f32 runs of the port's CPU path with the unknowns moved by 1e-7 x
# max|U| (--package torch --device cpu --perturb 1..4 [--shuffle]) lie at
# most 3.9e-6, 6.6e-6, 8.1e-6 and 7.4e-3 from JAX's run after steps 1, 2,
# 3 and 10 (GN on this mesh is not monotone: f32 rounding grows over the
# steps); ARAP_TRAJ_RTOL is about twice those.  The two edge orders are
# held to each other at the same bounds.
ARAP_SIDE = 256
ARAP_L_ITERATIONS = 10
ARAP_STEPS = 10
ARAP_JAX_COSTS = {
    "grouped": (120.0, 22.74494743347168, 33.3541374206543, 30.199676513671875,
                17.662031173706055, 11.359360694885254, 11.627789497375488, 10.826089859008789,
                9.262274742126465, 12.03388786315918, 9.044187545776367),
    "shuffled": (120.0, 22.744949340820312, 33.354129791259766, 30.199623107910156,
                 17.662052154541016, 11.359400749206543, 11.62772274017334, 10.826399803161621,
                 9.262551307678223, 12.02984619140625, 9.037223815917969)}
ARAP_TRAJ_RTOL = {1: 1e-5, 2: 2e-5, 3: 2e-5, ARAP_STEPS: 2e-2}
# the marginal cost of one PCG iteration (bench.py:306-330's metric): step
# times at lIterations 10 and 110, ARAP_MARGINAL_STEPS steps each after one
# warm step, (t_110 - t_10) / 100
ARAP_MARGINAL = (10, 110)
ARAP_MARGINAL_STEPS = 3
# device_ms: calls per captured CUDA graph, replays per timing
GRAPH_CALLS = 10
GRAPH_REPLAYS = 5
# launches per timing when phase 8 drives the measurement scripts
SCRIPT_LAUNCHES = 10
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM and f32 outside
# the tensor cores; the bound of a kernel is the larger of its bytes (each
# input read once, each output written once) and its f32 operations over them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
ENERGY_SUFFIX = "\nr.snavely_reprojection_error.{}.set_materialize(True)\n"


def log(msg):
    print(msg, flush=True)


def timed_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn):
    """ms of device time per call of fn: GRAPH_CALLS calls captured in one
    CUDA graph, replayed GRAPH_REPLAYS times between two events.  Where
    capture fails, the summed device time of fn's kernels under
    torch.profiler."""
    from torch_measure import graph_ms

    try:
        return graph_ms(fn, GRAPH_CALLS, GRAPH_REPLAYS)
    except RuntimeError as exc:
        log(f"CUDA graph capture failed ({str(exc).splitlines()[0]}); device time "
            "from torch.profiler")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(GRAPH_CALLS):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 / GRAPH_CALLS


def compare(name, got, ref, terms=None):
    """max|got - ref| over all outputs; fails above KERNEL_TOL * max|ref|,
    or, given terms = (each output's sum of |terms|, its number of terms),
    where an output differs by more than KERNEL_SUM_TOL sqrt(n) x its
    sum of |terms|.  A third entry of terms, a tolerance, holds only the
    hot outputs (those summing at least 1% of all terms) to that rule and
    the others to tolerance x max|ref|."""
    err, scale = 0.0, 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
        err = max(err, float((g - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
        if terms is not None:
            n = terms[1][k]
            bound = KERNEL_SUM_TOL * n.sqrt() * terms[0][k]
            if len(terms) == 3:
                hot = n >= 0.01 * n.sum(-1, keepdim=True)
                bound = torch.where(hot, bound, terms[2] * float(r.abs().max()))
            excess = float(((g - r).abs() - bound).max())
            if excess > 0:
                raise AssertionError(f"{name}: an output is off by {excess:.3e} more than "
                                     f"{KERNEL_SUM_TOL:.2e} sqrt(n) x the sum of its terms' "
                                     "magnitudes")
    if terms is None and err > KERNEL_TOL * scale:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {KERNEL_TOL} * {scale:.3e}")
    return err


def hbm_peak():
    """The card's own HBM peak: max memory clock (nvidia-smi) x 2 (double
    data rate) x bus width (torch's device properties)."""
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.memory",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, check=True, timeout=60).stdout.split()
    bus = getattr(torch.cuda.get_device_properties(0), "memory_bus_width", None)
    if not clock or not clock[0].isdigit() or not bus:
        return f"not reported (memory clock {clock}, bus width {bus})"
    rate = int(clock[0]) * 1e6 * 2 * bus / 8
    return f"{rate:.4e} B/s (memory clock {clock[0]} MHz, {bus}-bit bus)"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


PAIR_KERNELS = ("fused_pair_apply", "fused_pair_apply_atomics", "fused_pair_apply_wloop",
                "fused_pair_apply_wloop_chunked", "fused_pair_rows_floor")
# the same pair on bf16 blocks (cases tagged <tag>_bf16), with the cluster
# kernel of the variants v2 and v3 (the skewed levels: its hot camera)
BF16_PAIR_KERNELS = ("fused_pair_apply_bf16", "fused_pair_apply_wloop_bf16",
                     "fused_pair_bf16_atomics", "fused_pair_rows_floor", "fused_pair_v2_smem",
                     "fused_pair_v3_partials")


def pair_cases(tag, a, S, fusedpair, terms=None):
    """The fused pair's kernels on operands a (3 x 9), f32 blocks: the five
    f32 kernels; then on the same values as bf16 blocks (rounded), the
    bf16 ones: one case each; the rows-only floors are held to the plain
    version's rows."""
    b = (a[0], a[1].bfloat16(), *a[2:])
    # the hot-camera rule's magnitudes from the f32 values: bf16 rounding
    # moves each by at most 2^-9, far inside the rule's 10x margin
    return (_pair_cases(tag, a, S, fusedpair, PAIR_KERNELS, terms)
            + _pair_cases(tag + "_bf16", b, S, fusedpair, BF16_PAIR_KERNELS, terms))


def _pair_cases(tag, a, S, fusedpair, kernels, terms):
    W, N = a[0].shape
    cases = []
    for name in kernels:
        floor = name == "fused_pair_rows_floor"
        cases.append((name, tag,
                      lambda fn=getattr(fusedpair, name), floor=floor:
                      (fn(*a, Ci=3, Cj=9, S=S),) if floor else fn(*a, Ci=3, Cj=9, S=S),
                      lambda floor=floor: fusedpair.fused_pair_apply_reference(
                          *a, Ci=3, Cj=9, S=S)[:1 if floor else 2],
                      None, nbytes(*a), (2 if floor else 4) * W * N * 27,
                      (lambda floor=floor: tuple(t[:1 if floor else 2] for t in terms()))
                      if terms else None))
    return cases


PRODUCTS_KERNELS = ("oh_setup_products", "oh_setup_products_atomics")


def products_cases(tag, a, N, recipe, terms=None):
    """oh_setup_products's two kernels (the shared-memory kernel and the
    first, global-atomics body) on operands a = (rT, Jall, ids)."""
    from thallo_tpu_torch.ops import ohsetup

    R = a[0].shape[1]
    return [(name, tag, lambda fn=getattr(ohsetup, name): (fn(*a, N=N, recipe=recipe),),
             lambda: (ohsetup.oh_setup_products_reference(*a, N=N, recipe=recipe),),
             None, nbytes(*a), (9 + 9 + 81) * 2 * 2 * R, terms)
            for name in PRODUCTS_KERNELS]


def kernel_cases(dev, rng, scene, skew_oToC):
    """(name, shape tag, kernel call, plain call, library call or None,
    input bytes, f32 operations, None or the plain call on |inputs| and on
    ones (each output's sum of |terms| and number of terms)) per
    kernel, at the BA-1M shapes and at a small ragged shape with
    out-of-range ids or padded plan lanes."""
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup, segsum

    def t(a):
        return torch.from_numpy(a).to(dev)

    cases = []
    for tag, (W, N, S) in (("ba1m", (4, 250_000, 1024)), ("ragged", (3, 1001, 500))):
        ids = rng.integers(0, S, (W, N)).astype(np.int32)
        if tag == "ragged":
            ids[:, -7:] = S + 3
            ids[0, :5] = -1
        a = (t(ids), t(rng.normal(size=(W * 27, N)).astype(np.float32)),
             t(rng.normal(size=(9, S)).astype(np.float32)),
             t(rng.normal(size=(3, N)).astype(np.float32)))
        cases += pair_cases(tag, a, S, fusedpair)
    oh_recipe = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))
    for tag, (R, N) in (("ba1m", (1_000_000, 1024)), ("ragged", (2349, 97))):
        ids = rng.integers(0, N, R).astype(np.int32)
        if tag == "ragged":
            ids[:3] = N + 7
            ids[3] = -2
        a = (t(rng.normal(size=(2, R)).astype(np.float32)),
             t(rng.normal(size=(18, R)).astype(np.float32)), t(ids))
        cases += products_cases(tag, a, N, oh_recipe)
    # the point level of the uniform scene (the solver's recipe), a ragged
    # one, and W = 9 (which fullrepeat_setup gives the first body)
    fr_recipe = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 6, 9, 0), ("diag", 0, 3, 0, 3))
    for tag, (N_t, W) in (("ba1m", (250_000, 4)), ("ragged", (131, 3)), ("ragged_w9", (131, 9))):
        a = (t(rng.normal(size=(2, N_t * W)).astype(np.float32)),
             t(rng.normal(size=(24, N_t * W)).astype(np.float32)))

        def run(fn, a=a, N_t=N_t, W=W):
            agg, crosses = fn(*a, W=W, N_t=N_t, recipe=fr_recipe)
            return (agg, *crosses)

        for name in ("fullrepeat_setup", "fullrepeat_setup_thread"):
            cases.append((name, tag,
                          lambda run=run, fn=getattr(fullrepeat, name): run(fn),
                          lambda run=run: run(fullrepeat.fullrepeat_setup_reference),
                          None, nbytes(*a), (3 + 3 + 27 + 9) * 2 * 2 * N_t * W, None))
    # the camera scatter of the materialized-J schedules: [9, 1M] by oToC;
    # the skewed scene's oToC (one camera with half the rows: that
    # camera's outputs held to the sqrt(n) rule, the rest to KERNEL_TOL);
    # a ragged R with out-of-range ids
    for tag, (R, N) in (("ba1m", (len(scene["oToC"]), BA_1M[0])),
                        ("skew_cameras", (len(skew_oToC), SKEW_1M[0])), ("ragged", (2349, 97))):
        if tag == "ba1m":
            ids = np.asarray(scene["oToC"], np.int32)
        elif tag == "skew_cameras":
            ids = np.asarray(skew_oToC, np.int32)
        else:
            ids = rng.integers(0, N, R).astype(np.int32)
            ids[:3] = N + 7
            ids[3] = -2
        a = (t(rng.normal(size=(9, R)).astype(np.float32)), t(ids))
        ok = (a[1] >= 0) & (a[1] < N)
        lib_args = (a[1][ok].long(), a[0][:, ok].contiguous())
        terms = None
        if tag == "skew_cameras":
            terms = lambda a=a, N=N: (  # noqa: E731
                (ohsetup.oh_setup_aggregate_reference(a[0].abs(), a[1], N=N),),
                (ohsetup.oh_setup_aggregate_reference(torch.ones_like(a[0]), a[1], N=N),),
                KERNEL_TOL)
        for name in ("oh_setup_aggregate", "oh_setup_aggregate_atomics"):
            cases.append((name, tag,
                          lambda a=a, N=N, fn=getattr(ohsetup, name): (fn(*a, N=N),),
                          lambda a=a, N=N: (ohsetup.oh_setup_aggregate_reference(*a, N=N),),
                          lambda la=lib_args, N=N: torch.zeros(
                              (9, N), device=dev).index_add_(1, *la),
                          nbytes(*a), 9 * R, terms))
    # the segment sum of APPLY_SEPARATELY + THALLO_SEGSUM=tiled: points
    # [1M, 3] -> [250000, 3] and cameras [1M, 9] -> [1024, 9], plans from
    # the scene's maps, data as the strided transpose of a channel-major
    # buffer (what lower.py's scatter passes) and row-major; the skewed
    # scene's camera map (one camera owns half the rows: a two-level plan
    # with a warp per segment at level 2); a ragged map with padded lanes
    # and one with empty segments
    seg = [("ba1m", np.asarray(scene["oToP"], np.int32), BA_1M[1], 3),
           ("ba1m_cameras", np.asarray(scene["oToC"], np.int32), BA_1M[0], 9),
           ("skew_cameras", np.asarray(skew_oToC, np.int32), SKEW_1M[0], 9),
           ("ragged", rng.integers(0, 300, 1001).astype(np.int32), 300, 3),
           ("ragged_empty", (rng.integers(0, 100, 1001) * 3).astype(np.int32), 340, 3)]
    for tag, ids, S, C in seg:
        plan = segsum.build_plan(ids, S, device=dev)
        if plan is None:
            raise AssertionError(f"segment_sum[{tag}]: build_plan refused the map")
        if tag == "ragged" and not bool((plan.mask == 0).any()):
            raise AssertionError("segment_sum[ragged]: the plan has no padded lanes")
        log(f"segment_sum[{tag}] plan: {len(ids)} rows -> {S} segments, level kernels "
            f"{[('thread', 'warp')[m] for m in plan.modes]}, "
            f"{0 if plan.piece_start is None else plan.piece_start.shape[0] - 1} pieces")
        cm = t(rng.normal(size=(C, len(ids))).astype(np.float32))
        layouts = [("", cm.T)]
        if not tag.startswith("ragged"):
            layouts.append(("_rowmajor", cm.T.contiguous()))
        idl = t(ids).long()
        for suffix, data in layouts:
            terms = None
            if tag == "skew_cameras":  # the hot camera sums ~478k rows
                terms = lambda d=data, p=plan: (  # noqa: E731
                    (segsum.segment_sum_reference(d.abs(), p),),
                    (segsum.segment_sum_reference(torch.ones_like(d), p),))
            cases.append(("segment_sum", tag + suffix,
                          lambda d=data, p=plan: (segsum.segment_sum(d, p),),
                          lambda d=data, p=plan: (segsum.segment_sum_reference(d, p),),
                          lambda d=data, S=S, C=C, idl=idl: torch.zeros(
                              (S, C), device=dev).index_add_(0, idl, d),
                          # the compact form: 4 bytes a lane, the offsets, data once
                          nbytes(cm, plan.order, plan.seg_start), len(ids) * C, terms))
    return cases


def _pair_args(t, rng, ids, Ci=3, Cj=9, S=1024, block_dtype=torch.float32):
    W, N = ids.shape
    return (ids, t(rng.normal(size=(W * Ci * Cj, N)).astype(np.float32)).to(block_dtype),
            t(rng.normal(size=(Cj, S)).astype(np.float32)),
            t(rng.normal(size=(Ci, N)).astype(np.float32)))


def skew_kernel_cases(dev, rng, bsr):
    """The skewed 1M scene's kernels: the fused pair at each level of its
    sorted point tables by every kernel (the solver takes the one
    fused_pair_route names) and a ragged wide level; oh_setup_products and
    its first body at its camera ids."""
    from thallo_tpu_torch.ops import fusedpair, ohsetup

    def t(a):
        return torch.from_numpy(a).to(dev)

    cases = []
    levels = [bsr.cols[bsr.col_gathers[pr[3]][0]] for pr in bsr.pairs if pr[2] == "col"]
    log("skewed scene point levels (W, N_t): " + ", ".join(str(tuple(c.shape)) for c in levels))
    ragged = rng.integers(0, 500, (24, 1001)).astype(np.int32)
    ragged[:, -7:] = 503
    ragged[0, :5] = -1
    # the widest level is tagged skew_tail: the W-loop kernel's record
    shapes = [(f"skew_w{c.shape[0]}", c, 1024) for c in levels[:-1]]
    shapes += [("skew_tail", levels[-1], 1024), ("ragged_w24", t(ragged), 500)]
    for tag, ids, S in shapes:
        a = _pair_args(t, rng, ids, S=S)
        absa = (a[0], *(x.abs() for x in a[1:]))
        ones = (a[0], *(torch.ones_like(x) for x in a[1:]))
        cases += pair_cases(tag, a, S, fusedpair, lambda b=(absa, ones), S=S: tuple(
            fusedpair.fused_pair_apply_reference(*x, Ci=3, Cj=9, S=S) for x in b))
    cam = next(x for x in bsr.oh_idxs if x is not None)
    R = cam.shape[0]
    a = (t(rng.normal(size=(2, R)).astype(np.float32)),
         t(rng.normal(size=(18, R)).astype(np.float32)), cam)
    recipe = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))
    absa = (a[0].abs(), a[1].abs(), cam)
    ones = (torch.ones_like(a[0]), torch.ones_like(a[1]), cam)
    cases += products_cases("skew", a, BA_1M[0], recipe, lambda b=(absa, ones): tuple(
        (ohsetup.oh_setup_products_reference(*x, N=BA_1M[0], recipe=recipe),) for x in b))
    return cases


def measurement_kernel_cases(dev, rng):
    """The measurement scripts' kernels: the bf16-block fused pair, its
    three cols variants (v2 and v3 by the cluster kernel), the first
    bodies of v2 and v3 (_generic) and the cluster kernel without its
    cross-cluster step at the JAX scripts' ba_1m_pt_cam shape (W 4,
    N 250 000, S 1024) and a ragged one; the launch-floor probe on one
    [8, 1024] tile and as 64 tiles over [8, 65536]."""
    from thallo_tpu_torch.ops import fusedpair, loopfloor

    def t(a):
        return torch.from_numpy(a).to(dev)

    cases = []
    for tag, (W, N, S) in (("ba1m", (4, 250_000, 1024)), ("ragged", (3, 1001, 500))):
        ids = rng.integers(0, S, (W, N)).astype(np.int32)
        if tag == "ragged":
            ids[:, -7:] = S + 3
            ids[0, :5] = -1
        a = _pair_args(t, rng, t(ids), S=S, block_dtype=torch.bfloat16)
        for name in ("fused_pair_bf16", "fused_pair_v1_rows", "fused_pair_v1_rows_generic",
                     "fused_pair_v2_smem", "fused_pair_v3_partials", "fused_pair_v2_smem_generic",
                     "fused_pair_v3_partials_generic", "fused_pair_cluster_noflush"):
            rows_only = name in ("fused_pair_v1_rows", "fused_pair_v1_rows_generic",
                                 "fused_pair_cluster_noflush")
            cases.append((name, tag,
                          lambda a=a, S=S, fn=getattr(fusedpair, name), ro=rows_only:
                          (fn(*a, Ci=3, Cj=9, S=S),) if ro else fn(*a, Ci=3, Cj=9, S=S),
                          lambda a=a, S=S, ro=rows_only: fusedpair.fused_pair_apply_reference(
                              *a, Ci=3, Cj=9, S=S)[:1 if ro else 2],
                          None, nbytes(*a) - (nbytes(a[3]) if name.startswith("fused_pair_v1")
                                              else 0),
                          (2 if name.startswith("fused_pair_v1") else 4) * W * N * 27, None))
    for tag, tiles in (("tile1", 1), ("grid64", 64)):
        x = t(rng.normal(size=(loopfloor.ROWS, 1024 * tiles)).astype(np.float32))
        cases.append(("loop_floor_add_one", tag,
                      lambda x=x, n=tiles: (loopfloor.add_one(x, tiles=n),),
                      lambda x=x: (loopfloor.add_one_reference(x),),
                      lambda x=x: torch.add(x, 1.0), nbytes(x), x.numel(), None))
    return cases


# (kernel, case tag) -> the name of its entry in the kernels record
RECORD = {("fused_pair_apply", "ba1m"): "fused_pair_apply",
          ("fused_pair_apply_atomics", "arap256"): "fused_pair_apply_atomics",
          ("segment_sum", "ba1m_cameras"): "segment_sum_cameras",
          ("fused_pair_apply_wloop", "skew_tail"): "fused_pair_apply_wloop",
          ("fused_pair_apply_wloop_chunked", "skew_tail"): "fused_pair_apply_wloop_chunked",
          ("oh_setup_products", "ba1m"): "oh_setup_products",
          ("oh_setup_products_atomics", "ba1m"): "oh_setup_products_atomics",
          ("fullrepeat_setup", "ba1m"): "fullrepeat_setup",
          ("fullrepeat_setup_thread", "ba1m"): "fullrepeat_setup_thread",
          ("oh_setup_aggregate", "ba1m"): "oh_setup_aggregate",
          ("oh_setup_aggregate_atomics", "ba1m"): "oh_setup_aggregate_atomics",
          ("segment_sum", "ba1m"): "segment_sum",
          ("fused_pair_bf16", "ba1m"): "fused_pair_bf16",
          ("fused_pair_v1_rows", "ba1m"): "fused_pair_v1_rows",
          ("fused_pair_v1_rows_generic", "ba1m"): "fused_pair_v1_rows_generic",
          ("fused_pair_v2_smem", "ba1m"): "fused_pair_v2_smem",
          ("fused_pair_v3_partials", "ba1m"): "fused_pair_v3_partials",
          ("fused_pair_v2_smem_generic", "ba1m"): "fused_pair_v2_smem_generic",
          ("fused_pair_v3_partials_generic", "ba1m"): "fused_pair_v3_partials_generic",
          ("loop_floor_add_one", "tile1"): "loop_floor_add_one",
          ("loop_floor_add_one", "grid64"): "loop_floor_add_one_grid64",
          ("fused_pair_apply_bf16", "ba1m_bf16"): "fused_pair_apply_bf16",
          ("fused_pair_apply_wloop_bf16", "skew_tail_bf16"): "fused_pair_apply_wloop_bf16",
          ("fused_pair_bf16_atomics", "ba1m_bf16"): "fused_pair_bf16_atomics"}

# record entry -> (source, the TPU kernel it replaces: file:line of its
# pallas_call or kernel body, the smoke solve or phase whose launches it
# reports)
KERNELS = {
    "fused_pair_apply": ("thallo_tpu_torch/csrc/fused_pair.cu",
                         "thallo_tpu/ops/fusedpair.py:349", "block-sparse"),
    "fused_pair_apply_atomics": ("thallo_tpu_torch/csrc/fused_pair.cu",
                                 "thallo_tpu/ops/fusedpair.py:349", "arap256 grouped"),
    "fused_pair_apply_wloop": ("thallo_tpu_torch/csrc/fused_pair_wloop.cu",
                               "thallo_tpu/ops/fusedpair.py:385", "skew block-sparse"),
    "fused_pair_apply_wloop_chunked": ("thallo_tpu_torch/csrc/fused_pair_wloop.cu",
                                       "thallo_tpu/ops/fusedpair.py:385", "measurement"),
    "oh_setup_products": ("thallo_tpu_torch/csrc/oh_setup.cu",
                          "thallo_tpu/ops/ohsetup.py:192", "block-sparse"),
    "oh_setup_products_atomics": ("thallo_tpu_torch/csrc/oh_setup.cu",
                                  "thallo_tpu/ops/ohsetup.py:192", "measurement"),
    "fullrepeat_setup": ("thallo_tpu_torch/csrc/fullrepeat.cu",
                         "thallo_tpu/ops/fullrepeat.py:178", "block-sparse"),
    "fullrepeat_setup_thread": ("thallo_tpu_torch/csrc/fullrepeat.cu",
                                "thallo_tpu/ops/fullrepeat.py:178", "measurement"),
    "oh_setup_aggregate": ("thallo_tpu_torch/csrc/oh_aggregate.cu",
                           "thallo_tpu/ops/ohsetup.py:236", "precompute_j"),
    "oh_setup_aggregate_atomics": ("thallo_tpu_torch/csrc/oh_aggregate.cu",
                                   "thallo_tpu/ops/ohsetup.py:236", "measurement"),
    "segment_sum": ("thallo_tpu_torch/csrc/segsum.cu",
                    "thallo_tpu/ops/segsum.py:254", "apply_separately_tiled"),
    "segment_sum_cameras": ("thallo_tpu_torch/csrc/segsum.cu",
                            "thallo_tpu/ops/segsum.py:254", "apply_separately_tiled"),
    "fused_pair_bf16": ("thallo_tpu_torch/csrc/fused_pair.cu",
                        "scripts/tpu_fused_pair_micro.py:31", "measurement"),
    "fused_pair_bf16_atomics": ("thallo_tpu_torch/csrc/fused_pair_variants.cu",
                                "scripts/tpu_fused_pair_micro.py:31", "measurement"),
    "fused_pair_apply_bf16": ("thallo_tpu_torch/csrc/fused_pair.cu",
                              "thallo_tpu/ops/fusedpair.py:349", "bf16 block-sparse"),
    "fused_pair_apply_wloop_bf16": ("thallo_tpu_torch/csrc/fused_pair_wloop.cu",
                                    "thallo_tpu/ops/fusedpair.py:385", "skew bf16 block-sparse"),
    "fused_pair_v1_rows": ("thallo_tpu_torch/csrc/fused_pair_rows.cu",
                           "scripts/tpu_fused_variants.py:56", "measurement"),
    "fused_pair_v1_rows_generic": ("thallo_tpu_torch/csrc/fused_pair_variants.cu",
                                   "scripts/tpu_fused_variants.py:56", "measurement"),
    "fused_pair_v2_smem": ("thallo_tpu_torch/csrc/fused_pair_cluster.cu",
                           "scripts/tpu_fused_variants.py:80", "measurement"),
    "fused_pair_v3_partials": ("thallo_tpu_torch/csrc/fused_pair_cluster.cu",
                               "scripts/tpu_fused_variants.py:121", "measurement"),
    "fused_pair_v2_smem_generic": ("thallo_tpu_torch/csrc/fused_pair_variants.cu",
                                   "scripts/tpu_fused_variants.py:80", "measurement"),
    "fused_pair_v3_partials_generic": ("thallo_tpu_torch/csrc/fused_pair_variants.cu",
                                       "scripts/tpu_fused_variants.py:121", "measurement"),
    "loop_floor_add_one": ("thallo_tpu_torch/csrc/loop_floor.cu",
                           "scripts/tpu_loop_floor.py:36", "measurement"),
    "loop_floor_add_one_grid64": ("thallo_tpu_torch/csrc/loop_floor.cu",
                                  "scripts/tpu_loop_floor.py:36", "measurement"),
}


def counters():
    """Every kernel wrapper by name: each counts its own launches."""
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, loopfloor, ohsetup, segsum

    return {"fused_pair_apply": fusedpair.fused_pair_apply,
            "fused_pair_apply_atomics": fusedpair.fused_pair_apply_atomics,
            "fused_pair_rows_floor": fusedpair.fused_pair_rows_floor,
            "fused_pair_apply_wloop": fusedpair.fused_pair_apply_wloop,
            "fused_pair_apply_wloop_chunked": fusedpair.fused_pair_apply_wloop_chunked,
            "oh_setup_products": ohsetup.oh_setup_products,
            "oh_setup_products_atomics": ohsetup.oh_setup_products_atomics,
            "fullrepeat_setup": fullrepeat.fullrepeat_setup,
            "fullrepeat_setup_thread": fullrepeat.fullrepeat_setup_thread,
            "oh_setup_aggregate": ohsetup.oh_setup_aggregate,
            "oh_setup_aggregate_atomics": ohsetup.oh_setup_aggregate_atomics,
            "segment_sum": segsum.segment_sum,
            "fused_pair_bf16": fusedpair.fused_pair_bf16,
            "fused_pair_bf16_atomics": fusedpair.fused_pair_bf16_atomics,
            "fused_pair_apply_bf16": fusedpair.fused_pair_apply_bf16,
            "fused_pair_apply_wloop_bf16": fusedpair.fused_pair_apply_wloop_bf16,
            "fused_pair_v1_rows": fusedpair.fused_pair_v1_rows,
            "fused_pair_v1_rows_generic": fusedpair.fused_pair_v1_rows_generic,
            "fused_pair_v2_smem": fusedpair.fused_pair_v2_smem,
            "fused_pair_v3_partials": fusedpair.fused_pair_v3_partials,
            "fused_pair_v2_smem_generic": fusedpair.fused_pair_v2_smem_generic,
            "fused_pair_v3_partials_generic": fusedpair.fused_pair_v3_partials_generic,
            "fused_pair_cluster_noflush": fusedpair.fused_pair_cluster_noflush,
            "loop_floor_add_one": loopfloor.add_one}


def ba_plan(ba, tt, inputs, dims, device, n_iter, schedule=None, **options):
    """An LM plan of the BA energy, with `schedule` ("J" or "Jp") set to
    materialize in the energy text."""
    text = ba.ENERGY + (ENERGY_SUFFIX.format(schedule) if schedule else "")
    plan = tt.load_energy(text).plan(dims, solver="levenberg_marquardt", device=device,
                                     **options)
    plan.set_solver_parameter("nIterations", n_iter)
    return plan


def make_scene(ba, n_cameras, n_points, obs_per_point):
    t0 = time.perf_counter()
    inputs, _ = ba.synthetic_inputs(n_cameras=n_cameras, n_points=n_points,
                                    obs_per_point=obs_per_point, seed=SEED)
    log(f"scene {n_cameras}x{n_points}x{obs_per_point}: host generation "
        f"{time.perf_counter() - t0:.2f} s")
    return inputs, {"C": n_cameras, "P": n_points, "O": len(inputs["oToC"])}


def make_skew_scene(ba, n_cameras, n_points, target_obs):
    t0 = time.perf_counter()
    inputs, _ = ba.skewed_inputs(n_cameras=n_cameras, n_points=n_points,
                                 target_obs=target_obs, seed=SEED)
    log(f"skewed scene {n_cameras}x{n_points}, target {target_obs} observations: "
        f"{len(inputs['oToC'])} observations, host generation {time.perf_counter() - t0:.2f} s")
    return inputs, {"C": n_cameras, "P": n_points, "O": len(inputs["oToC"])}


def skew_tables(ba, tt, scene):
    """The block-sparse tables of the skewed scene, as its plan builds
    them on the card (residual sort, level tables)."""
    inputs, dims = scene
    plan = ba_plan(ba, tt, inputs, dims, "cuda", 1)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    return plan._prep["consts"][0]["bsr"]


def level_routes(bsr):
    """(W, N_t) of each col level of a plan's tables -> the fused-pair
    kernel fused_pair_route names for it."""
    from thallo_tpu_torch.ops import fusedpair

    out = {}
    for pr in bsr.pairs:
        if pr[2] == "col":
            W, N_t = bsr.cols[bsr.col_gathers[pr[3]][0]].shape
            S = int(np.prod(bsr.image_shapes[bsr.slot_images[pr[1]]][:-1]))
            out[W, N_t] = fusedpair.fused_pair_route(
                W, N_t, bsr.slot_channels[pr[0]], bsr.slot_channels[pr[1]], S)
    return out


def phase_small_skew(ba, tt):
    """The small skewed scene on the card and the CPU, 5 LM steps each,
    under scalar Jacobi (phase-3 bounds) and block Jacobi (its own)."""
    scene = make_skew_scene(ba, *SKEW_SMALL)
    inputs, dims = scene
    fns = counters()
    for precond, u_tol, c_tol in (("jacobi", STEP_U_TOL, STEP_COST_RTOL),
                                  ("auto", SKEW_BLOCK_U_TOL, SKEW_BLOCK_COST_RTOL)):
        runs = {}
        for device in ("cuda", "cpu"):
            plan = ba_plan(ba, tt, inputs, dims, device, 5, preconditioner=precond)
            for fn in fns.values():
                fn.launches = 0
            costs, Us = [plan.init({k: np.copy(v) for k, v in inputs.items()})], []
            for _ in range(5):
                plan.step()
                costs.append(plan.cost())
                Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
            torch.cuda.synchronize()
            runs[device] = (costs, Us, {n: fn.launches for n, fn in fns.items()})
        (cg, Ug, lg), (cc, Uc, _) = runs["cuda"], runs["cpu"]
        log(f"small skewed scene ({precond}) costs cuda {cg}")
        log(f"small skewed scene ({precond}) costs cpu  {cc}")
        routes = level_routes(plan._prep["consts"][0]["bsr"])
        log(f"small skewed scene ({precond}) point levels (W, N_t) -> kernel {routes}, card "
            f"launches {({n: lg[n] for n in set(routes.values())})}")
        if not all(lg[n] > 0 for n in routes.values()):
            raise AssertionError("small skewed scene: a routed fused-pair kernel never launched")
        check_steps(f"small skewed scene ({precond}) cuda vs cpu", cg, Ug, cc, Uc, u_tol, c_tol)
        never_rising(f"small skewed scene ({precond}) cuda", cg)


def phase_small_scene(ba, tt):
    runs = {}
    inputs, dims = make_scene(ba, 16, 1400, 4)
    for device in ("cuda", "cpu"):
        plan = ba_plan(ba, tt, inputs, dims, device, 5)
        costs, Us = [plan.init({k: np.copy(v) for k, v in inputs.items()})], []
        for _ in range(5):
            plan.step()
            costs.append(plan.cost())
            Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
        torch.cuda.synchronize()
        runs[device] = (costs, Us)
    (cg, Ug), (cc, Uc) = runs["cuda"], runs["cpu"]
    log(f"small scene costs cuda {cg}")
    log(f"small scene costs cpu  {cc}")
    check_steps("small scene cuda vs cpu", cg, Ug, cc, Uc)
    if not cg[-1] <= 1e-2 * cg[0]:
        raise AssertionError("small scene did not converge on the card")


def phase_small_grid():
    """image_warping 64 x 64 with an excluded square, 3 LM steps through
    run_steps on the card and on the CPU: unknowns and costs agree, the
    excluded unknowns never move (bit for bit)."""
    from torch_grid_profile import make_grid_plan

    runs = {}
    for device in ("cuda", "cpu"):
        plan = make_grid_plan(GRID_SMALL, device, solver="levenberg_marquardt", mask=GRID_MASK)
        U0 = {k: v.cpu().numpy() for k, v in plan.unknowns().items()}
        costs, Us = [plan.final_cost], []
        for _ in range(GRID_SMALL_STEPS):
            plan.run_steps(1)
            costs.append(plan.final_cost)
            Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
        runs[device] = (costs, Us, U0)
    (cg, Ug, U0), (cc, Uc, _) = runs["cuda"], runs["cpu"]
    log(f"grid {GRID_SMALL}x{GRID_SMALL} masked LM costs cuda {cg}")
    log(f"grid {GRID_SMALL}x{GRID_SMALL} masked LM costs cpu  {cc}")
    check_steps(f"grid {GRID_SMALL}x{GRID_SMALL} masked LM cuda vs cpu", cg, Ug, cc, Uc,
                GRID_U_TOL, GRID_COST_TOL)
    for k, U in enumerate(Ug):
        for name, u in U.items():
            if not np.array_equal(u[GRID_MASK], U0[name][GRID_MASK]):
                raise AssertionError(f"grid masked LM, step {k + 1}: excluded {name} moved")
    if np.array_equal(Ug[-1]["Offset"], U0["Offset"]):
        raise AssertionError("grid masked LM: the unknowns never moved")


def linear_parts(plan, p):
    """(cost, -JᵀF, diag(JᵀJ), JᵀJ·p) of plan at its current unknowns, as
    numpy: the solver's setup and one JᵀJ·p application, state untouched."""
    comp, prep, ins = plan.compiled, plan._prep, plan._step_inputs()
    st = comp.solve_setup(plan._U, plan._lm, ins, plan._sp(), prep)
    jtjp = comp.make_jtjp(plan._U, ins, prep["consts"], st["masks"], st["jac_store"])
    dev = plan._U[next(iter(plan._U))].device
    Ap = jtjp({k: torch.from_numpy(v).to(dev) for k, v in p.items()})
    as_np = lambda t: {k: v.cpu().numpy() for k, v in t.items()}  # noqa: E731
    return plan.final_cost, as_np(st["r0"]), as_np(st["rawdiag"]), as_np(Ap)


def phase_grid_512():
    """image_warping 512 x 512, GN, GRID_L_ITERATIONS PCG iterations:
    plan.warmup(), run_steps(1) three times (cost read after each), then
    run_steps(7) as one batch with no host read, plan.final_cost; every
    unknown finite, each checked step's cost within its
    GRID_TRAJ_RTOL of JAX's f32 trajectory.  After step 3 the grid path's
    linear algebra at full width (cost, -JᵀF, diag(JᵀJ), JᵀJ·p of a
    seeded p) against the port's CPU path on the same unknowns, within
    GRID_LINEAR_RTOL: this part is not sensitive to rounding.  Logs the
    step times and the device kernels per step and per PCG iteration."""
    from torch_grid_profile import launch_split, make_grid_plan

    label = f"grid {GRID_SIZE}x{GRID_SIZE} GN"
    t0 = time.perf_counter()
    plan = make_grid_plan(GRID_SIZE, "cuda", l_iterations=GRID_L_ITERATIONS, n_iter=GRID_STEPS)
    torch.cuda.synchronize()
    log(f"{label}: init {time.perf_counter() - t0:.3f} s, initial cost {plan.final_cost!r}")
    t0 = time.perf_counter()
    plan.warmup()
    log(f"{label}: warmup {time.perf_counter() - t0:.3f} s")
    costs, step_s = [plan.final_cost], []
    for _ in range(3):
        t0 = time.perf_counter()
        plan.run_steps(1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        costs.append(plan.final_cost)

    rng = np.random.default_rng(11)
    p = {k: rng.normal(size=tuple(v.shape)).astype(np.float32) for k, v in plan._U.items()}
    got = linear_parts(plan, p)
    cpu_plan = make_grid_plan(GRID_SIZE, "cpu", l_iterations=GRID_L_ITERATIONS)
    cpu_plan._U = {k: v.cpu() for k, v in plan._U.items()}
    ref = linear_parts(cpu_plan, p)
    del cpu_plan
    rel = abs(got[0] - ref[0]) / abs(ref[0])
    log(f"{label}, step 3, card vs CPU: cost {got[0]!r} vs {ref[0]!r}, rel {rel:.3e}")
    if not rel <= GRID_LINEAR_RTOL:
        raise AssertionError(f"{label}: cost at step 3, card {got[0]} vs CPU {ref[0]}")
    for what, a, b in zip(("-JᵀF", "diag(JᵀJ)", "JᵀJ·p"), got[1:], ref[1:]):
        for name in b:
            err = float(np.abs(a[name] - b[name]).max())
            scale = float(np.abs(b[name]).max())
            log(f"{label}, step 3, card vs CPU: {what} {name} max|diff| {err:.3e} "
                f"= {err / scale:.3e} x max|ref|")
            if not err <= GRID_LINEAR_RTOL * scale:
                raise AssertionError(f"{label}: {what} of {name} at step 3, card vs CPU, "
                                     f"{err} > {GRID_LINEAR_RTOL} x {scale}")

    t0 = time.perf_counter()
    n = plan.run_steps(GRID_STEPS - 3)
    torch.cuda.synchronize()
    batch = time.perf_counter() - t0
    costs.append(plan.final_cost)
    if n != GRID_STEPS - 3 or plan.num_iterations != GRID_STEPS:
        raise AssertionError(f"{label}: run_steps ran {n} steps, {plan.num_iterations} in all")
    per_step = step_s[1:] + [batch / n] * n
    log(f"{label} costs after steps 0-3 and {GRID_STEPS}: {costs}")
    log(f"{label} step times: steps 1-3 {[round(t * 1e3, 2) for t in step_s]} ms, steps 4-"
        f"{GRID_STEPS} one run_steps({n}) batch {batch * 1e3:.2f} ms; median of steps 2-"
        f"{GRID_STEPS} {float(np.median(per_step)) * 1e3:.2f} ms")
    for name, U in plan.unknowns().items():
        if not bool(torch.isfinite(U).all()):
            raise AssertionError(f"{label}: non-finite unknowns {name}")
    got = dict(zip((0, 1, 2, 3, GRID_STEPS), costs))
    for k, tol in ((0, GRID_LINEAR_RTOL),) + tuple(GRID_TRAJ_RTOL.items()):
        ref_k, f64_k = GRID_JAX_COSTS[k], GRID_JAX_F64_COSTS[k]
        rel = abs(got[k] - ref_k) / abs(ref_k)
        log(f"{label} step {k}: cost {got[k]!r} vs JAX {ref_k!r}, rel {rel:.3e} (limit {tol}); "
            f"vs JAX in f64 {f64_k!r}, rel {abs(got[k] - f64_k) / f64_k:.3e}")
        if not (np.isfinite(got[k]) and rel <= tol):
            raise AssertionError(f"{label}, step {k}: cost {got[k]} vs JAX {ref_k}")
    full, per_iter, rest = launch_split(plan)
    log(f"{label} device kernels: {full} a step, {per_iter:.1f} a PCG iteration, "
        f"{rest:.1f} setup + update; LINEARIZE applies JᵀJ·p from the setup's point Jacobians")


def check_steps(what, costs, Us, ref_costs, ref_Us, u_tol=STEP_U_TOL,
                cost_rtol=STEP_COST_RTOL, cost_atol=0.0):
    """Costs within cost_rtol (plus cost_atol) and unknowns within u_tol x
    max|U| of the reference, step by step (as far as both lists go)."""
    rel = [max(float(np.abs(u[n] - ref[n]).max() / max(np.abs(ref[n]).max(), 1e-30))
               for n in ref) for u, ref in zip(Us, ref_Us)]
    log(f"{what}: max|dU|/max|U| per step {rel}")
    for k, (a, b) in enumerate(zip(costs, ref_costs)):
        if not (np.isfinite(a) and abs(a - b) <= cost_rtol * abs(b) + cost_atol):
            raise AssertionError(f"{what}, step {k}: cost {a} vs {b}")
    for k, (u, ref) in enumerate(zip(Us, ref_Us)):
        for name in ref:
            err = np.abs(u[name] - ref[name]).max()
            if not err <= u_tol * np.abs(ref[name]).max():
                raise AssertionError(f"{what}, step {k + 1}: {name} differs by {err}")


class _Tally:
    """A kernel wrapper behind a hook that adds the launches of each call,
    read from the wrapper's own count around it, to counts[key(*args,
    **kwargs)].  ``launches`` passes through to the wrapper's count, which
    a wrapper reaches by its module-level name."""

    def __init__(self, real, key):
        self.real, self.key, self.counts = real, key, collections.Counter()

    def __call__(self, *args, **kwargs):
        n0 = self.real.launches
        out = self.real(*args, **kwargs)
        self.counts[self.key(*args, **kwargs)] += self.real.launches - n0
        return out

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n


@contextlib.contextmanager
def tally(module, name, key):
    """``module.name`` (a kernel wrapper) behind a _Tally while the block
    runs; yields its counts."""
    real = getattr(module, name)
    hook = _Tally(real, key)
    setattr(module, name, hook)
    try:
        yield hook.counts
    finally:
        setattr(module, name, real)


def solve_1m(ba, tt, scene, label, kernels, n_steps=N_STEPS_1M, schedule=None,
             keep_unknowns=0, **options):
    """One LM solve of the 1M scene on the card, on its own copy of the
    scene.  The counts of `kernels` are set to 0 just before the solve and
    read just after; every one of them must have launched.  Returns
    (costs, unknowns of the first `keep_unknowns` steps, launches, plan)."""
    inputs, dims = scene
    plan = ba_plan(ba, tt, inputs, dims, "cuda", n_steps, schedule, **options)
    own = {k: np.copy(v) for k, v in inputs.items()}
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    c0 = plan.init(own)
    torch.cuda.synchronize()
    log(f"{label}: init (tables, upload, initial cost) {time.perf_counter() - t0:.3f} s; "
        f"initial cost {c0!r}")
    costs, step_s, Us = [c0], [], []
    while True:
        t0 = time.perf_counter()
        more = plan.step()  # LM reads its stop flag: the step has finished
        torch.cuda.synchronize()
        if plan.num_iterations > len(step_s):
            step_s.append(time.perf_counter() - t0)
            costs.append(plan.cost())
            if len(Us) < keep_unknowns:
                Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
            log(f"{label} LM step {len(step_s)}: {step_s[-1] * 1e3:.2f} ms, cost {costs[-1]!r}")
        if not more:
            break
    launches = {name: fn.launches for name, fn in fns.items()}
    log(f"{label} launches {launches}")
    if not all(np.isfinite(costs)):
        raise AssertionError(f"{label}: non-finite cost in {costs}")
    missing = [n for n in kernels if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on this path: {missing}")
    for name, U in plan.unknowns().items():
        if not bool(torch.isfinite(U).all()):
            raise AssertionError(f"{label}: non-finite unknowns {name}")
    steady = step_s[1:] or step_s
    log(f"{label} LM step time: first {step_s[0] * 1e3:.2f} ms, median of the rest "
        f"{float(np.median(steady)) * 1e3:.2f} ms over {len(steady)} steps")
    return costs, Us, launches, plan


def never_rising(label, costs):
    """LM keeps the unknowns of a rejected step, so the cost after each
    step is at most the one before it."""
    for k, (a, b) in enumerate(zip(costs, costs[1:])):
        if not b <= a:
            raise AssertionError(f"{label}: cost rose at step {k + 1}: {a} -> {b}")


def phase_ba_1m(ba, tt, scene):
    """Returns the launches and the final cost."""
    costs, _, launches, _ = solve_1m(ba, tt, scene, "1M block-sparse", (
        "fused_pair_apply", "oh_setup_products", "fullrepeat_setup"))
    if not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    return launches, costs[-1]


def phase_ba_1m_bf16(ba, tt, scene, f32_final):
    """The uniform 1M solve under block_dtype="bf16": every cross block
    through the bf16 persistent kernel, none through an f32 or atomics
    fused pair."""
    label = "1M block-sparse bf16"
    costs, _, launches, _ = solve_1m(ba, tt, scene, label, (
        "fused_pair_apply_bf16", "oh_setup_products", "fullrepeat_setup"), block_dtype="bf16")
    stray = [n for n in ("fused_pair_apply", "fused_pair_apply_atomics", "fused_pair_apply_wloop",
                         "fused_pair_apply_wloop_chunked", "fused_pair_bf16_atomics",
                         "fused_pair_v2_smem", "fused_pair_v3_partials") if launches[n]]
    if stray:
        raise AssertionError(f"{label}: launched {stray}, not the bf16 persistent kernel")
    never_rising(label, costs)
    if not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"{label}: final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    log(f"{label}: final cost {costs[-1]!r} (f32 blocks, phase 4: {f32_final!r})")
    return launches


def phase_precompute_j(ba, tt, scene):
    costs, Us, launches, _ = solve_1m(ba, tt, scene, "1M PRECOMPUTE_J", ("oh_setup_aggregate",),
                                   schedule="J", keep_unknowns=CROSS_STEPS,
                                   preconditioner="jacobi")
    never_rising("1M PRECOMPUTE_J", costs)
    ref_costs, ref_Us, _, _ = solve_1m(ba, tt, scene, "1M block-sparse, jacobi",
                                    ("fused_pair_apply",), n_steps=CROSS_STEPS,
                                    keep_unknowns=CROSS_STEPS, preconditioner="jacobi")
    check_steps("PRECOMPUTE_J vs block-sparse (jacobi)", costs[:CROSS_STEPS + 1], Us,
                ref_costs, ref_Us)
    return launches, (costs, Us)


def phase_apply_separately_tiled(ba, tt, scene, ref):
    from thallo_tpu_torch import lower

    os.environ["THALLO_SEGSUM"] = "tiled"  # read by plan.init, as thallo_tpu reads it
    try:
        with tally(lower, "segment_sum", lambda data, plan: plan.num_segments) as by_plan:
            costs, Us, launches, _ = solve_1m(ba, tt, scene, "1M APPLY_SEPARATELY tiled",
                                           ("segment_sum",), schedule="Jp",
                                           keep_unknowns=CROSS_STEPS)
    finally:
        del os.environ["THALLO_SEGSUM"]
    # the record lists the two plans apart: points, cameras
    launches["segment_sum"] = by_plan[scene[1]["P"]]
    launches["segment_sum_cameras"] = by_plan[scene[1]["C"]]
    log(f"1M APPLY_SEPARATELY tiled segment_sum launches per plan (segments): {dict(by_plan)}")
    if min(launches["segment_sum"], launches["segment_sum_cameras"]) <= 0:
        raise AssertionError("1M APPLY_SEPARATELY tiled: a segment-sum plan never launched")
    never_rising("1M APPLY_SEPARATELY tiled", costs)
    check_steps("APPLY_SEPARATELY tiled vs PRECOMPUTE_J", costs[:CROSS_STEPS + 1], Us,
                ref[0], ref[1])
    return launches


# the bf16 instantiation of each kernel fused_pair_route names (the rest:
# fused_pair_bf16_atomics)
BF16_ROUTES = {"fused_pair_apply": "fused_pair_apply_bf16",
               "fused_pair_apply_wloop": "fused_pair_apply_wloop_bf16"}


def phase_skew_1m(ba, tt, scene, block_dtype=None, n_steps=N_STEPS_1M):
    """The skewed 1M solve: level tables after the residual sort; under
    block_dtype="bf16" each level through the bf16 kernel of its route
    (no convergence gate in a few steps)."""
    from thallo_tpu_torch.solver import blocksparse

    label = "1M skew block-sparse" + (" bf16" if block_dtype else "")
    names = (("fused_pair_apply_bf16", "fused_pair_apply_wloop_bf16", "fused_pair_bf16_atomics")
             if block_dtype else ("fused_pair_apply", "fused_pair_apply_atomics",
                                  "fused_pair_apply_wloop", "fused_pair_apply_wloop_chunked"))
    by_shape = {}
    with contextlib.ExitStack() as hooks:
        for name in names:
            by_shape[name] = hooks.enter_context(
                tally(blocksparse, name, lambda ids, *a, **k: tuple(ids.shape)))
        costs, _, launches, plan = solve_1m(ba, tt, scene, label, ("oh_setup_products",),
                                            n_steps=n_steps, block_dtype=block_dtype)
    if "O" not in plan._residual_perms:
        raise AssertionError(f"{label}: the residual sort was not applied")
    routes = level_routes(plan._prep["consts"][0]["bsr"])
    if block_dtype:
        routes = {shape: BF16_ROUTES.get(name, "fused_pair_bf16_atomics")
                  for shape, name in routes.items()}
    log(f"{label} point levels (W, N_t) -> kernel {routes}")
    missing = [(shape, name) for shape, name in routes.items() if by_shape[name][shape] <= 0]
    if missing:
        raise AssertionError(f"{label}: levels whose routed kernel never launched: {missing}")
    never_rising(label, costs)
    if not block_dtype and not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"{label}: final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    log(f"{label} launches per level shape: " + ", ".join(
        f"(W {W}, N_t {N}) {name} {n}" for name, counts in by_shape.items()
        for (W, N), n in sorted(counts.items())))
    return launches


def phase_schur_small(ba, tt, device="cuda", ref_device="cpu"):
    """Phase 12: schur_pcg and schur_dense on `device` against
    `ref_device`, on the small uniform and skewed scenes; schur_dense's
    first step against the direct solve on `device`."""
    C, P, W, seed = SCHUR_SMALL
    inputs, _ = ba.synthetic_inputs(n_cameras=C, n_points=P, obs_per_point=W, seed=seed)
    small = (inputs, {"C": C, "P": P, "O": len(inputs["oToC"])})
    skew = make_skew_scene(ba, *SKEW_SMALL)
    fns = counters()
    for label, (inputs, dims), u_tol, c_tol in (
            ("small", small, STEP_U_TOL, STEP_COST_RTOL),
            ("small skewed", skew, SKEW_BLOCK_U_TOL, SKEW_BLOCK_COST_RTOL)):
        traj_u, traj_c = SCHUR_TRAJ[label]
        for ls in ("schur_pcg", "schur_dense"):
            runs = {}
            for dev in (device, ref_device):
                plan = ba_plan(ba, tt, inputs, dims, dev, SCHUR_SMALL_STEPS, linear_solver=ls)
                for fn in fns.values():
                    fn.launches = 0
                costs = [plan.init({k: np.copy(v) for k, v in inputs.items()})]
                Us = []
                for _ in range(SCHUR_SMALL_STEPS):
                    plan.step()
                    costs.append(plan.cost())
                    Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
                runs[dev] = (costs, Us, {n: fn.launches for n, fn in fns.items()})
            (cg, Ug, lg), (cc, Uc, _) = runs[device], runs[ref_device]
            log(f"{label} scene {ls} costs {device} {cg}")
            log(f"{label} scene {ls} costs {ref_device} {cc}")
            routes = set(level_routes(plan._prep["consts"][0]["bsr"]).values())
            log(f"{label} scene {ls} fused-pair launches on {device} "
                f"{({n: lg[n] for n in routes})}")
            if device == "cuda" and not all(lg[n] > 0 for n in routes):
                raise AssertionError(f"{label} scene {ls}: a routed fused-pair kernel never "
                                     "launched")
            check_steps(f"{label} scene {ls} {device} vs {ref_device}, step 1", cg[:2], Ug[:1],
                        cc[:2], Uc[:1], u_tol, c_tol)
            check_steps(f"{label} scene {ls} {device} vs {ref_device}", cg, Ug, cc, Uc,
                        traj_u, traj_c)
            never_rising(f"{label} scene {ls} {device}", cg)
    inputs, dims = small
    first = {}
    for ls in ("schur_dense", "direct"):
        plan = ba_plan(ba, tt, inputs, dims, device, 1, linear_solver=ls)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        plan.step()
        first[ls] = {k: v.cpu().numpy() for k, v in plan.unknowns().items()}
    for name, ref in first["direct"].items():
        err = np.abs(first["schur_dense"][name] - ref).max()
        log(f"small scene schur_dense vs direct, step 1, {name}: max|dU| {err!r} "
            f"(max|U| {np.abs(ref).max()!r})")
        if not err <= EXACT_TOL * np.abs(ref).max():
            raise AssertionError(f"small scene: schur_dense step 1 differs from direct in {name}")


@contextlib.contextmanager
def timed_calls(cls, name, sync):
    """cls.name behind a hook that records the seconds of each call,
    synchronized before and after; yields the list of seconds."""
    real, seconds = getattr(cls, name), []

    def hook(self, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = real(self, *args, **kwargs)
        sync()
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(cls, name, hook)
    try:
        yield seconds
    finally:
        setattr(cls, name, real)


@contextlib.contextmanager
def solve_residuals(cls):
    """cls._dense_solve behind a hook that records |S x - b| / |b| of each
    solve in full f32; yields the list."""
    real, out = cls._dense_solve, []

    def hook(self, S, b):
        x = real(self, S, b)
        out.append(float(torch.linalg.vector_norm(S @ x - b) / torch.linalg.vector_norm(b)))
        return x

    cls._dense_solve = hook
    try:
        yield out
    finally:
        cls._dense_solve = real


SCHUR_1M_KERNELS = ("fused_pair_apply", "oh_setup_products", "fullrepeat_setup")


def phase_schur_1m(ba, tt, scene):
    """Phase 13: the uniform 1M scene under schur_pcg, then schur_dense."""
    from thallo_tpu_torch.solver.gn import CompiledSolver

    label = "1M schur_pcg"
    costs, _, launches, _ = solve_1m(ba, tt, scene, label, SCHUR_1M_KERNELS,
                                     linear_solver="schur_pcg",
                                     solver_parameters={"lIterations": SCHUR_L_ITERATIONS})
    never_rising(label, costs)
    if not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"{label}: final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    label = "1M schur_dense"
    torch.cuda.reset_peak_memory_stats()
    with timed_calls(CompiledSolver, "_schur_dense_matrix", torch.cuda.synchronize) as t_S, \
            timed_calls(CompiledSolver, "_dense_solve", torch.cuda.synchronize) as t_solve, \
            solve_residuals(CompiledSolver) as res:
        costs, _, _, _ = solve_1m(ba, tt, scene, label, SCHUR_1M_KERNELS,
                                  n_steps=SCHUR_DENSE_STEPS, linear_solver="schur_dense",
                                  schur_dense_max=SCHUR_DENSE_MAX)
    never_rising(label, costs)
    log(f"{label}: S assembly {[round(t * 1e3, 2) for t in t_S]} ms, LU solve "
        f"{[round(t * 1e3, 2) for t in t_solve]} ms per step; |S x - b| / |b| {res}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_schur_skew_1m(ba, tt, scene):
    """Phase 14: the skewed 1M scene under schur_pcg."""
    label = "1M skew schur_pcg"
    costs, _, launches, _ = solve_1m(
        ba, tt, scene, label, ("fused_pair_apply", "fused_pair_apply_wloop", "oh_setup_products"),
        linear_solver="schur_pcg", solver_parameters={"lIterations": SCHUR_L_ITERATIONS})
    never_rising(label, costs)
    log(f"{label}: final / initial cost {costs[-1] / costs[0]!r}")
    return launches


def cold_restart(plan, c0):
    """bench.py's _cold_restart: the initial unknowns, iteration 0, the
    initial trust radius and previous cost."""
    plan.reset_unknowns()
    plan._lm = plan._lm._replace(
        trust_region_radius=plan._scalar(plan.solver_parameters["trust_region_radius"]),
        prev_cost=plan._scalar(c0), n_iter=0,
        finished=torch.zeros((), dtype=torch.bool, device=plan.device))


def time_to_target(ba, tt, scene, linear_solver, l_iterations, device="cuda"):
    """bench.py's bench_ba_time_to_target on the port, its timed run
    going on to TTT_COMMON x the initial cost: (target, common target,
    converged cost, [(seconds, cost) after each timed step])."""
    inputs, dims = scene
    options = {"schur_dense_max": SCHUR_DENSE_MAX} if linear_solver == "schur_dense" else {}
    plan = ba_plan(ba, tt, inputs, dims, device, 10_000, linear_solver=linear_solver,
                   **options)
    plan.set_solver_parameter("lIterations", l_iterations)
    plan.set_solver_parameter("q_tolerance", 0.0)
    plan.set_solver_parameter("function_tolerance", 0.0)
    c0 = plan.init({k: np.copy(v) for k, v in inputs.items()})
    plan.run_steps(TTT_STEPS)
    converged = plan.cost()
    target = c0 - 0.95 * (c0 - converged)
    cold_restart(plan, c0)
    plan.step()  # warm: the first step's allocations
    cold_restart(plan, c0)
    common, trace = TTT_COMMON * c0, []
    t0 = time.perf_counter()
    for _ in range(TTT_STEPS):
        if not plan.step():
            break
        trace.append((time.perf_counter() - t0, plan.cost()))
        if trace[-1][1] <= min(target, common):
            break
    return target, common, converged, trace


def phase_time_to_target(ba, tt, scene, device="cuda"):
    def reached(trace, limit):
        return next((f"{s!r} s in {k + 1} steps" for k, (s, c) in enumerate(trace)
                     if c <= limit), f"not reached in {len(trace)} steps")

    for linear_solver, l_iterations in TTT_VARIANTS:
        target, common, converged, trace = time_to_target(ba, tt, scene, linear_solver,
                                                          l_iterations, device)
        steps = np.diff([0.0] + [s for s, _ in trace]) * 1e3
        log(f"time to target, uniform {scene[1]['C']}x{scene[1]['P']}, {linear_solver} "
            f"lIterations {l_iterations}: bench.py's target {target!r}: "
            f"{reached(trace, target)}; {TTT_COMMON} x initial cost {common!r}: "
            f"{reached(trace, common)}; timed steps {np.round(steps, 2).tolist()} ms, costs "
            f"{[c for _, c in trace]}; converged cost {converged!r} after {TTT_STEPS} steps")


def phase_measurement_scripts():
    """The four measurement scripts through their main(), counts set to 0
    just before and read just after; returns launches per record entry."""
    from thallo_tpu_torch.ops import loopfloor

    import torch_fused_pair_micro
    import torch_fused_variants
    import torch_loop_floor
    import torch_redesign_sweep

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    argv = ["--n", str(SCRIPT_LAUNCHES)]
    with tally(loopfloor, "add_one", lambda x, tiles=1: tiles) as by_tiles:
        for script in (torch_fused_pair_micro, torch_fused_variants, torch_loop_floor,
                       torch_redesign_sweep):
            if script.main(argv) != 0:
                raise AssertionError(f"{script.__name__} failed")
    torch.cuda.synchronize()
    launches = {n: fns[n].launches for n, (_, _, path) in KERNELS.items()
                if path == "measurement" and n in fns}
    launches["loop_floor_add_one"] = by_tiles[1]
    launches["loop_floor_add_one_grid64"] = by_tiles[64]
    log(f"measurement scripts launches {launches}")
    missing = [n for n, k in launches.items() if k <= 0]
    if missing:
        raise AssertionError(f"measurement scripts: kernels never launched: {missing}")
    return launches


def arap_kernel_cases(dev, rng, bsr):
    """fused_pair_apply_atomics (and, for the record, its plain version)
    at the level shapes of ARAP 256²'s reg group: each (3, 3) col pair's
    table ([4, 65 536] element ids) with seeded blocks, pcol and prow."""
    from thallo_tpu_torch.ops import fusedpair

    S = ARAP_SIDE * ARAP_SIDE
    cases = []
    levels = [bsr.cols[bsr.col_gathers[pr[3]][0]] for pr in bsr.pairs if pr[2] == "col"]
    log("ARAP 256² reg levels (W, N_t): " + ", ".join(str(tuple(c.shape)) for c in levels))
    for k, ids in enumerate(levels):
        W, N = ids.shape
        a = _pair_args(lambda x: torch.from_numpy(x).to(dev), rng, ids, Ci=3, Cj=3, S=S)
        cases.append(("fused_pair_apply_atomics", "arap256" if k == 0 else f"arap256_{k}",
                      lambda a=a: fusedpair.fused_pair_apply_atomics(*a, Ci=3, Cj=3, S=S),
                      lambda a=a: fusedpair.fused_pair_apply_reference(*a, Ci=3, Cj=3, S=S),
                      None, nbytes(*a), 4 * W * N * 9, None))
    return cases


# the kernel wrappers the block-sparse solver calls (f32 blocks), by their
# names in solver/blocksparse.py
SOLVER_KERNELS = ("oh_setup_products", "fullrepeat_setup", "fused_pair_apply",
                  "fused_pair_apply_atomics", "fused_pair_apply_wloop",
                  "fused_pair_apply_wloop_chunked")


def path_calls(plan):
    """The solver's kernel calls in one step of `plan`: [(kernel, args,
    kwargs)], each (kernel, table, recipe and shape) once, in the order of
    the first call."""
    from thallo_tpu_torch.solver import blocksparse

    calls = {}

    def record(name):
        def key(*args, **kwargs):
            table = args[2] if name == "oh_setup_products" else args[0]
            k = (name, table.data_ptr() if name != "fullrepeat_setup" else None,
                 tuple(tuple(a.shape) for a in args), tuple(sorted(kwargs.items())))
            calls.setdefault(k, (name, args, kwargs))
        return key

    with contextlib.ExitStack() as stack:
        for name in SOLVER_KERNELS:
            stack.enter_context(tally(blocksparse, name, record(name)))
        plan.step()
        if torch.device(plan.compiled.device).type == "cuda":
            torch.cuda.synchronize()
    return list(calls.values())


def _recipe_outputs(recipe):
    """The output rows of an oh_setup_products or fullrepeat_setup recipe."""
    return sum(e[2] if e[0] in ("jtr", "d2") else e[2] * e[4] for e in recipe)


def path_kernel_cases(dev, rng, tag, calls):
    """Cases of the kernels `calls` (path_calls) launched, at their shapes,
    recipes and tables (ids as the path gave them), on seeded normal values
    of the same shapes; each held to KERNEL_TOL x max|ref|."""
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup

    def normal(x):
        return torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(dev)

    cases, seen = [], collections.Counter()
    for name, args, kw in calls:
        seen[name] += 1
        ctag = f"{tag}_{seen[name] - 1}"
        if name == "oh_setup_products":
            a = (normal(args[0]), normal(args[1]), args[2])
            rc, R = a[0].shape
            fn, ref = ohsetup.oh_setup_products, ohsetup.oh_setup_products_reference
            cases.append((name, ctag, lambda a=a, fn=fn, kw=kw: (fn(*a, **kw),),
                          lambda a=a, ref=ref, kw=kw: (ref(*a, **kw),), None, nbytes(*a),
                          _recipe_outputs(kw["recipe"]) * rc * 2 * R, None))
        elif name == "fullrepeat_setup":
            a = (normal(args[0]), normal(args[1]))
            rc, R = a[0].shape

            def run(fn, a=a, kw=kw):
                agg, crosses = fn(*a, **kw)
                return (agg, *crosses)

            cases.append((name, ctag, lambda run=run: run(fullrepeat.fullrepeat_setup),
                          lambda run=run: run(fullrepeat.fullrepeat_setup_reference), None,
                          nbytes(*a), _recipe_outputs(kw["recipe"]) * rc * 2 * R, None))
        else:
            a = (args[0], normal(args[1]), normal(args[2]), normal(args[3]))
            W, N = a[0].shape
            cases.append((name, ctag, lambda a=a, fn=getattr(fusedpair, name), kw=kw: fn(*a, **kw),
                          lambda a=a, kw=kw: fusedpair.fused_pair_apply_reference(*a, **kw),
                          None, nbytes(*a), 4 * W * N * kw["Ci"] * kw["Cj"], None))
        log(f"{name}[{ctag}] from the path: " + ", ".join(
            f"{tuple(x.shape)}" for x in args) + f", {kw}")
    return cases


def model_kernel_cases(dev, rng, tt):
    """The kernels phases 15 and 17 launch, at the shapes, recipes and
    tables of their plans on the card (one step each): the graph models
    above the dense threshold and the io samples."""
    from thallo_tpu_torch.models.cases import CASES

    makes = {f"{name}_big": (lambda d, name=name: model_plan(tt, name, d, True))
             for name in sorted(CASES) if CASES[name][1] is not None}
    makes.update({"io_" + label.split()[0].split(".")[0]: make
                  for label, make in io_plans(tt).items()})
    cases = []
    for tag, make in makes.items():
        cases += path_kernel_cases(dev, rng, tag, path_calls(make("cuda")))
    return cases


def arap_plan(tt, side, order, device, n_iter=ARAP_STEPS, l_iterations=ARAP_L_ITERATIONS,
              inputs=None):
    """A GN plan of ARAP (models/arap_mesh_deformation.py) at `side`, edges
    in the generator's order ("grouped") or shuffle_edges(seed=0)'s
    ("shuffled"), or of the given (inputs, dims); initialised."""
    from thallo_tpu_torch.models import arap_mesh_deformation as arap

    if inputs is None:
        ins = arap.synthetic_inputs(side=side)
        if order == "shuffled":
            ins = arap.shuffle_edges(ins, seed=0)
        inputs = (ins, {"N": side * side, "E": len(ins["V0"])})
    ins, dims = inputs
    plan = tt.load_energy(arap.ENERGY).plan(dims, solver="gauss_newton", device=device)
    plan.set_solver_parameter("nIterations", n_iter)
    plan.set_solver_parameter("lIterations", l_iterations)
    plan.init({k: np.copy(v) for k, v in ins.items()})
    return plan


def bsr_kernels(plan):
    """The kernels a plan's block-sparse tables launch on the card: each
    col level's fused_pair_route kernel, oh_setup_products for one-hot
    rows, fullrepeat_setup for full-repeat tables."""
    out = set()
    for c in plan._prep["consts"]:
        bsr = c["bsr"]
        if bsr is None:
            continue
        out |= set(level_routes(bsr).values())
        if any(x is not None for x in bsr.oh_idxs):
            out.add("oh_setup_products")
        if any(bsr.full_repeat):
            out.add("fullrepeat_setup")
    return out


def card_vs_cpu(label, make, steps, u_tol=STEP_U_TOL, cost_rtol=STEP_COST_RTOL):
    """`steps` steps of make(device) on the card and on the CPU, each read
    after the step; the card's kernel counts set to 0 just before its run
    and read just after.  Holds unknowns and costs card vs CPU (costs below
    MODEL_COST_FLOOR x the initial cost are noise); returns (card launches,
    card costs, the card plan)."""
    fns = counters()
    runs = {}
    for device in ("cuda", "cpu"):
        plan = make(device)
        for fn in fns.values():
            fn.launches = 0
        costs, Us = [plan.final_cost], []
        for _ in range(steps):
            plan.step()
            costs.append(plan.final_cost)
            Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = (costs, Us, {n: fn.launches for n, fn in fns.items()}, plan)
    (cg, Ug, lg, plan), (cc, Uc, _, _) = runs["cuda"], runs["cpu"]
    launched = {n: k for n, k in lg.items() if k}
    log(f"{label} costs cuda {cg}")
    log(f"{label} costs cpu  {cc}")
    log(f"{label} card launches {launched}")
    check_steps(f"{label} cuda vs cpu", cg, Ug, cc, Uc, u_tol, cost_rtol,
                MODEL_COST_FLOOR * abs(cc[0]))
    if not cg[-1] < cg[0]:
        raise AssertionError(f"{label}: the cost did not fall on the card")
    return lg, cg, plan


def model_plan(tt, name, device, big):
    """The port's plan of thallo_tpu_torch/models/cases.py's CASES[name],
    Q-ratio stop off, initialised."""
    from thallo_tpu_torch.models.cases import model_case

    m, inputs, dims, solver, l_iterations = model_case(name, big)
    plan = tt.load_energy(m.ENERGY).plan(dims, solver=solver, device=device)
    plan.set_solver_parameter("lIterations", l_iterations)
    plan.set_solver_parameter("q_tolerance", -1.0)
    plan.set_solver_parameter("nIterations", MODEL_STEPS)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    return plan


def iw_tableless_plan(tt, n, directive, device):
    """image_warping at n x n with JᵀJ.<directive>(True) on every residual
    (a pure-stencil group without tables: JAX's J-block path above the
    dense threshold, the dense JᵀJ below), 20 PCG iterations, the Q-ratio
    stop off."""
    from thallo_tpu_torch.models import image_warping as iw

    names = [nr.name for nr in tt.load_energy(iw.ENERGY).energy]
    text = iw.ENERGY + "".join(f"\nr.{k}.JtJ.{directive}(True)" for k in names) + "\n"
    plan = tt.load_energy(text).plan({"W": n, "H": n}, solver="levenberg_marquardt",
                                     device=device)
    plan.set_solver_parameter("lIterations", 20)
    plan.set_solver_parameter("q_tolerance", -1.0)
    plan.set_solver_parameter("nIterations", MODEL_STEPS)
    plan.init(iw.synthetic_inputs(n, n))
    if plan._prep["consts"][0]["bsr"] is not None:
        raise AssertionError(f"image_warping {n}² {directive}: a stencil group built tables")
    return plan


def phase_models(tt):
    """Phase 15: every copied model, then image_warping's table-less
    materialized-JᵀJ cases, card vs CPU; each block-sparse plan's routed
    kernels must have launched, and sparse_bundle_fusion must have
    launched one kernel at least.  Returns the card launches per run."""
    from thallo_tpu_torch.models.cases import CASES

    runs = {}
    for name in sorted(CASES):
        big = CASES[name][1] is not None
        u_tol, c_tol = MODEL_TOL.get(name, (STEP_U_TOL, STEP_COST_RTOL))
        label = f"model {name}" + (" (above the dense threshold)" if big else "")
        t0 = time.perf_counter()
        lg, _, plan = card_vs_cpu(label, lambda d: model_plan(tt, name, d, big), MODEL_STEPS,
                                  u_tol, c_tol)
        want = bsr_kernels(plan)
        log(f"{label}: block-sparse kernels {sorted(want)}, {time.perf_counter() - t0:.2f} s")
        missing = [n for n in want if lg[n] <= 0]
        if missing:
            raise AssertionError(f"{label}: routed kernels never launched: {missing}")
        if name == "sparse_bundle_fusion" and not any(lg.values()):
            raise AssertionError(f"{label}: no kernel launched")
        runs[f"model {name}"] = lg
    for n, directive in TABLELESS_IW:
        lg, _, _ = card_vs_cpu(f"image_warping {n}² JtJ.{directive}",
                               lambda d: iw_tableless_plan(tt, n, directive, d), MODEL_STEPS,
                               GRID_U_TOL, GRID_COST_TOL)
        runs[f"image_warping {n}² {directive}"] = lg
    return runs


def phase_arap_256(tt):
    """Phase 16: ARAP 256², GN, lIterations ARAP_L_ITERATIONS, in both edge
    orders: warmup(), run_steps(1) three times, run_steps(7); the costs
    after steps 0-3 and 10 within ARAP_TRAJ_RTOL of the JAX package's f32
    trajectory and of the other order's; after step 3 the cost, -JᵀF,
    diag(JᵀJ) and JᵀJ·p of a seeded p against the port's CPU path at the
    same unknowns (GRID_LINEAR_RTOL); fused_pair_apply_atomics launched
    (and no other fused-pair kernel).  Logs the step median of steps 2-10,
    its launches per step and per PCG iteration, and the marginal cost of
    one PCG iteration.  Returns the launches of each order's 10 steps."""
    fns = counters()
    runs, traj = {}, {}
    for order in ("grouped", "shuffled"):
        label = f"ARAP {ARAP_SIDE}² GN {order}"
        t0 = time.perf_counter()
        n_iter = ARAP_STEPS + 2 * (1 + ARAP_MARGINAL_STEPS)
        plan = arap_plan(tt, ARAP_SIDE, order, "cuda", n_iter)
        torch.cuda.synchronize()
        log(f"{label}: init {time.perf_counter() - t0:.3f} s, initial cost {plan.final_cost!r}, "
            f"residual sort {sorted(plan._residual_perms)}")
        t0 = time.perf_counter()
        plan.warmup()
        log(f"{label}: warmup {time.perf_counter() - t0:.3f} s")
        for fn in fns.values():
            fn.launches = 0
        costs, step_s = [plan.final_cost], []
        for _ in range(3):
            t0 = time.perf_counter()
            plan.run_steps(1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            costs.append(plan.final_cost)
        rng = np.random.default_rng(13)
        p = {k: rng.normal(size=tuple(v.shape)).astype(np.float32) for k, v in plan._U.items()}
        solve_launches = {n: fn.launches for n, fn in fns.items()}
        got = linear_parts(plan, p)
        cpu_plan = arap_plan(tt, ARAP_SIDE, order, "cpu")
        cpu_plan._U = {k: v.cpu() for k, v in plan._U.items()}
        ref = linear_parts(cpu_plan, p)
        del cpu_plan
        for n, fn in fns.items():
            fn.launches = solve_launches[n]  # the check's own apply is not the solve's
        rel = abs(got[0] - ref[0]) / abs(ref[0])
        log(f"{label}, step 3, card vs CPU: cost {got[0]!r} vs {ref[0]!r}, rel {rel:.3e}")
        if not rel <= GRID_LINEAR_RTOL:
            raise AssertionError(f"{label}: cost at step 3, card {got[0]} vs CPU {ref[0]}")
        for what, a, b in zip(("-JᵀF", "diag(JᵀJ)", "JᵀJ·p"), got[1:], ref[1:]):
            for name in b:
                err = float(np.abs(a[name] - b[name]).max())
                scale = float(np.abs(b[name]).max())
                log(f"{label}, step 3, card vs CPU: {what} {name} max|diff| {err:.3e} "
                    f"= {err / scale:.3e} x max|ref|")
                if not err <= GRID_LINEAR_RTOL * scale:
                    raise AssertionError(f"{label}: {what} of {name} at step 3, card vs CPU, "
                                         f"{err} > {GRID_LINEAR_RTOL} x {scale}")
        t0 = time.perf_counter()
        n = plan.run_steps(ARAP_STEPS - 3)
        torch.cuda.synchronize()
        batch = time.perf_counter() - t0
        costs.append(plan.final_cost)
        launches = {name: fn.launches for name, fn in fns.items()}
        runs[f"arap256 {order}"] = launches
        if n != ARAP_STEPS - 3 or plan.num_iterations != ARAP_STEPS:
            raise AssertionError(f"{label}: run_steps ran {n} steps, {plan.num_iterations} in all")
        per_step = step_s[1:] + [batch / n] * n
        atomics = launches["fused_pair_apply_atomics"]
        log(f"{label} costs after steps 0-3 and {ARAP_STEPS}: {costs}")
        log(f"{label} step times: steps 1-3 {[round(t * 1e3, 2) for t in step_s]} ms, steps 4-"
            f"{ARAP_STEPS} one run_steps({n}) batch {batch * 1e3:.2f} ms; median of steps 2-"
            f"{ARAP_STEPS} {float(np.median(per_step)) * 1e3:.2f} ms")
        log(f"{label} launches over {ARAP_STEPS} steps {({k: v for k, v in launches.items() if v})}"
            f"; fused_pair_apply_atomics {atomics / ARAP_STEPS:.1f} a step, "
            f"{atomics / (ARAP_STEPS * ARAP_L_ITERATIONS):.2f} a PCG iteration")
        stray = [k for k, v in launches.items() if v and k != "fused_pair_apply_atomics"
                 and k.startswith("fused_pair")]
        if atomics <= 0 or stray:
            raise AssertionError(f"{label}: fused_pair_apply_atomics launched {atomics} times, "
                                 f"other fused-pair kernels {stray}")
        for name, U in plan.unknowns().items():
            if not bool(torch.isfinite(U).all()):
                raise AssertionError(f"{label}: non-finite unknowns {name}")
        traj[order] = dict(zip((0, 1, 2, 3, ARAP_STEPS), costs))
        for k, tol in ((0, GRID_LINEAR_RTOL),) + tuple(ARAP_TRAJ_RTOL.items()):
            ref_k = ARAP_JAX_COSTS[order][k]
            rel = abs(traj[order][k] - ref_k) / abs(ref_k)
            log(f"{label} step {k}: cost {traj[order][k]!r} vs JAX {ref_k!r}, rel {rel:.3e} "
                f"(limit {tol})")
            if not (np.isfinite(traj[order][k]) and rel <= tol):
                raise AssertionError(f"{label}, step {k}: cost {traj[order][k]} vs JAX {ref_k}")
        # the marginal PCG iteration (bench.py:306-330): whole steps at two
        # lIterations, one warm step before each timed batch
        times, counts = {}, {}
        for li in ARAP_MARGINAL:
            plan.set_solver_parameter("lIterations", li)
            plan.run_steps(1)
            torch.cuda.synchronize()
            n0 = fns["fused_pair_apply_atomics"].launches
            t0 = time.perf_counter()
            plan.run_steps(ARAP_MARGINAL_STEPS)
            torch.cuda.synchronize()
            times[li] = (time.perf_counter() - t0) / ARAP_MARGINAL_STEPS
            counts[li] = (fns["fused_pair_apply_atomics"].launches - n0) / ARAP_MARGINAL_STEPS
        lo, hi = ARAP_MARGINAL
        log(f"{label} marginal PCG iteration: step {times[lo] * 1e3:.3f} ms at lIterations {lo}, "
            f"{times[hi] * 1e3:.3f} ms at {hi}: {(times[hi] - times[lo]) / (hi - lo) * 1e3:.4f} "
            f"ms an iteration, fused_pair_apply_atomics "
            f"{(counts[hi] - counts[lo]) / (hi - lo):.2f} launches an iteration")
    for k, tol in ARAP_TRAJ_RTOL.items():
        a, b = traj["shuffled"][k], traj["grouped"][k]
        rel = abs(a - b) / abs(b)
        log(f"ARAP {ARAP_SIDE}² GN step {k}: shuffled {a!r} vs grouped {b!r}, rel {rel:.3e}")
        if not rel <= tol:
            raise AssertionError(f"ARAP {ARAP_SIDE}², step {k}: the edge orders differ: {a} vs {b}")
    return runs


def io_plans(tt):
    """label -> make(device): the committed samples read by the port's io
    readers, as plans: examples/data/sample_scene.bal.txt as bundle
    adjustment (LM, lIterations 10) and sample_mesh.ply as ARAP (GN,
    tests/test_io.py's pull), MODEL_STEPS steps, the Q-ratio stop off."""
    from thallo_tpu_torch import io
    from thallo_tpu_torch.models import bundle_adjustment as ba

    data = Path(__file__).resolve().parent / "examples" / "data"
    bal = io.bal_to_inputs(str(data / "sample_scene.bal.txt"))
    verts, faces, _ = io.load_ply(str(data / "sample_mesh.ply"))
    pull = {0: verts[0] + np.array([0, 0, 0.5], np.float32), len(verts) - 1: verts[-1]}
    mesh = io.mesh_to_arap_inputs(verts, faces, constraints=pull)

    def bal_plan(device):
        plan = ba_plan(ba, tt, *bal, device, MODEL_STEPS)
        plan.set_solver_parameter("q_tolerance", -1.0)
        plan.init({k: np.copy(v) for k, v in bal[0].items()})
        return plan

    def ply_plan(device):
        plan = arap_plan(tt, None, None, device, MODEL_STEPS, inputs=mesh)
        plan.set_solver_parameter("q_tolerance", -1.0)
        return plan

    return {"sample_scene.bal.txt (BA)": bal_plan, "sample_mesh.ply (ARAP)": ply_plan}


def phase_io(tt):
    """Phase 17: io_plans' samples solved card vs CPU; each block-sparse
    plan's routed kernels must have launched."""
    runs = {}
    for label, make in io_plans(tt).items():
        lg, _, plan = card_vs_cpu(f"io: {label}", make, MODEL_STEPS)
        missing = [n for n in bsr_kernels(plan) if lg[n] <= 0]
        if missing:
            raise AssertionError(f"io: {label}: routed kernels never launched: {missing}")
        runs[f"io {label.split()[0]}"] = lg
    return runs


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))  # torch_measure etc.
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    log(f"HBM peak of this card: {hbm_peak()} (bounds below use {HBM_BYTES_PER_S:.3e} B/s)")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    for line in open(f"{path}.log"):
        if line.startswith("==") or "entry function" in line or "registers" in line \
                or "spill" in line:
            log(line.rstrip())
    log(f"phase 1 build {path.name}: {time.perf_counter() - t0:.2f} s")

    scene = make_scene(ba, *BA_1M)
    skew_scene = make_skew_scene(ba, *SKEW_1M)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    record = {}
    cases = kernel_cases(dev, rng, scene[0], skew_scene[0]["oToC"])
    cases += skew_kernel_cases(dev, rng, skew_tables(ba, tt, skew_scene))
    cases += measurement_kernel_cases(dev, rng)
    arap_reg = arap_plan(tt, ARAP_SIDE, "grouped", "cuda")._prep["consts"][1]["bsr"]
    cases += arap_kernel_cases(dev, rng, arap_reg)
    cases += model_kernel_cases(dev, rng, tt)
    for name, tag, kern, plain, lib, in_bytes, flops, terms in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = compare(f"{name}[{tag}]", got, ref, terms() if terms else None)
        ms, dev_ms = timed_ms(kern, 20), device_ms(kern)
        plain_ms = timed_ms(plain, 5)
        lib_ms = lib_dev_ms = None
        if lib is not None:
            lib_ms, lib_dev_ms = timed_ms(lib, 20), device_ms(lib)
        moved = in_bytes + nbytes(*got)
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        lib_txt = (f", library {lib_ms:.4f} ms (device {lib_dev_ms:.4f})"
                   if lib is not None else "")
        log(f"{name}[{tag}]: max|err| {err:.3e}, kernel {ms:.4f} ms (device {dev_ms:.4f}), "
            f"plain {plain_ms:.4f} ms{lib_txt}, bound {bound_ms:.4f} ms "
            f"({moved / 1e6:.1f} MB, {flops / 1e6:.1f} MFLOP)")
        if (name, tag) in RECORD:
            record[RECORD[name, tag]] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                                         "bound_by": "bytes" if bytes_ms >= ops_ms
                                         else "operations",
                                         "library_ms": lib_ms,
                                         "library_device_ms": lib_dev_ms}
    del cases, got, ref
    torch.cuda.synchronize()
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_small_scene(ba, tt)
    phase_small_skew(ba, tt)
    phase_small_grid()
    log(f"phase 3 small scenes cuda vs cpu: {time.perf_counter() - t0:.2f} s")

    runs = {}
    t0 = time.perf_counter()
    runs["block-sparse"], f32_final = phase_ba_1m(ba, tt, scene)
    torch.cuda.synchronize()
    log(f"phase 4 BA 1M LM solve, block-sparse JᵀJ: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs["precompute_j"], ref = phase_precompute_j(ba, tt, scene)
    torch.cuda.synchronize()
    log(f"phase 5 BA 1M LM solve, PRECOMPUTE_J: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs["apply_separately_tiled"] = phase_apply_separately_tiled(ba, tt, scene, ref)
    torch.cuda.synchronize()
    log(f"phase 6 BA 1M LM solve, APPLY_SEPARATELY + THALLO_SEGSUM=tiled: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs["skew block-sparse"] = phase_skew_1m(ba, tt, skew_scene)
    torch.cuda.synchronize()
    log(f"phase 7 skewed BA 1M LM solve, block-sparse JᵀJ over level tables: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs["measurement"] = phase_measurement_scripts()
    log(f"phase 8 measurement scripts: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs["bf16 block-sparse"] = phase_ba_1m_bf16(ba, tt, scene, f32_final)
    torch.cuda.synchronize()
    log(f"phase 9 BA 1M LM solve, block-sparse JᵀJ, block_dtype=bf16: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs["skew bf16 block-sparse"] = phase_skew_1m(ba, tt, skew_scene, block_dtype="bf16",
                                                   n_steps=BF16_SKEW_STEPS)
    torch.cuda.synchronize()
    log(f"phase 10 skewed BA 1M LM solve, block_dtype=bf16, {BF16_SKEW_STEPS} steps: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_grid_512()
    torch.cuda.synchronize()
    log(f"phase 11 image_warping {GRID_SIZE}x{GRID_SIZE} GN through run_steps: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_schur_small(ba, tt)
    torch.cuda.synchronize()
    log(f"phase 12 Schur solves on small scenes, cuda vs cpu: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_schur_1m(ba, tt, scene)
    torch.cuda.synchronize()
    log(f"phase 13 BA 1M LM solve, schur_pcg and schur_dense: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_schur_skew_1m(ba, tt, skew_scene)
    phase_time_to_target(ba, tt, scene)
    torch.cuda.synchronize()
    log(f"phase 14 skewed BA 1M LM solve, schur_pcg; time to target: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model_runs = phase_models(tt)
    torch.cuda.synchronize()
    log(f"phase 15 the copied models, cuda vs cpu: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model_runs.update(phase_arap_256(tt))
    torch.cuda.synchronize()
    log(f"phase 16 ARAP {ARAP_SIDE}² GN, both edge orders: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model_runs.update(phase_io(tt))
    torch.cuda.synchronize()
    log(f"phase 17 the io readers' samples, cuda vs cpu: {time.perf_counter() - t0:.2f} s")
    runs.update(model_runs)

    # launches on the run named beside each kernel (a solve, or phase 8),
    # and on each run of phases 15-17 that launched it
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep, "path": path,
                "launches": runs[path][name], **record[name],
                "model_runs": {run: n[name] for run, n in model_runs.items() if n.get(name)}}
               for name, (src, rep, path) in KERNELS.items()]
    log(f"total {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
