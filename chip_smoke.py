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
     shape; the atomics route's two bodies (the slots kernel,
     fused_pair_apply_atomics[_f64], and the first body,
     fused_pair_apply_atomics_thread[_f64]) at ARAP 256²'s (3, 3) levels
     in both edge orders and at every atomics-route call of a path below,
     f32 and f64; the ring segment sum and the first staged body
     (segment_sum_per_chunk[_f64], on its own 2048-row plan) at the
     camera map in f32 and f64, the ring kernel launched twice for the
     same bits; the bf16 slots kernel (fused_pair_apply_atomics_bf16)
     beside the first bf16 body (fused_pair_bf16_atomics) at ARAP 256²'s
     (3, 3) levels in both edge orders and at wide levels of 9 and 16
     row channels (BF16_WIDE); every kernel phases 15 and 17 launch, at
     the shapes, recipes and tables of one step of that plan on the card:
     model_kernel_cases, the block-sparse plans and the fixed-order segment
     sum (segment_sum_fixed_order, one launch) of the contraction and
     sampled-image models' stored-Jacobian scatters, each beside its first
     body (segment_sum on the plan the earlier rule built: in order
     up to runs of 32, else sorted runs), the aggregation kernel and
     index_add_ on the same values, bundle_fusion above the dense threshold (CASES' larger
     size) and embedded deformation under block_dtype="bf16") and at a small ragged
     shape with out-of-range ids or padded plan lanes; kernel, plain and
     library times in ms, each kernel and library call twice: `ms` over
     20 eager calls (host and device) and `device_ms` over the same call
     captured 10 times in one CUDA graph and replayed (the device alone; everything under 50 MB is
     warm in L2 there, as the solver's caller finds pcol and the plans,
     while the 108 MB of blocks stay cold).  At every fused-pair shape
     (uniform W = 4, the skewed levels) the pair is timed six ways: the
     persistent kernel (fused_pair_apply), the two global-atomics bodies
     (fused_pair_apply_atomics, the slots kernel, and
     fused_pair_apply_atomics_thread, the first body), the persistent W-loop kernel
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
     block-Jacobi ones there), steps 2-5 of the uniform scene within
     SCHUR_TRAJ plus SCHUR_COST_FLOOR x the initial cost, of the skewed
     scene within phase 24's rule over the card's own runs (two, twelve
     where the first two differ; SCHUR_TRAJ the floor, plus
     SCHUR_COST_FLOOR x c0), each run's LM accepts logged, costs never
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
 15. the sixteen copied models (thallo_tpu_torch/models/cases.py's
     CASES; the five graph models above the 4096-unknown dense threshold,
     on block-sparse tables, the rest, the five contraction and
     sampled-image models among them, at tests/test_models*.py's sizes),
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
     launched (the reg group's two (3, 3) col pairs, the slots kernel)
     and no other fused pair, each body's launches logged; logs the step median, its launches per step and per PCG
     iteration, and the marginal cost of a PCG iteration (lIterations 10
     against 110);
 17. the io readers: examples/data/sample_scene.bal.txt (io/bal.py) as
     bundle adjustment and sample_mesh.ply (io/ply.py) as ARAP, card vs
     CPU as in phase 15;
 18. deconvolution at 512² with the reference's 15 x 15 kernel
     (make_spec(k_half=7), synthetic_inputs(512, 512, k_half=7): 262 144
     unknowns, 225 taps a pixel), GN, nIterations 6, lIterations 40
     (examples/deconvolution.py): the contraction blocked as JAX blocks it
     (FULL_CON_BLOCK); at the initial unknowns the cost, -JᵀF, diag(JᵀJ)
     and JᵀJ·p card vs the port's CPU path (GRID_LINEAR_RTOL); warmup(),
     run_steps(1) per step, the costs within FULL_TRAJ_RTOL of JAX's
     trajectory; logs the step median, the peak memory beside the
     unblocked fiber, one profiled step's device busy time and the blocked
     contraction's share of it;
 19. optical_flow at 512² (synthetic_inputs(512, 512, shift=(0.75,
     -0.4))), LM, lIterations 15, 10 steps, the Q-ratio stop off: the same
     checks and logs;
 20. double_precision at full width: (a) the uniform 1M LM solve, 10
     steps, through the f64 oh_setup_products, fullrepeat_setup and
     persistent fused pair (each launched, no f32 kernel), costs never
     rising, final <= 1e-2 x initial beside phases 4 and 9, the step
     median and peak memory, the linear parts at the initial unknowns card
     vs the port's CPU path in f64 (F64_LINEAR_RTOL); (b) ARAP 256² GN in
     f64 through the f64 atomics body fused_pair_route names (the first
     body, fused_pair_apply_atomics_thread_f64; each body's launches
     logged), its costs against JAX's f64
     run (ARAP_JAX_F64_COSTS, ARAP_F64_RTOL); (c) phase 12's small skewed
     schur_dense scene in f64 card vs CPU, the split far below
     SCHUR_COST_FLOOR; (d) the uniform 1M LM solve under PRECOMPUTE_J in
     f64, 10 steps, its camera scatters through oh_setup_aggregate_f64,
     its first 3 steps against the f64 block-sparse solve (F64_CROSS);
     (e) a parity check at test size: deconvolution 16² and face_fitting
     in f64 card vs CPU through the fixed-order segment sum's f64
     instantiation, segment_sum_fixed_order_f64 (F64_MODELS).
     Phase 2 holds each f64 instantiation against its plain f64 version
     at the shapes, recipes and tables of (a), (b) and (d), taken from
     one step of each plan (F64_KERNEL_TOL);
 21. Plan.jacobian: the small BA scene and image_warping 64² with its
     excluded square, COO card vs CPU; at the uniform 1M scene Jᵀr from
     the COO against the solver's -JᵀF (JAC_TOL), the COO's size logged;
 22. the drivers (thallo_tpu_torch/examples): run_model on a grid, a
     graph and a BA model, every gallery row (synthetic and the BAL and
     PLY samples) with its cost falling, get_performance_summary() at
     timing levels 1 and 2; compile_check (utils/compile_check.py) on
     ARAP's energy at its default dims, on the card by default;
 23. scheduling, each against an empty measurement store of its own in a
     temporary directory: (a) the uniform 1M LM solve under
     use_autoscheduler=1 (the heuristic's estimates, resident bytes and
     choice logged), 10 steps, never rising, final <= 1e-2 x initial, one
     profiled step; (b) 3 steps each of LINEARIZE (use_autoscheduler=2)
     and INLINE (exhaustive candidate 1), of INLINE under
     THALLO_SEGSUM=tiled and of INLINE tiled in f64, against phase 5's
     PRECOMPUTE_J run (the same scalar Jacobi; SCHED_BA_TRAJ) or phase
     20(d)'s (F64_CROSS): their camera transposes through
     oh_setup_aggregate, under tiled every transpose through segment_sum
     (segment_sum_f64 in f64), tallied by plan, each body's launches
     logged (the ring kernel on the camera plans); step medians, one
     profiled step each; (c) ARAP 256² GN, lIterations 10: use_autoscheduler=2
     against the default plan under scalar Jacobi (ARAP_TRAJ_RTOL), then
     autoschedule_search over the first SCHED_ARAP_CANDIDATES candidates
     (every (fit, reg) schedule pair), n_steps 3, each candidate's
     measured ms beside its estimated bytes and their rank correlation,
     every candidate's cost held to the reference run of its
     preconditioner (SCHED_ARAP_RTOL), and use_autoscheduler=1 reading
     that store picks the measured winner.  Phase 2 holds segment_sum_f64
     at the uniform scene's two plans;
 24. steps_per_dispatch (a CUDA graph of the guarded step, replayed k
     times a dispatch) and the profiling: (a) the uniform 1M LM scene,
     run_steps(5) twice at k = 5 against DISPATCH_EAGER_RUNS (twelve)
     eager runs, unknowns (first call: after it LM's accepts split the
     runs into two cost modes) and cost (each call) within twice the eager
     runs' spread (DISPATCH_*), ms a step
     graphed and eager, one graphed dispatch profiled (device busy, idle
     share); (b) the skewed 1M scene, 4 steps at k = 2 (the W-loop pair
     inside the capture) against twelve eager runs by (a)'s rule; (c) ARAP 256² and image_warping 512² GN solve() at
     k = 10 and eagerly, final costs within phases 16 and 11's bounds of
     JAX's f32 runs, ms a step; (d) scripts/torch_dispatch_paths.py's
     paths (every path above at small size and the sixteen models): the
     graphed run within twice the eager runs' spread of the farthest of
     them (PATHS_EAGER_RUNS, five, eager runs where two differ or the
     graphed run differs from them, twelve on the small skewed scene and
     twenty on schur_dense GN; phase 3's floors), a replay under
     set_sync_debug_mode("error"), and no path may raise for k > 1 (GN's
     schur_dense captures: its eigendecomposition leaves cuSOLVER's info
     on the device, ops/linalg.py); (e) kernel_stats(interior=True) on the uniform 1M plan naming
     the hand-written kernels (INTERIOR_KERNELS), and a timing_level=3
     solve of ARAP 256² filling the six probe rows; (f) one 1M step under
     trace_dir, the trace naming the three phases and a hand-written
     kernel; (g) roofline() of ARAP 256²'s marginal PCG iteration, eager
     and graphed (hbm_fraction <= ROOFLINE_MAX); (h) deconvolution 16²:
     two card runs bit-identical after step 1 (the in-order scatter);
 25. the sharded path (thallo_tpu_torch/parallel) on a one-rank NCCL
     group (tcp://localhost on a free port, destroyed at the end): (a) the
     uniform 1M LM scene sharded at {"P", "O"}, (b) ARAP 256² GN with
     edges sorted by owner at {"N", "E"}, each through SHARD_CALLS calls
     of run_steps(SHARD_K) held after each call against unsharded eager
     runs by phase 24(a)'s rule and function (hold_vs_eager: BA's unknowns
     at the first call, as 24(a)'s; two eager runs and bit for bit where
     all agree bit for bit, else DISPATCH_EAGER_RUNS of them and twice
     their spread), the collectives
     of one step (counts and bytes a kind; ARAP's all_reduce bytes at most
     SHARD_MAX_ALL_REDUCE) and the ms a step sharded and unsharded
     logged, each block-sparse kernel of the sharded plan launched; (c)
     the same scenes at steps_per_dispatch = SHARD_K, the NCCL collectives
     inside the CUDA graph, by the same rule against the same eager runs;
     (d) is phase 24(d)'s; (e) with two cards or more,
     scripts/torch_sharded_solve.py --ranks 2 --scene ba, its cost after
     SHARD_K steps within STEP_COST_RTOL of the range of (a)'s unsharded
     runs there, else logged as not run (NCCL refuses two ranks on one
     card).
 26. the port's last modules: (a) image_warping 512² GN (phase 11's
     plan) sharded at {"W": "x", "H": "y"} on a (1, 1) mesh of a one-rank
     NCCL group, halo-extended blocks on both dims (width 1), SHARD_CALLS
     calls of run_steps(SHARD_K) eager and at steps_per_dispatch SHARD_K,
     held against unsharded eager runs by hold_vs_eager; the collectives
     of one step by kind and bytes (no all_gather, a collective_permute)
     and the ms a step logged; (b) deconvolution 512² (phase 18's plan,
     blocked (Kd, 3, 5)) sharded at {"W": "x"}, GRID_SHARD_DC_STEPS eager
     steps by the same rule, its halo width FULL_CON_HALO; (c) the port's
     C API built by make (thallo_tpu_torch/capi), the uniform 1M scene
     written as a BAL file (io.bal.save_bal) and solved by ``bal_solve
     --gpu`` (CAPI_STEPS LM steps of CAPI_L_ITERATIONS), its costs and
     solved unknowns held against eager Python runs of the same file
     (io.bal.bal_to_inputs) by phase 24's rule, then the library loaded
     into this process (ctypes.PyDLL) for the same run, which must launch
     CAPI_KERNELS; (d) ``python -m thallo_tpu_torch.cli`` on
     image_warping and bundle_adjustment with --device cuda --iters 3:
     exit 0, final below c0.
 27. ARAP 256² GN under block_dtype="bf16" (phase 16's plan, its two (3,
     3) col levels' crosses stored as bf16), both edge orders, as phase 16
     runs it: costs after steps 1-3 and 10 within ARAP_BF16_TRAJ_RTOL of
     the JAX package's bf16 trajectory (ARAP_JAX_BF16_COSTS) and of the
     other order's; after step 3 the linear parts card vs CPU
     (GRID_LINEAR_RTOL); fused_pair_apply_atomics_bf16 launched at both
     levels and no other fused pair; the step median, the launches, and
     the marginal PCG iteration eager (beside phase 16's f32 value) and
     graphed (steps_per_dispatch ARAP_MARGINAL_STEPS, bf16 beside f32 in
     this phase).
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
# the f64 instantiations against their plain f64 versions: an f64 sum of
# n terms in another order moves by about 2^-53 sqrt(n) x their
# magnitudes; the hot outputs here sum ~1000 terms (a camera of the
# uniform 1M scene), 1e-12 x max|ref| is ~100x that and 1e7x below f32
F64_KERNEL_TOL = 1e-12
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
# SCHUR_TRAJ holds steps 1-5 of the uniform scene at about twice those.
# On the skewed scene (16 more card runs under schur_dense, --seeds 1
# --runs 16, reach 4.9e-3 and 4.6e-2; smoke runs failed at 5.2e-2 of the
# cost and at 5.73e-3 of max|U|) steps 2-5 take phase 24's rule instead:
# the CPU run within DISPATCH_SPREAD_X times the spread of the card's own
# runs (two, twelve where the first two differ), SCHUR_TRAJ the floor
# (hold_trajectory_by_spread); each run's LM accepts are logged.
SCHUR_TRAJ = {"small": (2e-4, 1e-2), "small skewed": (5e-3, 5e-2)}  # (x max|U|, cost)
# Near convergence the relative cost check reads rounding: an accept on
# one device against a reject on the other leaves the two LM runs at
# costs 5e-2 apart relative but 3e-7 of the initial cost apart (an
# earlier failed smoke run: 0.00333 against 0.00316, c0 10710).  Each step's cost
# is held to SCHUR_TRAJ's relative bound plus SCHUR_COST_FLOOR x the CPU
# run's initial cost.  Measured, 16 card runs against the CPU per
# preconditioner (scripts/torch_skew_small_spread.py --seeds 1 --runs 16
# --linear-solver schur_dense, H100 80GB HBM3, 700 W): in f32 the runs
# split by up to 5.06e-2 of the cost (one run of 32 beyond SCHUR_TRAJ's
# 5e-2) and by at most 1.95e-7 x c0; with --double by 2.5e-11 of the cost
# and 6.8e-15 x c0, so the f32 split is rounding, not a wrong step
# (phase 20(c) repeats that witness).  The floor is twice the largest f32
# split seen (3e-7 x c0) and below 1e-6: a step that moves the cost by
# more than 6e-7 of c0 still fails.
SCHUR_COST_FLOOR = 6e-7
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
# model stays within 2.0e-5 of max|U| (ARAP 48²) but deconvolution at
# 16² (a 5 x 5 kernel, GN, 40 PCG iterations): card vs CPU on an H100 its
# unknowns after step 1 lie 5.7e-6 to 2.6e-5 of max|X| in 30 of 32 runs,
# 2.0e-4 and 2.2e-4 in two, the costs within 2.2e-6 (scripts/
# torch_model_trajectory.py --model deconvolution --steps 3 --q-tolerance
# -1 --device cuda --against-cpu 8, then 24); with index_add_ in place of
# the aggregation kernel (--library-scatter, 24 runs) up to 8.8e-5.  Both
# scatters sum in a varying order, and 40 PCG iterations carry that into
# the directions the cost barely sees (the CPU's own unknowns, moved by
# 1e-7 x max|X|, move 9.1e-6 after step 1: --device cpu --perturb 1..4).
# (x max|U|, cost) bounds of the models that need their own, about twice
# the measured spread:
MODEL_TOL = {"shape_and_shading": (2e-3, STEP_COST_RTOL),
             "deconvolution": (5e-4, STEP_COST_RTOL)}
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
# phase 27: ARAP 256² under block_dtype="bf16" (its two (3, 3) levels'
# crosses stored as bf16); the JAX package's bf16 trajectories on a CPU,
# costs after steps 0-10:
#   JAX_PLATFORMS=cpu python3 scripts/torch_model_trajectory.py --package jax \
#       --block-dtype bf16 [--shuffle]
# Six bf16 runs of the port's CPU path, as is and with the unknowns moved
# by 1e-7 x max|U| (--package torch --device cpu --block-dtype bf16
# --perturb 1|2 [--shuffle]), lie at most 3.6e-6, 1.0e-5, 3.7e-5 and
# 6.7e-3 from JAX's run after steps 1, 2, 3 and 10 (the bf16 rounding
# spread: a cross entry near a rounding boundary rounds a step apart, and
# GN grows it); ARAP_BF16_TRAJ_RTOL is about twice those (step 10 as
# phase 16's).  The two edge orders are held to each other at the same
# bounds.
ARAP_JAX_BF16_COSTS = {
    "grouped": (120.0, 22.74494743347168, 33.33510971069336, 30.129541397094727,
                17.55815887451172, 11.366631507873535, 11.682729721069336, 10.270575523376465,
                8.820371627807617, 9.197484970092773, 10.024299621582031),
    "shuffled": (120.0, 22.744949340820312, 33.335105895996094, 30.13041114807129,
                 17.557815551757812, 11.364736557006836, 11.72692584991455, 10.23320198059082,
                 8.814282417297363, 9.225992202758789, 10.065844535827637)}
ARAP_BF16_TRAJ_RTOL = {1: 1e-5, 2: 2e-5, 3: 8e-5, ARAP_STEPS: 2e-2}
# phase 16's marginal PCG iteration (ms) by edge order, logged beside
# phase 27's
ARAP_F32_MARGINAL_MS = {}
# device_ms: calls per captured CUDA graph, replays per timing
# phase 2: the bf16 atomics body at wide levels of more than 8 row
# channels (a 9-channel rotation row, and its register arrays' bound),
# W = 12 slots of 16 384 elements into as many columns
BF16_WIDE = ((9, 3), (16, 3))
BF16_WIDE_W = 12
BF16_WIDE_N = 16384
# phases 18-19: the full-width paths of scripts/torch_model_trajectory.py's
# FULL at FULL_SIZE² (full_case): deconvolution with the reference's 15 x
# 15 kernel, GN, nIterations 6, lIterations 40; optical_flow, LM,
# lIterations 15, 10 steps, the Q-ratio stop off.  The JAX package's
# trajectories on a CPU, costs after steps 0-6 and 0-10, in f32 and in f64:
#   JAX_PLATFORMS=cpu python3 scripts/torch_model_trajectory.py --package jax \
#       --model deconvolution|optical_flow --size 512 [--double]
FULL_SIZE = 512
FULL_JAX_F32_COSTS = {
    "deconvolution": (4875.7255859375, 3876.90771484375, 3867.614990234375, 3867.407958984375,
                      3867.39990234375, 3867.3994140625, 3867.39892578125),
    "optical_flow": (364.9801330566406, 238.2515869140625, 195.87356567382812,
                     122.36415100097656, 99.61210632324219, 57.517765045166016,
                     46.98200988769531, 26.593042373657227, 21.80677604675293,
                     12.948247909545898, 10.695005416870117),
}
FULL_JAX_F64_COSTS = {
    "deconvolution": None,
    "optical_flow": (364.9801688681707, 238.02641760471565, 195.76259720392127,
                     122.16250728396625, 99.46254381104737, 57.36349824577858,
                     46.85785640027336, 26.4989873806219, 21.728335273806515,
                     12.89731503919717, 10.651467008937326),
}
# the run each phase holds the card's costs to: JAX's f32 run for
# deconvolution; for optical_flow JAX's f64 run, since JAX's f32 run lies
# 9.5e-4, 5.7e-4, 1.7e-3, ... 4.1e-3 from it after steps 1-10, while every
# f32 run of the port lies within 4.8e-6 of it (below)
FULL_REFERENCE = {"deconvolution": "f32", "optical_flow": "f64"}
# JAX's contraction blocking at 512² with Kd = 15 (thallo_tpu/lower.py:494-565):
# the unblocked fiber, X and K over 225 taps at 262 144 pixels, is 472 MB,
# over the 128 MiB THALLO_CON_BLOCK_BYTES: blocks of 3 of the 15 k_0, 5 of them
FULL_CON_BLOCK = ("Kd", 3, 5)
# the cost after each step within FULL_TRAJ_RTOL[model][step] of the
# reference run: about twice the port's own f32 spread, the largest distance
# from it of f32 runs of the port, some with the unknowns moved by 1e-7 x
# max(max|U|, 1) (--perturb SEED):
#   python3 scripts/torch_model_trajectory.py --package torch --device cuda|cpu \
#       --model deconvolution|optical_flow --size 512 --perturb SEED
# deconvolution: six runs on the card (seeds 1-3) lie at most 0, 1.3e-7,
# 3.2e-7, 6.3e-8, 1.3e-7, 6.3e-8, 6.3e-8 from JAX's f32 run after steps 0-6
# (one f32 ulp of these costs is 6.3e-8; the energy is quadratic, so GN lands
# near its minimum in the first step).  optical_flow: eight runs on a CPU
# (seeds 1-4) and the card's lie at most 6.9e-8, 2.4e-7, 1.1e-7, 7.6e-7,
# 6.6e-7, 2.2e-6, 2.1e-6, 4.1e-6, 3.9e-6, 4.5e-6, 4.8e-6 from JAX's f64 run
# after steps 0-10.
FULL_TRAJ_RTOL = {"deconvolution": (7e-7,) * 7,
                  "optical_flow": (2e-7, 5e-7, 5e-7, 2e-6, 2e-6, 5e-6, 5e-6, 1e-5, 1e-5, 1e-5,
                                   1e-5)}

GRAPH_CALLS = 10
GRAPH_REPLAYS = 5
# phase 20: double_precision at full width.  (a) the uniform 1M scene,
# LM, N_STEPS_1M steps through the f64 kernels; its cost, -JᵀF,
# diag(JᵀJ) and JᵀJ·p at the initial unknowns card vs the port's CPU path
# in f64 within F64_LINEAR_RTOL x max|ref| (f64 sums in another order,
# ~1e3 terms an output: ~1e-14; f32's bound, GRID_LINEAR_RTOL, is 1e-5).
F64_LINEAR_RTOL = 1e-10
# (b) ARAP 256², GN, lIterations 10, grouped edges, 10 steps in f64
# against the JAX package's f64 run on the CPU (JAX_PLATFORMS=cpu python3
# scripts/torch_model_trajectory.py --package jax --double).  The port's
# CPU f64 run (--package torch --device cpu --double) lies 1.2e-15 from
# it after step 1 and 4.8e-12 after step 10; the card adds the atomics'
# order, f64 rounding that GN's non-monotone steps carry (in f32 the
# spread grows 7e4x over 10 steps, ARAP_TRAJ_RTOL's comment).
# ARAP_F64_RTOL is 1e4x (steps 1-3) and 2e5x (step 10) tighter than
# ARAP_TRAJ_RTOL.
ARAP_JAX_F64_COSTS = (120.00000000000003, 22.744906967880866, 33.35416161534259,
                      30.1997468788424, 17.66217228275138, 11.359371052231765,
                      11.627720659161726, 10.826394839890815, 9.262477938571031,
                      12.030994423985176, 9.039287210758314)
ARAP_F64_RTOL = {1: 1e-9, 2: 1e-9, 3: 1e-9, ARAP_STEPS: 1e-7}
# (d) phase 5 in f64 at full width: the uniform 1M LM solve under
# PRECOMPUTE_J (stored point Jacobians, scalar Jacobi), N_STEPS_1M steps,
# its camera scatters through oh_setup_aggregate_f64; its first
# CROSS_STEPS steps against the f64 block-sparse solve under the same
# preconditioner within F64_CROSS (unknowns x max|U|, cost).  The two
# apply the same JᵀJ·p and differ only in summation order: in f32 phase 5
# holds them to (STEP_U_TOL, STEP_COST_RTOL) = (1e-4, 1e-2) and they part
# by up to 6.9e-6 of max|U| after step 3; f64 rounding is 2^-29 of f32's,
# so ~1e-14 is expected: 1e-9 leaves room for 1e5 of that and is 1e5x
# (unknowns) and 1e7x (cost) tighter than f32's.  Measured on an H100:
# 2.2e-16, 1.3e-14, 1.4e-14 of max|U| and <= 6.5e-15 of the cost.
F64_CROSS = (1e-9, 1e-9)
# (e) the test-size models whose stored-Jacobian scatters take
# oh_setup_aggregate_f64, card vs CPU in f64 for MODEL_STEPS steps, a
# parity check beside (d): (unknowns x max|U|, cost).
# f32 holds them at (5e-4, 1e-2) and (1e-4, 1e-2) (MODEL_TOL, phase 3).
# deconvolution's 40 PCG iterations past convergence carry the atomics'
# order furthest: 8 card runs against the CPU in f64
# (scripts/torch_model_trajectory.py --model deconvolution --steps 3
# --q-tolerance -1 --device cuda --against-cpu 8 --double, H100) reach
# 5.8e-6 of max|X| and 1.8e-8 of the cost; its bound is twice that, 40x
# (unknowns) and 2.5e5x (cost) tighter than f32's.  face_fitting, 5.5e-16
# of max|U| (one run): 1e-8.
F64_MODELS = {"deconvolution": (1.2e-5, 4e-8), "face_fitting": (1e-8, 1e-8)}
# phase 21: Plan.jacobian.  COO card vs CPU (the same rows and cols, the
# values f32 by another AD order) and Jᵀr from the 1M COO (index_add_)
# against the solver's -JᵀF, each within JAC_TOL x max|ref| (f32 sums of
# ~1e3 terms a camera in two orders)
JAC_TOL = 1e-5
# phase 22: the drivers on the card (run_model's grid, graph and BA rows;
# every gallery row; the timer's summary at timing levels 1 and 2)
RUN_MODELS = ("poisson_image_editing", "arap_mesh_deformation", "bundle_adjustment")
DRIVER_STEPS = 8
# launches per timing when phase 8 drives the measurement scripts
SCRIPT_LAUNCHES = 10
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM and f32 outside
# the tensor cores; the bound of a kernel is the larger of its bytes (each
# input read once, each output written once) and its f32 operations over them
# phase 23: LINEARIZE and INLINE at 1M against phase 5's PRECOMPUTE_J (the
# same scalar-Jacobi PCG; LINEARIZE runs its arithmetic with the atomics in
# another order, INLINE forms J·p and Jᵀ(J·p) by jvp and vjp): (x max|U|,
# of the cost) per step over 3 steps, about twice the spread measured on
# the H100 (max|dU|/max|U| 2.3e-5, cost 1.1e-5; PERF.md, Findings)
SCHED_BA_TRAJ = (5e-5, 3e-5)
SCHED_BA_STEPS = 3
# phase 23(c): the exhaustive candidates measured at ARAP 256² (the merged
# groups' 25 (fit, reg) schedule pairs come first), and the bound on each
# one's cost after its 1 + 3 steps against the run of its preconditioner:
# phase 16's bound at steps 2-3 (twice the port's f32 spread on this
# scene); the candidates measured 1.6e-6 at most (PERF.md, Findings)
SCHED_ARAP_CANDIDATES = 25
SCHED_ARAP_STEPS = 3
SCHED_ARAP_RTOL = 2e-5
# phase 24: steps_per_dispatch, a CUDA graph of the guarded step replayed
# k times a dispatch.  (a) the uniform 1M LM scene, DISPATCH_1M_BATCHES
# run_steps(DISPATCH_1M_K) calls graphed against DISPATCH_EAGER_RUNS eager
# runs of the same calls: unknowns and cost after each call within
# DISPATCH_SPREAD_X times the eager runs' spread there (the largest
# distance of two of them: the atomics' order, the only thing a graph
# could change) of every eager run, or within (STEP_U_TOL,
# DISPATCH_COST_FLOOR), whichever is wider (hold_vs_eager; phase 25 holds
# its sharded runs by the same function).  A path whose eager runs agree
# bit for bit (no atomics) must give the same bits graphed; two eager runs
# then, DISPATCH_EAGER_RUNS where the first two differ or a tested run
# differs from them.  Near convergence
# the LM accepts split the 1M runs: after 10 steps the cost falls in one of
# two modes (~4.5 or ~6.2 from c0 6 972 748) and the unknowns spread
# widely within each (scripts/torch_lm_modes.py on an H100: 10 of 24 runs
# in the second mode, eager and graphed alike).  Five eager runs often all
# missed the mode, or the reach, of one more run with no fault (a graphed
# run 2.1-2.2x their largest distance, twice in four smoke runs on an
# H100; the skewed scene 2.1x once); twelve miss a mode with odds of about
# 0.6^12 + 0.4^12, 0.2%.  Past the split even twelve do not bound the
# unknowns' distance (a graphed run 1.94x their largest distance after 10
# steps, with no fault, in the second of two smoke runs on an H100), so
# the uniform 1M scene's unknowns are held at its first
# DISPATCH_1M_U_CALLS calls (5 steps, one cost mode; graphed and sharded
# runs at 0.33-0.43 of the limit there in six smoke runs) and its cost at
# every call.  (b) the skewed 1M
# scene, DISPATCH_SKEW_STEPS steps at k = 2, by (a)'s rule; (c) ARAP 256²
# and image_warping 512² GN solve() at k = DISPATCH_GRID_K against phases
# 16 and 11's bounds of JAX's f32 trajectories; (d) each small path of
# scripts/torch_dispatch_paths.py, 2 steps, by (a)'s rule at phase 3's
# floors (STEP_U_TOL, STEP_COST_RTOL), with PATHS_EAGER_RUNS eager runs
# where its first two differ or the graphed run differs from them (two
# eager runs of the small dense-JᵀJ path once agreed bit for bit and the
# graphed run did not; against one eager pair, the small skewed
# scene once read 1.07e-4 of max|U| graphed, over the 1e-4 floor, where
# its eager pairs had lain 7.8e-5 to 1.9e-4 apart), PATHS_EAGER_RUNS_AT
# on the two paths whose spread the floors do not cover: there five eager
# runs failed the rule against one more eager run, with no fault, in 0.75%
# to 3.15% of draws on the small skewed scene and 7.8% on schur_dense GN,
# whose eager costs after 2 steps lie a median 0.004 apart but up to 0.037
# (scripts/torch_dispatch_spread.py on an H100, 30-40 eager and 6-10 graphed
# runs a path, graphed runs failing no more often than eager ones); at 12
# and 20 runs 0-0.5% and 0.1%; (g) hbm_fraction of
# ARAP 256²'s marginal PCG iteration at most ROOFLINE_MAX (the traffic
# model is a lower bound: a share above 1 would be a model or timing
# fault)
DISPATCH_1M_K = 5
DISPATCH_1M_BATCHES = 2
DISPATCH_1M_U_CALLS = 1
DISPATCH_SPREAD_X = 2.0
DISPATCH_EAGER_RUNS = 12
PATHS_EAGER_RUNS = 5
PATHS_EAGER_RUNS_AT = {"ba skewed level tables LM": DISPATCH_EAGER_RUNS, "ba schur_dense GN": 20}
# (a), (b), phase 25: the costs within the spread or DISPATCH_COST_FLOOR x
# the initial cost: the two modes of the 1M cost after 10 steps lie up to
# 3.1e-7 x c0 apart (on an H100: eager runs 4.42, 6.35, 4.55 in one call,
# 4.48-6.67 in another, a graphed 6.11 beside eager 4.42-4.53); about
# twice that, as phase 12's SCHUR_COST_FLOOR (PERF.md, Findings)
DISPATCH_COST_FLOOR = 6e-7
DISPATCH_SKEW_STEPS = 4
DISPATCH_GRID_K = 10
ROOFLINE_MAX = 1.05
# phase 25: the sharded path on a one-rank NCCL group (the module
# docstring): SHARD_CALLS calls of run_steps(SHARD_K), eager sharded and at
# steps_per_dispatch SHARD_K, by phase 24(a)'s rule
SHARD_K = 5
SHARD_CALLS = 2
# a graph step's all_reduce bytes: the PCG and cost scalars alone
# (tests/test_distribution.py:232)
SHARD_MAX_ALL_REDUCE = 4096
# phase 26: deconvolution 512² sharded takes this many eager steps; its
# halo along W is the 15 x 15 kernel's reach; the C-API BA 1M run (LM)
# takes CAPI_STEPS steps of CAPI_L_ITERATIONS, before LM's accepts split
# the 1M runs (DISPATCH_1M_U_CALLS), and must launch CAPI_KERNELS
GRID_SHARD_DC_STEPS = 3
FULL_CON_HALO = 7
CAPI_STEPS = 5
CAPI_L_ITERATIONS = 10
CAPI_KERNELS = ("fused_pair_apply", "oh_setup_products", "fullrepeat_setup")
# (e) the hand-written kernels kernel_stats(interior=True) must name on the
# uniform 1M step (csrc/: the persistent fused pair, oh_setup_products'
# persistent body, fullrepeat_setup's tiles)
INTERIOR_KERNELS = ("fused_pair", "oh_products", "fullrepeat")
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12  # f64 outside the tensor cores (the same data sheet)
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


def compare(name, got, ref, terms=None, tol=KERNEL_TOL):
    """max|got - ref| over all outputs; fails above tol (KERNEL_TOL) * max|ref|,
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
    if terms is None and err > tol * scale:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {tol} * {scale:.3e}")
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


PAIR_KERNELS = ("fused_pair_apply", "fused_pair_apply_atomics", "fused_pair_apply_atomics_thread",
                "fused_pair_apply_wloop", "fused_pair_apply_wloop_chunked", "fused_pair_rows_floor")
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
        if plan.local is not None:  # the staged route: its first body too
            cases += per_chunk_cases(dev, tag, ids, S, cm)
    return cases


def per_chunk_cases(dev, tag, ids, S, cm, tol=()):
    """The first staged body (segment_sum_per_chunk[_f64]) on channel-major
    data cm [C, M] by its own plan (PER_CHUNK_ROWS-row chunks), beside the
    ring kernel's case of the same values; and the ring kernel's second
    launch, which must give the same bits as its first."""
    from thallo_tpu_torch.ops import segsum

    f64 = cm.dtype == torch.float64
    fn = segsum.segment_sum_per_chunk_f64 if f64 else segsum.segment_sum_per_chunk
    plan = segsum.build_plan(ids, S, device=dev, staged_rows=segsum.PER_CHUNK_ROWS)
    ring = segsum.build_plan(ids, S, device=dev)
    d, C = cm.T, cm.shape[0]
    first, again = segsum.segment_sum(d, ring), segsum.segment_sum(d, ring)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f"segment_sum[{tag}] (ring): two launches differ by "
                             f"{float((first - again).abs().max()):.3e}")
    log(f"segment_sum[{tag}] (ring, {ring.n_blocks} blocks of {ring.staged_rows}-row chunks): "
        "two launches, the same bits")
    idl = torch.from_numpy(ids).to(dev).long()
    return [(fn.__name__, tag, lambda d=d, p=plan, fn=fn: (fn(d, p),),
             lambda d=d, p=plan: (segsum.segment_sum_reference(d, p),),
             lambda d=d, S=S, C=C, idl=idl: torch.zeros(
                 (S, C), dtype=d.dtype, device=dev).index_add_(0, idl, d),
             nbytes(cm, plan.order, plan.seg_start), len(ids) * C, None, *tol)]


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
          ("fused_pair_apply_atomics_thread", "arap256"): "fused_pair_apply_atomics_thread",
          ("fused_pair_apply_atomics_bf16", "arap256_bf16"): "fused_pair_apply_atomics_bf16",
          ("segment_sum_fixed_order", "deconvolution_0"): "segment_sum_fixed_order",
          ("segment_sum_per_chunk", "ba1m_cameras"): "segment_sum_per_chunk",
          ("segment_sum_per_chunk_f64", "ba1m_cameras_f64"): "segment_sum_per_chunk_f64",
          ("fused_pair_apply_atomics_thread_f64", "arap256_f64_0"):
              "fused_pair_apply_atomics_thread_f64",
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
          ("fused_pair_bf16_atomics", "ba1m_bf16"): "fused_pair_bf16_atomics",
          # the f64 paths' first call of each kernel (f64_kernel_cases)
          ("fused_pair_apply_f64", "ba1m_f64_0"): "fused_pair_apply_f64",
          ("fused_pair_apply_atomics_f64", "arap256_f64_0"): "fused_pair_apply_atomics_f64",
          ("oh_setup_products_f64", "ba1m_f64_0"): "oh_setup_products_f64",
          ("fullrepeat_setup_f64", "ba1m_f64_0"): "fullrepeat_setup_f64",
          # its PCG iteration's [9, 1M] -> 1024 scatter (_0: the setup's [18, 1M])
          ("oh_setup_aggregate_f64", "ba1m_pj_f64_1"): "oh_setup_aggregate_f64",
          ("segment_sum_f64", "ba1m_f64"): "segment_sum_f64",
          ("segment_sum_f64", "ba1m_cameras_f64"): "segment_sum_f64_cameras"}

# record entry -> (source, the TPU kernel it replaces: file:line of its
# pallas_call or kernel body, the smoke solve or phase whose launches it
# reports)
KERNELS = {
    "fused_pair_apply": ("thallo_tpu_torch/csrc/fused_pair.cu",
                         "thallo_tpu/ops/fusedpair.py:349", "block-sparse"),
    "fused_pair_apply_atomics": ("thallo_tpu_torch/csrc/fused_pair.cu",
                                 "thallo_tpu/ops/fusedpair.py:349", "arap256 grouped"),
    # the first atomics body: the route of every other atomics level but
    # the short ones (fusedpair.atomics_keeps_thread)
    "fused_pair_apply_atomics_thread": ("thallo_tpu_torch/csrc/fused_pair.cu",
                                        "thallo_tpu/ops/fusedpair.py:349", "measurement"),
    # the slots kernel on bf16 blocks: the bf16 atomics route (phase 27)
    "fused_pair_apply_atomics_bf16": ("thallo_tpu_torch/csrc/fused_pair.cu",
                                      "thallo_tpu/ops/fusedpair.py:349", "arap256 bf16 grouped"),
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
    # the small-image scatters' fixed-order plans (phase 15's deconvolution)
    "segment_sum_fixed_order": ("thallo_tpu_torch/csrc/segsum.cu",
                                "thallo_tpu/ops/segsum.py:254", "model deconvolution"),
    # the first staged body, which the ring kernel replaced on the route
    "segment_sum_per_chunk": ("thallo_tpu_torch/csrc/segsum.cu",
                              "thallo_tpu/ops/segsum.py:254", "measurement"),
    "segment_sum_per_chunk_f64": ("thallo_tpu_torch/csrc/segsum.cu",
                                  "thallo_tpu/ops/segsum.py:254", "measurement"),
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
    # the f64 instantiations (double_precision), phase 20's runs
    "fused_pair_apply_f64": ("thallo_tpu_torch/csrc/fused_pair.cu",
                             "thallo_tpu/ops/fusedpair.py:349", "f64 block-sparse"),
    "fused_pair_apply_atomics_f64": ("thallo_tpu_torch/csrc/fused_pair.cu",
                                     "thallo_tpu/ops/fusedpair.py:349", "measurement"),
    "fused_pair_apply_atomics_thread_f64": ("thallo_tpu_torch/csrc/fused_pair.cu",
                                            "thallo_tpu/ops/fusedpair.py:349", "arap256 f64"),
    "oh_setup_products_f64": ("thallo_tpu_torch/csrc/oh_setup.cu",
                              "thallo_tpu/ops/ohsetup.py:192", "f64 block-sparse"),
    "fullrepeat_setup_f64": ("thallo_tpu_torch/csrc/fullrepeat.cu",
                             "thallo_tpu/ops/fullrepeat.py:178", "f64 block-sparse"),
    "oh_setup_aggregate_f64": ("thallo_tpu_torch/csrc/oh_aggregate.cu",
                               "thallo_tpu/ops/ohsetup.py:236", "f64 precompute_j"),
    # phase 23(b): INLINE's transposes under THALLO_SEGSUM=tiled in f64
    "segment_sum_f64": ("thallo_tpu_torch/csrc/segsum.cu",
                        "thallo_tpu/ops/segsum.py:254", "inline f64 tiled"),
    "segment_sum_f64_cameras": ("thallo_tpu_torch/csrc/segsum.cu",
                                "thallo_tpu/ops/segsum.py:254", "inline f64 tiled"),
}


def counters():
    """Every kernel wrapper by name: each counts its own launches."""
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, loopfloor, ohsetup, segsum

    return {"fused_pair_apply": fusedpair.fused_pair_apply,
            "fused_pair_apply_atomics": fusedpair.fused_pair_apply_atomics,
            "fused_pair_apply_atomics_thread": fusedpair.fused_pair_apply_atomics_thread,
            "fused_pair_apply_atomics_bf16": fusedpair.fused_pair_apply_atomics_bf16,
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
            "segment_sum_fixed_order": segsum.segment_sum_fixed_order,
            "segment_sum_fixed_order_f64": segsum.segment_sum_fixed_order_f64,
            "segment_sum_per_chunk": segsum.segment_sum_per_chunk,
            "segment_sum_per_chunk_f64": segsum.segment_sum_per_chunk_f64,
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
            "loop_floor_add_one": loopfloor.add_one,
            "fused_pair_apply_f64": fusedpair.fused_pair_apply_f64,
            "fused_pair_apply_atomics_f64": fusedpair.fused_pair_apply_atomics_f64,
            "fused_pair_apply_atomics_thread_f64": fusedpair.fused_pair_apply_atomics_thread_f64,
            "oh_setup_products_f64": ohsetup.oh_setup_products_f64,
            "fullrepeat_setup_f64": fullrepeat.fullrepeat_setup_f64,
            "oh_setup_aggregate_f64": ohsetup.oh_setup_aggregate_f64,
            "segment_sum_f64": segsum.segment_sum_f64}


def ba_plan(ba, tt, inputs, dims, device, n_iter, schedule=None, double=False, **options):
    """An LM plan of the BA energy, with `schedule` ("J" or "Jp") set to
    materialize in the energy text; double: under double_precision."""
    text = ba.ENERGY + (ENERGY_SUFFIX.format(schedule) if schedule else "")
    spec = tt.load_energy(text, tt.ProblemSpec(double_precision=double))
    plan = spec.plan(dims, solver="levenberg_marquardt", device=device, **options)
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


def level_routes(bsr, bf16=False):
    """(W, N_t) of each col level of a plan's tables -> the fused-pair
    kernel fused_pair_route names for it (bf16: on bf16 blocks)."""
    from thallo_tpu_torch.ops import fusedpair

    out = {}
    for pr in bsr.pairs:
        if pr[2] == "col":
            W, N_t = bsr.cols[bsr.col_gathers[pr[3]][0]].shape
            S = int(np.prod(bsr.image_shapes[bsr.slot_images[pr[1]]][:-1]))
            out[W, N_t] = fusedpair.fused_pair_route(
                W, N_t, bsr.slot_channels[pr[0]], bsr.slot_channels[pr[1]], S, bf16=bf16)
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
    read from the wrapper's own count around it (or from `counted`'s, the
    wrapper it hands a dtype to), to counts[key(*args, **kwargs)].
    ``launches`` passes through to the wrapper's count, which a wrapper
    reaches by its module-level name."""

    def __init__(self, real, key, counted=None):
        self.real, self.key, self.counts = real, key, collections.Counter()
        self.counted = counted or real

    def __call__(self, *args, **kwargs):
        n0 = self.counted.launches
        out = self.real(*args, **kwargs)
        self.counts[self.key(*args, **kwargs)] += self.counted.launches - n0
        return out

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n


@contextlib.contextmanager
def tally(module, name, key, counted=None):
    """``module.name`` (a kernel wrapper) behind a _Tally while the block
    runs; yields its counts."""
    real = getattr(module, name)
    hook = _Tally(real, key, counted)
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
                         "fused_pair_apply_atomics_bf16", "fused_pair_v2_smem",
                         "fused_pair_v3_partials") if launches[n]]
    if stray:
        raise AssertionError(f"{label}: launched {stray}, not the bf16 persistent kernel")
    never_rising(label, costs)
    if not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"{label}: final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    log(f"{label}: final cost {costs[-1]!r} (f32 blocks, phase 4: {f32_final!r})")
    return launches, costs[-1]


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


def phase_skew_1m(ba, tt, scene, block_dtype=None, n_steps=N_STEPS_1M):
    """The skewed 1M solve: level tables after the residual sort; under
    block_dtype="bf16" each level through the bf16 kernel of its route
    (no convergence gate in a few steps)."""
    from thallo_tpu_torch.solver import blocksparse

    label = "1M skew block-sparse" + (" bf16" if block_dtype else "")
    names = (("fused_pair_apply_bf16", "fused_pair_apply_wloop_bf16",
              "fused_pair_apply_atomics_bf16")
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
    routes = level_routes(plan._prep["consts"][0]["bsr"], bf16=bool(block_dtype))
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


def _schur_run(ba, tt, inputs, dims, dev, ls, fns):
    """One run of phase 12's scene: (costs from c0, unknowns after each
    step, LM's accept flag of each step, launches by kernel)."""
    plan = ba_plan(ba, tt, inputs, dims, dev, SCHUR_SMALL_STEPS, linear_solver=ls)
    for fn in fns.values():
        fn.launches = 0
    costs = [plan.init({k: np.copy(v) for k, v in inputs.items()})]
    Us, accepts = [], []
    for _ in range(SCHUR_SMALL_STEPS):
        plan.step()
        costs.append(plan.cost())
        Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
        # an accept resets the radius decrease factor to 2, a reject doubles it
        accepts.append(bool(float(plan._lm.radius_decrease_factor) == 2.0))
    return costs, Us, accepts, {n: fn.launches for n, fn in fns.items()}, plan


def hold_trajectory_by_spread(label, card, ref, floors):
    """Steps 2.. of a card-vs-CPU trajectory by phase 24's rule
    (held_by_spread, not bit for bit: the CPU is another device): the
    card's own runs `card` ([(costs, unknowns, accepts)]) give each step's
    spread, and the CPU run `ref` must lie within DISPATCH_SPREAD_X times
    it of every card run, each limit at least its floor (floors: x max|U|,
    the cost's relative bound), the cost's plus SCHUR_COST_FLOOR x c0."""
    c0 = ref[0][0]
    for k in range(1, len(ref[1])):
        cost_floor = floors[1] * abs(ref[0][k + 1]) / abs(c0) + SCHUR_COST_FLOOR
        ok, spread, far, lim, _ = held_by_spread(
            [(c[1][k], c[0][k + 1]) for c in card], (ref[1][k], ref[0][k + 1]), c0,
            (floors[0], cost_floor), exact=False)
        log(f"{label}, step {k + 1}: {len(card)} card runs' spread max|dU|/max|U| "
            f"{spread[0]:.3e}, cost {spread[1]:.3e} x c0; the CPU run vs the farthest card run "
            f"{far[0]:.3e}, {far[1]:.3e} (limits {lim[0]:.3e}, {lim[1]:.3e})")
        if not ok:
            raise AssertionError(f"{label}, step {k + 1}: the CPU run lies off the card runs")


def phase_schur_small(ba, tt, device="cuda", ref_device="cpu"):
    """Phase 12: schur_pcg and schur_dense on `device` against
    `ref_device`, on the small uniform and skewed scenes; schur_dense's
    first step against the direct solve on `device`.  Step 1 holds to
    phase 3's bounds; later steps of the uniform scene to SCHUR_TRAJ, of
    the skewed scene by hold_trajectory_by_spread over the card's own
    runs (two, DISPATCH_EAGER_RUNS where the first two differ)."""
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
            card = [_schur_run(ba, tt, inputs, dims, device, ls, fns)]
            cc, Uc, ac, _, _ = _schur_run(ba, tt, inputs, dims, ref_device, ls, fns)
            cg, Ug, ag, lg, plan = card[0]
            if label == "small skewed":
                more_runs_while_they_differ(
                    card, lambda: _schur_run(ba, tt, inputs, dims, device, ls, fns),
                    lambda a, b: a[0] != b[0])
            for i, r in enumerate(card):
                log(f"{label} scene {ls} {device} run {i + 1}: costs {r[0]}, accepts {r[2]}")
            log(f"{label} scene {ls} {ref_device}: costs {cc}, accepts {ac}")
            routes = set(level_routes(plan._prep["consts"][0]["bsr"]).values())
            log(f"{label} scene {ls} fused-pair launches on {device} "
                f"{({n: lg[n] for n in routes})}")
            if device == "cuda" and not all(lg[n] > 0 for n in routes):
                raise AssertionError(f"{label} scene {ls}: a routed fused-pair kernel never "
                                     "launched")
            check_steps(f"{label} scene {ls} {device} vs {ref_device}, step 1", cg[:2], Ug[:1],
                        cc[:2], Uc[:1], u_tol, c_tol)
            if label == "small skewed":
                hold_trajectory_by_spread(f"{label} scene {ls} {ref_device} vs {device}",
                                          [r[:3] for r in card], (cc, Uc, ac),
                                          (traj_u, traj_c))
            else:
                check_steps(f"{label} scene {ls} {device} vs {ref_device}", cg, Ug, cc, Uc,
                            traj_u, traj_c, SCHUR_COST_FLOOR * abs(cc[0]))
            for i, r in enumerate(card):
                never_rising(f"{label} scene {ls} {device} run {i + 1}", r[0])
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


def arap_kernel_cases(dev, rng, bsr, order="grouped", bf16=False):
    """The atomics route's two f32 bodies, fused_pair_apply_atomics (the
    slots kernel, the route's) and fused_pair_apply_atomics_thread (the
    first body), at the level shapes of ARAP 256²'s reg group in one edge
    order: each (3, 3) col pair's table ([4, 65 536] element ids) with
    seeded blocks, pcol and prow.  bf16: the blocks as bf16 (phase 27's
    crosses), the bf16 slots kernel (fused_pair_apply_atomics_bf16, the
    route's) and the first bf16 body (fused_pair_bf16_atomics)."""
    from thallo_tpu_torch.ops import fusedpair

    S = ARAP_SIDE * ARAP_SIDE
    cases = []
    levels = [bsr.cols[bsr.col_gathers[pr[3]][0]] for pr in bsr.pairs if pr[2] == "col"]
    log(f"ARAP 256² reg levels, {order} (W, N_t): "
        + ", ".join(str(tuple(c.shape)) for c in levels))
    base = ("arap256_bf16" if bf16 else "arap256") + ("" if order == "grouped" else f"_{order}")
    body = "fused_pair_apply_atomics_bf16" if bf16 else "fused_pair_apply_atomics"
    for k, ids in enumerate(levels):
        W, N = ids.shape
        a = _pair_args(lambda x: torch.from_numpy(x).to(dev), rng, ids, Ci=3, Cj=3, S=S,
                       block_dtype=torch.bfloat16 if bf16 else torch.float32)
        for name in ATOMICS_BODIES[body]:
            cases.append((name, base if k == 0 else f"{base}_{k}",
                          lambda a=a, fn=getattr(fusedpair, name): fn(*a, Ci=3, Cj=3, S=S),
                          lambda a=a: fusedpair.fused_pair_apply_reference(*a, Ci=3, Cj=3, S=S),
                          None, nbytes(*a), 4 * W * N * 9, None))
    return cases


def f64_kernel_cases(dev, rng, ba, tt, scene):
    """The f64 instantiations (double_precision) at the shapes, recipes and
    tables phase 20 gives them, from one step of each of its full-width
    f64 plans on the card (path_calls): the uniform 1M scene's camera-side
    products, point-side full-repeat setup and persistent fused pair; its
    PRECOMPUTE_J schedule's camera scatters (the aggregation kernel);
    ARAP 256²'s (3, 3) col levels on the atomics body.  Each against its
    plain f64 version within F64_KERNEL_TOL x max|ref|: f64 on both
    sides, only the order of the (atomic) sums differs."""
    inputs, dims = scene

    def ba_1m(schedule=None, **options):
        plan = ba_plan(ba, tt, inputs, dims, "cuda", 1, schedule, double=True, **options)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        return plan

    makes = {"ba1m_f64": (ba_1m, {"oh_setup_products", "fullrepeat_setup",
                                  "fused_pair_apply_f64"}),
             "ba1m_pj_f64": (lambda: ba_1m("J", preconditioner="jacobi"),
                             {"oh_setup_aggregate"}),
             "arap256_f64": (lambda: arap_plan(tt, ARAP_SIDE, "grouped", "cuda", double=True),
                             {"fused_pair_apply_atomics_thread_f64"})}
    cases = []
    for tag, (make, want) in makes.items():
        calls = path_calls(make())
        names = {c[0] for c in calls}
        if names != want:
            raise AssertionError(f"{tag}: the f64 path launched {sorted(names)}, "
                                 f"not {sorted(want)}")
        cases += path_kernel_cases(dev, rng, tag, calls)
    # segment_sum_f64, the transposes of phase 23(b)'s INLINE tiled f64
    # solve: points [1M, 3] -> 250 000 and cameras [1M, 9] -> 1024, plans
    # from the scene's maps, data the transpose of a channel-major buffer
    # (what SlotScatter passes)
    from thallo_tpu_torch.ops import segsum

    for tag, ids, S, C in (("ba1m_f64", np.asarray(inputs["oToP"], np.int32), BA_1M[1], 3),
                           ("ba1m_cameras_f64", np.asarray(inputs["oToC"], np.int32),
                            BA_1M[0], 9)):
        plan = segsum.build_plan(ids, S, device=dev)
        cm = torch.from_numpy(rng.normal(size=(C, len(ids)))).to(dev)
        idl = torch.from_numpy(ids).to(dev).long()
        cases.append(("segment_sum_f64", tag,
                      lambda d=cm.T, p=plan: (segsum.segment_sum_f64(d, p),),
                      lambda d=cm.T, p=plan: (segsum.segment_sum_reference(d, p),),
                      lambda d=cm.T, S=S, C=C, idl=idl: torch.zeros(
                          (S, C), dtype=torch.float64, device=dev).index_add_(0, idl, d),
                      nbytes(cm, plan.order, plan.seg_start), len(ids) * C, None,
                      F64_KERNEL_TOL))
        if plan.local is not None:  # the staged route: its first body too
            cases += per_chunk_cases(dev, tag, ids, S, cm, (F64_KERNEL_TOL,))
    return cases


def bf16_wide_cases(dev, rng):
    """The bf16 slots kernel (fused_pair_apply_atomics_bf16, the route's)
    and the first bf16 body (fused_pair_bf16_atomics) at wide levels of
    more than 8 row channels, Ci x Cj of BF16_WIDE (bf16 blocks of a level
    that fused_pair_route sends there: W = BF16_WIDE_W), against the plain
    version."""
    from thallo_tpu_torch.ops import fusedpair

    cases = []
    W, N, S = BF16_WIDE_W, BF16_WIDE_N, BF16_WIDE_N
    for Ci, Cj in BF16_WIDE:
        route = fusedpair.fused_pair_route(W, N, Ci, Cj, S, bf16=True)
        if route != "fused_pair_apply_atomics_bf16":
            raise AssertionError(f"bf16 ({Ci}, {Cj}) level routes to {route}")
        ids = torch.from_numpy(rng.integers(0, S, size=(W, N)).astype(np.int32)).to(dev)
        a = _pair_args(lambda x: torch.from_numpy(x).to(dev), rng, ids, Ci=Ci, Cj=Cj, S=S,
                       block_dtype=torch.bfloat16)
        for name in ATOMICS_BODIES[route]:
            cases.append((name, f"wide_{Ci}x{Cj}",
                          lambda a=a, Ci=Ci, Cj=Cj, fn=getattr(fusedpair, name): fn(
                              *a, Ci=Ci, Cj=Cj, S=S),
                          lambda a=a, Ci=Ci, Cj=Cj: fusedpair.fused_pair_apply_reference(
                              *a, Ci=Ci, Cj=Cj, S=S),
                          None, nbytes(*a), 4 * W * N * Ci * Cj, None))
    return cases


# the kernel wrappers the block-sparse solver calls, by their names in
# solver/blocksparse.py
SOLVER_KERNELS = ("oh_setup_products", "fullrepeat_setup", "fused_pair_apply",
                  "fused_pair_apply_atomics", "fused_pair_apply_wloop",
                  "fused_pair_apply_wloop_chunked", "fused_pair_apply_bf16",
                  "fused_pair_apply_wloop_bf16", "fused_pair_apply_atomics_bf16",
                  "fused_pair_apply_f64",
                  "fused_pair_apply_atomics_f64",
                  "fused_pair_apply_atomics_thread", "fused_pair_apply_atomics_thread_f64")
# the two bodies of the atomics route (fusedpair.atomics_keeps_thread picks
# between them): phase 2 runs both at every atomics-route call of a path
ATOMICS_BODIES = {n: pair for pair in (
    ("fused_pair_apply_atomics", "fused_pair_apply_atomics_thread"),
    ("fused_pair_apply_atomics_f64", "fused_pair_apply_atomics_thread_f64"),
    ("fused_pair_apply_atomics_bf16", "fused_pair_bf16_atomics")) for n in pair}


def path_calls(plan):
    """The solver's kernel calls in one step of `plan`: [(kernel, args,
    kwargs)], each (kernel, table, recipe and shape) once, in the order of
    the first call: the block-sparse setup's and apply's, and the
    aggregation kernel and the segment sum of lower.py's scatters
    (materialized J, stored point Jacobians; the tiny ones in order)."""
    from thallo_tpu_torch import lower
    from thallo_tpu_torch.solver import blocksparse

    calls = {}

    def record(name):
        def key(*args, **kwargs):
            table = args[2] if name == "oh_setup_products" else \
                args[1] if name == "oh_setup_aggregate" else \
                args[1].order if name == "segment_sum" else args[0]
            k = (name, table.data_ptr() if name != "fullrepeat_setup" else None,
                 tuple(tuple(getattr(a, "shape", ())) for a in args),
                 tuple(sorted(kwargs.items())))
            calls.setdefault(k, (name, args, kwargs))
        return key

    with contextlib.ExitStack() as stack:
        for name in SOLVER_KERNELS:
            stack.enter_context(tally(blocksparse, name, record(name)))
        stack.enter_context(tally(lower, "oh_setup_aggregate", record("oh_setup_aggregate")))
        stack.enter_context(tally(lower, "segment_sum", record("segment_sum")))
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
    of the same shapes and dtypes; each held to KERNEL_TOL x max|ref|.  An
    f64 call (double_precision) is a case of the f64 instantiation, the
    kernel its wrapper launched, held to F64_KERNEL_TOL."""
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup, segsum

    def normal(x):
        v = rng.normal(size=tuple(x.shape))
        if x.dtype != torch.float64:
            v = v.astype(np.float32)
        return torch.from_numpy(v).to(device=dev, dtype=x.dtype)

    cases, seen = [], collections.Counter()
    for name, args, kw in calls:
        f64 = any(getattr(x, "dtype", None) == torch.float64 for x in args)
        tol = (F64_KERNEL_TOL,) if f64 else ()
        kname = name + "_f64" if f64 and not name.endswith("_f64") else name
        seen[kname] += 1
        ctag = f"{tag}_{seen[kname] - 1}"
        if name == "oh_setup_products":
            a = (normal(args[0]), normal(args[1]), args[2])
            rc, R = a[0].shape
            fn, ref = getattr(ohsetup, kname), ohsetup.oh_setup_products_reference
            cases.append((kname, ctag, lambda a=a, fn=fn, kw=kw: (fn(*a, **kw),),
                          lambda a=a, ref=ref, kw=kw: (ref(*a, **kw),), None, nbytes(*a),
                          _recipe_outputs(kw["recipe"]) * rc * 2 * R, None, *tol))
        elif name == "oh_setup_aggregate":
            a = (normal(args[0]), args[1])
            F, R = a[0].shape
            N = kw["N"]
            cases.append((kname, ctag,
                          lambda a=a, N=N, fn=getattr(ohsetup, kname): (fn(*a, N=N),),
                          lambda a=a, N=N: (ohsetup.oh_setup_aggregate_reference(*a, N=N),),
                          lambda a=a, N=N: (torch.zeros((a[0].shape[0], N), dtype=a[0].dtype,
                                                        device=dev)
                                            .index_add_(1, a[1].long(), a[0]),),
                          nbytes(*a), F * R, None, *tol))
        elif name == "segment_sum":
            # the fixed-order plan of a tiny scatter (segment_sum_fixed_order),
            # beside its first body (the runs kernel on the plan the earlier
            # rule built: in order where no run exceeds 32, else sorted
            # runs), the aggregation kernel (the route before those) and
            # index_add_ on the same values
            plan = args[1]
            d = normal(args[0].T).T  # channel-major [F, M], as scatter_route's
            M, F = d.shape
            S = plan.num_segments
            ids = torch.full((M,), S, dtype=torch.long, device=dev)
            ids[plan.order.long()] = torch.repeat_interleave(
                torch.arange(S, device=dev), (plan.seg_start[1:] - plan.seg_start[:-1]).long())
            if plan.block_run is not None:
                kname = "segment_sum_fixed_order"
                counts = (plan.seg_start[1:] - plan.seg_start[:-1]).cpu().numpy()
                first = segsum.build_plan(ids.cpu().numpy().astype(np.int32), S, device=dev,
                                          in_order=int(counts.max()) <= 32)
                cases.append(("segment_sum", ctag + "_first_body",
                              lambda d=d, p=first: (segsum.segment_sum(d, p),),
                              lambda d=d, p=plan: (segsum.segment_sum_reference(d, p),), None,
                              nbytes(d, first.order, first.seg_start), F * M, None, *tol))
            fn = getattr(segsum, kname)
            cases.append((kname, ctag, lambda d=d, p=plan, fn=fn: (fn(d, p),),
                          lambda d=d, p=plan: (segsum.segment_sum_reference(d, p),),
                          lambda d=d, ids=ids, S=S: (torch.zeros((S, d.shape[1]), dtype=d.dtype,
                                                                 device=dev)
                                                     .index_add_(0, ids, d),),
                          nbytes(d, plan.order, plan.seg_start), F * M, None, *tol))
            agg = "oh_setup_aggregate_f64" if f64 else "oh_setup_aggregate"
            a = (d.T.contiguous(), ids.to(torch.int32))
            cases.append((agg, ctag + "_same_values",
                          lambda a=a, S=S, fn=getattr(ohsetup, agg): (fn(*a, N=S).T,),
                          lambda d=d, p=plan: (segsum.segment_sum_reference(d, p),), None,
                          nbytes(*a), F * M, None, *tol))
        elif name == "fullrepeat_setup":
            a = (normal(args[0]), normal(args[1]))
            rc, R = a[0].shape

            def run(fn, a=a, kw=kw):
                agg, crosses = fn(*a, **kw)
                return (agg, *crosses)

            cases.append((kname, ctag, lambda run=run, fn=getattr(fullrepeat, kname): run(fn),
                          lambda run=run: run(fullrepeat.fullrepeat_setup_reference), None,
                          nbytes(*a), _recipe_outputs(kw["recipe"]) * rc * 2 * R, None, *tol))
        else:
            a = (args[0], normal(args[1]), normal(args[2]), normal(args[3]))
            W, N = a[0].shape
            # an atomics-route call: the slots kernel and the first body both
            for body in (name,) + tuple(b for b in ATOMICS_BODIES.get(name, ()) if b != name):
                cases.append((body, ctag,
                              lambda a=a, fn=getattr(fusedpair, body), kw=kw: fn(*a, **kw),
                              lambda a=a, kw=kw: fusedpair.fused_pair_apply_reference(*a, **kw),
                              None, nbytes(*a), 4 * W * N * kw["Ci"] * kw["Cj"], None, *tol))
        log(f"{kname}[{ctag}] from the path: " + ", ".join(
            f"{tuple(x.shape) if torch.is_tensor(x) else type(x).__name__}" for x in args)
            + f", {kw}")
    return cases


def model_kernel_cases(dev, rng, tt):
    """The kernels phases 15 and 17 launch, at the shapes, recipes and
    tables of their plans on the card (one step each): the graph models
    above the dense threshold, the contraction and sampled-image models
    (their stored-Jacobian scatters through the fixed-order segment sum),
    bundle_fusion above the dense threshold (its one-hot camera slots),
    embedded deformation under
    block_dtype="bf16" (its 9-channel rotation rows through
    fused_pair_apply_atomics_bf16) and the io samples."""
    from thallo_tpu_torch.models.cases import CASES, ITEM6_MODELS

    makes = {f"{name}_big": (lambda d, name=name: model_plan(tt, name, d, True))
             for name in sorted(CASES) if CASES[name][1] is not None}
    makes.update({name: (lambda d, name=name: model_plan(tt, name, d, False))
                  for name in ITEM6_MODELS})
    makes["embedded_bf16"] = lambda d: model_plan(tt, "embedded_mesh_deformation", d, True,
                                                  block_dtype="bf16")
    makes.update({"io_" + label.split()[0].split(".")[0]: make
                  for label, make in io_plans(tt).items()})
    cases = []
    for tag, make in makes.items():
        calls = path_calls(make("cuda"))
        if tag == "embedded_bf16" and not any(
                n == "fused_pair_apply_atomics_bf16" and kw["Ci"] == 9 for n, _, kw in calls):
            raise AssertionError("embedded deformation under block_dtype=bf16: its 9-channel "
                                 "rotation rows did not run on fused_pair_apply_atomics_bf16")
        cases += path_kernel_cases(dev, rng, tag, calls)
    return cases


def arap_plan(tt, side, order, device, n_iter=ARAP_STEPS, l_iterations=ARAP_L_ITERATIONS,
              inputs=None, double=False, **options):
    """A GN plan of ARAP (models/arap_mesh_deformation.py) at `side`, edges
    in the generator's order ("grouped") or shuffle_edges(seed=0)'s
    ("shuffled"), or of the given (inputs, dims); initialised; double:
    under double_precision; options: the plan's."""
    from thallo_tpu_torch.models import arap_mesh_deformation as arap

    if inputs is None:
        ins = arap.synthetic_inputs(side=side)
        if order == "shuffled":
            ins = arap.shuffle_edges(ins, seed=0)
        inputs = (ins, {"N": side * side, "E": len(ins["V0"])})
    ins, dims = inputs
    plan = tt.load_energy(arap.ENERGY, tt.ProblemSpec(double_precision=double)).plan(
        dims, solver="gauss_newton", device=device, **options)
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


def model_plan(tt, name, device, big, double=False, **options):
    """The port's plan of thallo_tpu_torch/models/cases.py's CASES[name],
    Q-ratio stop off (but for the cases of KEEP_Q_STOP), initialised;
    double: under double_precision."""
    from thallo_tpu_torch.models.cases import KEEP_Q_STOP, case_energy, model_case

    m, inputs, dims, solver, l_iterations = model_case(name, big)
    spec = tt.load_energy(case_energy(name, m), tt.ProblemSpec(double_precision=double))
    plan = spec.plan(dims, solver=solver, device=device, **options)
    plan.set_solver_parameter("lIterations", l_iterations)
    if name not in KEEP_Q_STOP:
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
    from thallo_tpu_torch.models.cases import CASES, GRAPH_MODELS

    runs = {}
    for name in sorted(CASES):
        big = name in GRAPH_MODELS
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
        hold_linear_parts(label, got, ref)
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
        log(f"{label} atomics bodies: the slots kernel {atomics} launches, the first body "
            f"{launches['fused_pair_apply_atomics_thread']}")
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
        # the marginal PCG iteration (bench.py:306-330)
        ms, per_iter = arap_marginal_ms(plan, fns, "fused_pair_apply_atomics")
        ARAP_F32_MARGINAL_MS[order] = ms
        log(f"{label} marginal PCG iteration: {ms:.4f} ms an iteration, "
            f"fused_pair_apply_atomics {per_iter:.2f} launches an iteration")
    for k, tol in ARAP_TRAJ_RTOL.items():
        a, b = traj["shuffled"][k], traj["grouped"][k]
        rel = abs(a - b) / abs(b)
        log(f"ARAP {ARAP_SIDE}² GN step {k}: shuffled {a!r} vs grouped {b!r}, rel {rel:.3e}")
        if not rel <= tol:
            raise AssertionError(f"ARAP {ARAP_SIDE}², step {k}: the edge orders differ: {a} vs {b}")
    return runs


def hold_linear_parts(label, got, ref):
    """The cost, -JᵀF, diag(JᵀJ) and JᵀJ·p of linear_parts on the card
    (got) against the port's CPU path (ref) at the same unknowns, each
    within GRID_LINEAR_RTOL (x max|ref|)."""
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


def arap_marginal_ms(plan, fns, name, warm=1):
    """The marginal PCG iteration of an ARAP plan (bench.py:306-330's
    metric: whole steps at the two lIterations of ARAP_MARGINAL, `warm`
    steps before each timed batch of ARAP_MARGINAL_STEPS; a graphed plan
    warms by one dispatch, which captures): (ms an iteration, launches of
    fns[name] an iteration)."""
    times, counts = {}, {}
    for li in ARAP_MARGINAL:
        plan.set_solver_parameter("lIterations", li)
        plan.run_steps(warm)
        torch.cuda.synchronize()
        n0 = fns[name].launches
        t0 = time.perf_counter()
        plan.run_steps(ARAP_MARGINAL_STEPS)
        torch.cuda.synchronize()
        times[li] = (time.perf_counter() - t0) / ARAP_MARGINAL_STEPS
        counts[li] = (fns[name].launches - n0) / ARAP_MARGINAL_STEPS
    lo, hi = ARAP_MARGINAL
    return (times[hi] - times[lo]) / (hi - lo) * 1e3, (counts[hi] - counts[lo]) / (hi - lo)


def phase_arap_256_bf16(tt):
    """Phase 27: ARAP 256², GN, lIterations ARAP_L_ITERATIONS, under
    block_dtype="bf16", in both edge orders, as phase 16 runs it: warmup(),
    run_steps(1) three times, run_steps(7); the costs after steps 0-3 and
    10 within ARAP_BF16_TRAJ_RTOL of the JAX package's bf16 trajectory and
    of the other order's; after step 3 the linear parts card vs the port's
    CPU path under block_dtype="bf16" (hold_linear_parts); both (3, 3)
    levels routed to and launching fused_pair_apply_atomics_bf16, no other
    fused pair.  Logs the step median, the launches a step and a PCG
    iteration, the eager marginal PCG iteration beside phase 16's f32 one,
    and the graphed one (steps_per_dispatch ARAP_MARGINAL_STEPS) in bf16
    and in f32.  Returns the launches of each order's 10 steps."""
    fns = counters()
    name = "fused_pair_apply_atomics_bf16"
    runs, traj = {}, {}
    for order in ("grouped", "shuffled"):
        label = f"ARAP {ARAP_SIDE}² GN bf16 {order}"
        plan = arap_plan(tt, ARAP_SIDE, order, "cuda",
                         ARAP_STEPS + 2 * (1 + ARAP_MARGINAL_STEPS), block_dtype="bf16")
        bsr = plan._prep["consts"][1]["bsr"]
        routes = level_routes(bsr, bf16=True)
        log(f"{label}: levels (W, N_t) -> kernel {routes}, initial cost {plan.final_cost!r}")
        if len(routes) != 1 or set(routes.values()) != {name}:
            raise AssertionError(f"{label}: levels route to {routes}, not {name}")
        plan.warmup()
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
        cpu_plan = arap_plan(tt, ARAP_SIDE, order, "cpu", block_dtype="bf16")
        cpu_plan._U = {k: v.cpu() for k, v in plan._U.items()}
        ref = linear_parts(cpu_plan, p)
        del cpu_plan
        for n, fn in fns.items():
            fn.launches = solve_launches[n]  # the check's own apply is not the solve's
        hold_linear_parts(label, got, ref)
        t0 = time.perf_counter()
        n = plan.run_steps(ARAP_STEPS - 3)
        torch.cuda.synchronize()
        batch = time.perf_counter() - t0
        costs.append(plan.final_cost)
        launches = {k: fn.launches for k, fn in fns.items()}
        runs[f"arap256 bf16 {order}"] = launches
        if n != ARAP_STEPS - 3 or plan.num_iterations != ARAP_STEPS:
            raise AssertionError(f"{label}: run_steps ran {n} steps, {plan.num_iterations} in all")
        per_step = step_s[1:] + [batch / n] * n
        slots = launches[name]
        log(f"{label} costs after steps 0-3 and {ARAP_STEPS}: {costs}")
        log(f"{label} step times: steps 1-3 {[round(t * 1e3, 2) for t in step_s]} ms, steps 4-"
            f"{ARAP_STEPS} one run_steps({n}) batch {batch * 1e3:.2f} ms; median of steps 2-"
            f"{ARAP_STEPS} {float(np.median(per_step)) * 1e3:.2f} ms")
        log(f"{label} launches over {ARAP_STEPS} steps {({k: v for k, v in launches.items() if v})}"
            f"; {name} {slots / ARAP_STEPS:.1f} a step, "
            f"{slots / (ARAP_STEPS * ARAP_L_ITERATIONS):.2f} a PCG iteration")
        stray = [k for k, v in launches.items() if v and k != name and k.startswith("fused_pair")]
        if slots <= 0 or stray:
            raise AssertionError(f"{label}: {name} launched {slots} times, other fused-pair "
                                 f"kernels {stray}")
        for u_name, U in plan.unknowns().items():
            if not bool(torch.isfinite(U).all()):
                raise AssertionError(f"{label}: non-finite unknowns {u_name}")
        traj[order] = dict(zip((0, 1, 2, 3, ARAP_STEPS), costs))
        for k, tol in ((0, GRID_LINEAR_RTOL),) + tuple(ARAP_BF16_TRAJ_RTOL.items()):
            ref_k = ARAP_JAX_BF16_COSTS[order][k]
            rel = abs(traj[order][k] - ref_k) / abs(ref_k)
            log(f"{label} step {k}: cost {traj[order][k]!r} vs JAX bf16 {ref_k!r}, rel "
                f"{rel:.3e} (limit {tol})")
            if not (np.isfinite(traj[order][k]) and rel <= tol):
                raise AssertionError(f"{label}, step {k}: cost {traj[order][k]} vs JAX {ref_k}")
        ms, per_iter = arap_marginal_ms(plan, fns, name)
        log(f"{label} marginal PCG iteration, eager: {ms:.4f} ms an iteration ({name} "
            f"{per_iter:.2f} launches an iteration); phase 16's f32 {order}: "
            f"{ARAP_F32_MARGINAL_MS.get(order, float('nan')):.4f} ms")
        del plan
    for k, tol in ARAP_BF16_TRAJ_RTOL.items():
        a, b = traj["shuffled"][k], traj["grouped"][k]
        rel = abs(a - b) / abs(b)
        log(f"ARAP {ARAP_SIDE}² GN bf16 step {k}: shuffled {a!r} vs grouped {b!r}, rel {rel:.3e}")
        if not rel <= tol:
            raise AssertionError(f"ARAP {ARAP_SIDE}² bf16, step {k}: the edge orders differ: "
                                 f"{a} vs {b}")
    # the graphed marginal PCG iteration, bf16 beside f32, in one call (a
    # replay runs no wrapper, so nothing is counted there)
    graphed = {}
    for dtype, counted in (("f32", "fused_pair_apply_atomics"), ("bf16", name)):
        extra = {"block_dtype": "bf16"} if dtype == "bf16" else {}
        plan = arap_plan(tt, ARAP_SIDE, "grouped", "cuda", 1000,
                         steps_per_dispatch=ARAP_MARGINAL_STEPS, **extra)
        graphed[dtype] = arap_marginal_ms(plan, fns, counted, warm=ARAP_MARGINAL_STEPS)[0]
        del plan
    log(f"ARAP {ARAP_SIDE}² GN grouped, graphed marginal PCG iteration (steps_per_dispatch "
        f"{ARAP_MARGINAL_STEPS}): bf16 {graphed['bf16']:.4f} ms, f32 {graphed['f32']:.4f} ms")
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


def full_plan(tt, name, device):
    """The port's plan of FULL[name] (scripts/torch_model_trajectory.py) at
    FULL_SIZE², initialised; and its step count."""
    from torch_model_trajectory import full_case
    from thallo_tpu_torch import models

    text, inputs, dims, solver, l_iterations, steps, q_tol = full_case(name, FULL_SIZE, models)
    plan = tt.load_energy(text).plan(dims, solver=solver, device=device)
    plan.set_solver_parameter("nIterations", steps)
    plan.set_solver_parameter("lIterations", l_iterations)
    if q_tol is not None:
        plan.set_solver_parameter("q_tolerance", q_tol)
    plan.init(inputs)
    return plan, steps


def blocked_busy(events):
    """Device busy seconds of the kernels that start inside a
    "thallo::blocked" range (the blocked contraction's setup and JᵀJ·p,
    solver/gn.py), as the profiler projects the range onto the device."""
    from torch_ba_profile import device_events

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "thallo::blocked"
                   and e.device_type == torch.autograd.DeviceType.CUDA)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device_events(events))
    inside = [k for k in kernels if any(a <= k[0] < b for a, b in spans)]
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in inside:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6


def phase_full_width(tt, name):
    """Phases 18 (deconvolution) and 19 (optical_flow) at FULL_SIZE²:
    plan.warmup(), then run_steps(1) per step with the cost read after
    each; every unknown finite; the costs within FULL_TRAJ_RTOL of JAX's
    trajectory (FULL_REFERENCE: f32 or f64); the blocked contraction at JAX's
    FULL_CON_BLOCK (deconvolution); at the initial unknowns the cost, -JᵀF,
    diag(JᵀJ) and JᵀJ·p of a seeded p on the card against the port's CPU
    path, within GRID_LINEAR_RTOL.  Logs the step
    times and their median, the peak memory the steps allocated beside
    the unblocked fiber, and one profiled step's device busy time (the
    blocked contraction's share)."""
    from torch_ba_profile import busy_seconds
    from torch_grid_profile import _step_copy

    label = f"{name} {FULL_SIZE}²"
    t0 = time.perf_counter()
    plan, steps = full_plan(tt, name, "cuda")
    torch.cuda.synchronize()
    log(f"{label}: init {time.perf_counter() - t0:.3f} s, initial cost {plan.final_cost!r}, "
        f"groups {[(gp.name, gp.schedule.value) for gp in plan.compiled.groups]}")
    blocked = [gp.group.con_block for gp in plan.compiled.groups
               if gp.group.con_block is not None]
    if name == "deconvolution":
        got = [(cb[0].dim.name, cb[1], cb[2]) for cb in blocked]
        log(f"{label}: contraction blocking {got}; JAX's {FULL_CON_BLOCK}")
        if got != [FULL_CON_BLOCK]:
            raise AssertionError(f"{label}: con_block {got}, JAX's {FULL_CON_BLOCK}")
        fiber = plan.compiled.groups[0].group.R * sum(
            int(np.prod([d.dim.size for d in s.dep_cons])) * s.image.channels * 4
            for s in plan.compiled.groups[0].group.uslots + plan.compiled.groups[0].group.cslots
            if s.dep_cons)
    # the linear parts at the initial unknowns, card vs the CPU path (later
    # -JᵀF is the small difference of large terms: deconvolution's energy
    # is quadratic, its first GN step lands near the minimum)
    rng = np.random.default_rng(11)
    p = {k: rng.normal(size=tuple(v.shape)).astype(np.float32) for k, v in plan._U.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = linear_parts(plan, p)
    torch.cuda.synchronize()
    log(f"{label}: peak memory of the setup and one JᵀJ·p "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e6:.1f} MB")
    t0 = time.perf_counter()
    cpu_plan, _ = full_plan(tt, name, "cpu")
    want = linear_parts(cpu_plan, p)
    del cpu_plan
    log(f"{label}: the CPU path's linear parts {time.perf_counter() - t0:.2f} s")
    rel = abs(got[0] - want[0]) / abs(want[0])
    log(f"{label}, step 0, card vs CPU: cost {got[0]!r} vs {want[0]!r}, rel {rel:.3e}")
    if not rel <= GRID_LINEAR_RTOL:
        raise AssertionError(f"{label}: cost, card {got[0]} vs CPU {want[0]}")
    for what, a, b in zip(("-JᵀF", "diag(JᵀJ)", "JᵀJ·p"), got[1:], want[1:]):
        for k in b:
            err = float(np.abs(a[k] - b[k]).max())
            scale = float(np.abs(b[k]).max())
            log(f"{label}, card vs CPU: {what} {k} max|diff| {err:.3e} = "
                f"{err / scale:.3e} x max|ref|")
            if not err <= GRID_LINEAR_RTOL * scale:
                raise AssertionError(f"{label}: {what} of {k}, card vs CPU, "
                                     f"{err} > {GRID_LINEAR_RTOL} x {scale}")
    del got, want

    t0 = time.perf_counter()
    plan.warmup()
    log(f"{label}: warmup {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    costs, step_s = [plan.final_cost], []
    for _ in range(steps):
        t0 = time.perf_counter()
        plan.run_steps(1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        costs.append(plan.final_cost)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"{label} costs after steps 0-{steps}: {costs}")
    log(f"{label} step times {[round(t * 1e3, 2) for t in step_s]} ms, median of steps 2-"
        f"{steps} {float(np.median(step_s[1:])) * 1e3:.2f} ms")
    log(f"{label}: peak memory the steps allocated {peak / 1e6:.1f} MB"
        + (f" (the unblocked fiber: {fiber / 1e6:.1f} MB)" if name == "deconvolution" else ""))
    for k, U in plan.unknowns().items():
        if not bool(torch.isfinite(U).all()):
            raise AssertionError(f"{label}: non-finite unknowns {k}")
    which = FULL_REFERENCE[name]
    refs = {"f32": FULL_JAX_F32_COSTS[name], "f64": FULL_JAX_F64_COSTS[name]}
    ref, tols = refs[which], FULL_TRAJ_RTOL[name]
    for k in range(steps + 1):
        rel = abs(costs[k] - ref[k]) / abs(ref[k])
        others = ", ".join(f"JAX in {w} {r[k]!r}, rel {abs(costs[k] - r[k]) / abs(r[k]):.3e}"
                           for w, r in refs.items() if w != which and r is not None)
        log(f"{label} step {k}: cost {costs[k]!r} vs JAX in {which} {ref[k]!r}, rel {rel:.3e} "
            f"(limit {tols[k]})" + (f"; vs {others}" if others else ""))
        if not (np.isfinite(costs[k]) and rel <= tols[k]):
            raise AssertionError(f"{label}, step {k}: cost {costs[k]} vs JAX in {which} {ref[k]}")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _step_copy(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = busy_seconds(events)
    log(f"{label}: profiled step wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, "
        f"idle share {1 - busy / wall:.3f}"
        + (f", blocked contraction {blocked_busy(events) * 1e3:.2f} ms of it" if blocked else ""))



def phase_f64_1m(ba, tt, scene, f32_final, bf16_final):
    """Phase 20(a): the uniform 1M LM solve under double_precision through
    the f64 oh_setup_products, fullrepeat_setup and persistent fused pair
    (no f32 kernel launched); costs never rising, final <= 1e-2 x initial,
    logged beside phases 4 and 9; the linear parts at the initial
    unknowns card vs CPU in f64.  Returns the launches."""
    label = "1M block-sparse f64"
    torch.cuda.reset_peak_memory_stats()
    costs, _, launches, plan = solve_1m(ba, tt, scene, label, (
        "fused_pair_apply_f64", "oh_setup_products_f64", "fullrepeat_setup_f64"), double=True)
    peak = torch.cuda.max_memory_allocated()
    stray = [n for n, k in launches.items() if k and not n.endswith("_f64")]
    if stray:
        raise AssertionError(f"{label}: f32 kernels launched: {stray}")
    if any(v.dtype != torch.float64 for v in plan.unknowns().values()):
        raise AssertionError(f"{label}: unknowns not f64")
    never_rising(label, costs)
    if not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"{label}: final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    log(f"{label}: final cost {costs[-1]!r} (f32, phase 4: {f32_final!r}; bf16 blocks, "
        f"phase 9: {bf16_final!r}); peak memory allocated {peak / 2 ** 20:.1f} MiB")
    del plan
    inputs, dims = scene
    rng = np.random.default_rng(17)
    p = {"cameras": rng.normal(size=(dims["C"], 9)), "points": rng.normal(size=(dims["P"], 3))}
    parts = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        plan = ba_plan(ba, tt, inputs, dims, dev, 1, double=True)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        parts[dev] = linear_parts(plan, p)
        del plan
        log(f"{label}: linear parts on {dev} {time.perf_counter() - t0:.2f} s")
    got, ref = parts["cuda"], parts["cpu"]
    rel = abs(got[0] - ref[0]) / abs(ref[0])
    log(f"{label}, initial unknowns, card vs CPU: cost rel {rel:.3e}")
    if not rel <= F64_LINEAR_RTOL:
        raise AssertionError(f"{label}: initial cost card {got[0]} vs CPU {ref[0]}")
    for what, a, b in zip(("-JᵀF", "diag(JᵀJ)", "JᵀJ·p"), got[1:], ref[1:]):
        for name in b:
            err, scale = float(np.abs(a[name] - b[name]).max()), float(np.abs(b[name]).max())
            log(f"{label}, card vs CPU: {what} {name} {err / scale:.3e} x max|ref|")
            if not (a[name].dtype == np.float64 and err <= F64_LINEAR_RTOL * scale):
                raise AssertionError(f"{label}: {what} of {name}, card vs CPU, {err} > "
                                     f"{F64_LINEAR_RTOL} x {scale}")
    return launches


def phase_arap_f64(tt):
    """Phase 20(b): ARAP 256² GN under double_precision, grouped edges,
    warmup() and ARAP_STEPS run_steps(1): the reg group's two (3, 3) col
    pairs through the f64 atomics body fused_pair_route names for them
    (no other fused pair; each body's launches logged); the costs within
    ARAP_F64_RTOL of JAX's f64 run.  Returns the launches."""
    from thallo_tpu_torch.ops import fusedpair

    label = f"ARAP {ARAP_SIDE}² GN f64"
    S = ARAP_SIDE * ARAP_SIDE
    route = fusedpair.fused_pair_route(4, S, 3, 3, S, dtype=torch.float64)
    fns = counters()
    plan = arap_plan(tt, ARAP_SIDE, "grouped", "cuda", double=True)
    plan.warmup()
    for fn in fns.values():
        fn.launches = 0
    costs, step_s = [plan.final_cost], []
    for _ in range(ARAP_STEPS):
        t0 = time.perf_counter()
        plan.run_steps(1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        costs.append(plan.final_cost)
    launches = {n: fn.launches for n, fn in fns.items()}
    atomics = launches[route]
    stray = [n for n, k in launches.items() if k and n != route and n.startswith("fused_pair")]
    log(f"{label} costs {costs}; launches {({n: k for n, k in launches.items() if k})}; "
        f"median step of 2-{ARAP_STEPS} {float(np.median(step_s[1:])) * 1e3:.2f} ms")
    log(f"{label} atomics bodies: the slots kernel "
        f"{launches['fused_pair_apply_atomics_f64']} launches, the first body "
        f"{launches['fused_pair_apply_atomics_thread_f64']}")
    if atomics <= 0 or stray:
        raise AssertionError(f"{label}: {route} launched {atomics} times, "
                             f"other fused-pair kernels {stray}")
    for k, tol in ARAP_F64_RTOL.items():
        ref = ARAP_JAX_F64_COSTS[k]
        rel = abs(costs[k] - ref) / abs(ref)
        log(f"{label} step {k}: cost {costs[k]!r} vs JAX f64 {ref!r}, rel {rel:.3e} "
            f"(limit {tol})")
        if not (np.isfinite(costs[k]) and rel <= tol):
            raise AssertionError(f"{label}, step {k}: cost {costs[k]} vs JAX f64 {ref}")
    return launches


def phase_schur_skew_f64(ba, tt):
    """Phase 20(c): phase 12's small skewed scene under schur_dense in f64,
    card vs CPU, SCHUR_SMALL_STEPS steps: the witness for
    SCHUR_COST_FLOOR.  The steps within phase 12's f32 bounds over 1e3
    (SCHUR_F64), and the largest cost split below SCHUR_COST_FLOOR / 1e3
    x c0: in f64 the two devices take the same steps."""
    inputs, dims = make_skew_scene(ba, *SKEW_SMALL)
    runs = {}
    for dev in ("cuda", "cpu"):
        plan = ba_plan(ba, tt, inputs, dims, dev, SCHUR_SMALL_STEPS, double=True,
                       linear_solver="schur_dense")
        costs = [plan.init({k: np.copy(v) for k, v in inputs.items()})]
        Us = []
        for _ in range(SCHUR_SMALL_STEPS):
            plan.step()
            costs.append(plan.cost())
            Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
        runs[dev] = (costs, Us)
    (cg, Ug), (cc, Uc) = runs["cuda"], runs["cpu"]
    label = "small skewed scene schur_dense f64 cuda vs cpu"
    split = max(abs(a - b) for a, b in zip(cg, cc)) / abs(cc[0])
    log(f"{label}: costs cuda {cg}, cpu {cc}; largest split {split:.3e} x c0 "
        f"(f32 floor {SCHUR_COST_FLOOR:g})")
    u_tol, c_tol = (x / 1e3 for x in SCHUR_TRAJ["small skewed"])
    check_steps(label, cg, Ug, cc, Uc, u_tol, c_tol)
    never_rising(label, cg)
    if not split <= SCHUR_COST_FLOOR / 1e3:
        raise AssertionError(f"{label}: the f64 runs split by {split:.3e} x c0")


def phase_f64_models(tt):
    """Phase 20(e): F64_MODELS at their test sizes card vs CPU in f64,
    their tiny scatters through the fixed-order kernel's f64 instantiation
    (segment_sum_fixed_order_f64, reached by segment_sum_f64) and no f32
    kernel."""
    for name, (u_tol, c_tol) in F64_MODELS.items():
        label = f"model {name} f64"
        lg, _, plan = card_vs_cpu(label, lambda d, name=name: model_plan(tt, name, d, False,
                                                                        double=True),
                                  MODEL_STEPS, u_tol, c_tol)
        stray = [n for n, k in lg.items() if k and not n.endswith("_f64")]
        if lg["segment_sum_fixed_order_f64"] <= 0 or stray:
            raise AssertionError(f"{label}: segment_sum_fixed_order_f64 launched "
                                 f"{lg['segment_sum_fixed_order_f64']} times, f32 kernels {stray}")


def phase_precompute_j_f64(ba, tt, scene, f32_final):
    """Phase 20(d): phase 5 in f64: the uniform 1M LM solve under
    PRECOMPUTE_J through oh_setup_aggregate_f64 (no f32 kernel), costs
    never rising, its first CROSS_STEPS steps against the f64
    block-sparse solve (jacobi) within F64_CROSS; the final cost logged
    beside phase 5's.  Returns the launches."""
    label = "1M PRECOMPUTE_J f64"
    costs, Us, launches, _ = solve_1m(ba, tt, scene, label, ("oh_setup_aggregate_f64",),
                                      schedule="J", keep_unknowns=CROSS_STEPS,
                                      preconditioner="jacobi", double=True)
    stray = [n for n, k in launches.items() if k and not n.endswith("_f64")]
    if stray:
        raise AssertionError(f"{label}: f32 kernels launched: {stray}")
    never_rising(label, costs)
    log(f"{label}: final cost {costs[-1]!r} (f32, phase 5: {f32_final!r})")
    ref_costs, ref_Us, _, _ = solve_1m(ba, tt, scene, "1M block-sparse f64, jacobi",
                                       ("fused_pair_apply_f64",), n_steps=CROSS_STEPS,
                                       keep_unknowns=CROSS_STEPS, preconditioner="jacobi",
                                       double=True)
    check_steps(f"{label} vs block-sparse f64 (jacobi)", costs[:CROSS_STEPS + 1], Us,
                ref_costs, ref_Us, *F64_CROSS)
    return launches, (costs, Us)


def _coo(plan):
    r, rows, cols, vals, shape = plan.jacobian()
    return {"r": r.cpu(), "rows": rows.cpu(), "cols": cols.cpu(), "vals": vals.cpu(),
            "shape": shape}


def phase_jacobian(ba, tt, scene):
    """Phase 21: Plan.jacobian.  The small BA scene (dense JᵀJ) and
    image_warping 64² with its excluded square: COO card vs CPU (the same
    rows, cols and shape; values and residuals within JAC_TOL).  The
    uniform 1M scene: Jᵀr from the card's COO by index_add_ against the
    solver's -JᵀF (its block-sparse setup) within JAC_TOL x max|ref|; the
    COO's entries and bytes logged."""
    from torch_grid_profile import make_grid_plan

    C, P, W, seed = SCHUR_SMALL
    small, _ = ba.synthetic_inputs(n_cameras=C, n_points=P, obs_per_point=W, seed=seed)
    sdims = {"C": C, "P": P, "O": len(small["oToC"])}

    def small_plan(dev):
        plan = ba_plan(ba, tt, small, sdims, dev, 1)
        plan.init({k: np.copy(v) for k, v in small.items()})
        return plan

    makes = {"small BA": small_plan,
             f"image_warping {GRID_SMALL}² masked":
                 lambda dev: make_grid_plan(GRID_SMALL, dev, mask=GRID_MASK)}
    for label, make in makes.items():
        got, ref = _coo(make("cuda")), _coo(make("cpu"))
        if got["shape"] != ref["shape"] or not all(torch.equal(got[k], ref[k])
                                                   for k in ("rows", "cols")):
            raise AssertionError(f"jacobian {label}: card and CPU COO index differently")
        for k in ("vals", "r"):
            err = float((got[k] - ref[k]).abs().max())
            scale = float(ref[k].abs().max())
            log(f"jacobian {label}: {k} card vs CPU {err / scale:.3e} x max|ref|, "
                f"{got['vals'].numel()} entries, shape {got['shape']}")
            if not err <= JAC_TOL * scale:
                raise AssertionError(f"jacobian {label}: {k} card vs CPU {err} > "
                                     f"{JAC_TOL} x {scale}")
    inputs, dims = scene
    plan = ba_plan(ba, tt, inputs, dims, "cuda", 1)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, rows, cols, vals, (n_rows, n_cols) = plan.jacobian()
    torch.cuda.synchronize()
    t_coo = time.perf_counter() - t0
    jtr = torch.zeros(n_cols, dtype=vals.dtype, device=vals.device).index_add_(
        0, cols, vals * r[rows])
    comp, ins, consts = plan.compiled, plan._step_inputs(), plan._prep["consts"]
    masks = comp.masks(ins, plan._U, plan._prep.get("masks_static"),
                       plan._prep.get("exclude_consts"))
    ref = -comp.flatten_U(comp.jtf_and_diag(plan._U, ins, consts, masks, {})[0])
    err, scale = float((jtr - ref).abs().max()), float(ref.abs().max())
    log(f"jacobian 1M: {vals.numel()} entries ({n_rows} x {n_cols}), "
        f"{nbytes(r, rows, cols, vals) / 2 ** 20:.1f} MiB, built in {t_coo:.3f} s; Jᵀr vs "
        f"-JᵀF {err / scale:.3e} x max|ref|")
    if not err <= JAC_TOL * scale:
        raise AssertionError(f"jacobian 1M: Jᵀr from the COO vs -JᵀF {err} > {JAC_TOL} x {scale}")


def phase_drivers(tt):
    """Phase 22: the drivers on the card: run_model on RUN_MODELS, every
    gallery row (synthetic and file) with its cost falling, and the
    timer's summary of an image_warping solve at timing levels 1 and 2;
    compile_check on ARAP's energy at its default dims, on the card."""
    import tempfile

    from thallo_tpu_torch.examples import gallery, run_model
    from thallo_tpu_torch.models import arap_mesh_deformation as arap
    from thallo_tpu_torch.models import image_warping as iw
    from thallo_tpu_torch.utils.compile_check import compile_check

    for model in RUN_MODELS:
        out = run_model.main([model, "--device", "cuda", "--iters", str(DRIVER_STEPS),
                              "--verbosity", "0"])
        if not out["final_cost"] < out["initial_cost"]:
            raise AssertionError(f"run_model {model}: cost {out['initial_cost']} -> "
                                 f"{out['final_cost']}")
    rows = gallery.main(["--device", "cuda"])  # raises if a row failed
    falling = [r[0] for r in rows if r[4] < r[3]]
    log(f"gallery: {len(falling)} of {len(rows)} rows with a falling cost")
    if len(falling) != len(rows):
        raise AssertionError(f"gallery: costs not falling in {set(r[0] for r in rows) - set(falling)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "arap_energy.py"
        path.write_text(arap.ENERGY)
        plan = compile_check(str(path))  # the card by default
        if plan.device.type != "cuda":
            raise AssertionError(f"compile_check planned on {plan.device}, not the card")
        log(f"compile_check on ARAP's energy at its default dims: {plan.device}, groups "
            + ", ".join(f"{g.name}[{g.schedule.value}]" for g in plan.compiled.groups))
    for level in (1, 2):
        plan = tt.load_energy(iw.ENERGY).plan({"W": 64, "H": 64}, solver="levenberg_marquardt",
                                              device="cuda", timing_level=level)
        plan.set_solver_parameter("nIterations", DRIVER_STEPS)
        plan.init(iw.synthetic_inputs(64, 64))
        plan.solve()
        summary = plan.get_performance_summary()
        want = {"Total", "Nonlinear Iteration"} | (
            {"Nonlinear Setup", "Linear Solve", "Nonlinear Finish"} if level >= 2 else set())
        if not want <= set(summary.stats):
            raise AssertionError(f"timing_level {level}: events {sorted(summary.stats)}")
        log(f"image_warping 64² LM, timing_level {level}:\n{summary.markdown()}")


def profiled_step(label, plan):
    """One step on copies of the plan's state under torch.profiler: its
    wall time, device busy time and idle share, logged; (wall, busy) s."""
    from torch_ba_profile import busy_seconds
    from torch_grid_profile import _step_copy

    _step_copy(plan)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _step_copy(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_seconds(prof.events())
    log(f"{label}: profiled step wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, "
        f"idle share {1 - busy / wall:.3f}")
    return wall, busy


@contextlib.contextmanager
def own_store():
    """THALLO_MEASUREMENTS at an empty store in a temporary directory while
    the block runs; yields the directory."""
    import tempfile

    old = os.environ.get("THALLO_MEASUREMENTS")
    with tempfile.TemporaryDirectory() as d:
        os.environ["THALLO_MEASUREMENTS"] = str(Path(d) / "measurements.json")
        try:
            yield Path(d)
        finally:
            if old is None:
                del os.environ["THALLO_MEASUREMENTS"]
            else:
                os.environ["THALLO_MEASUREMENTS"] = old


# the kernels each schedule of the BA group launches on the 1M scene
SCHED_KERNELS = {"precompute_jtj": ("fused_pair_apply", "oh_setup_products", "fullrepeat_setup"),
                 "linearize": ("oh_setup_aggregate",), "inline": ("oh_setup_aggregate",),
                 "precompute_j": ("oh_setup_aggregate",),
                 "apply_separately": ("oh_setup_aggregate",)}


def phase_schedule_ba(ba, tt, scene, ref, ref_f64):
    """Phase 23(a)-(b) (the module docstring).  Returns the launches of
    each run."""
    from thallo_tpu_torch import lower
    from thallo_tpu_torch.ops import segsum

    runs = {}
    with own_store():
        inputs, dims = scene
        label = "1M heuristic (use_autoscheduler=1)"
        chosen = ba_plan(ba, tt, inputs, dims, "cuda", 1, use_autoscheduler=1)
        for line in chosen.schedule_log:
            log(f"{label}: {line}")
        schedule = chosen.compiled.groups[0].schedule.value
        del chosen
        costs, _, runs["heuristic"], plan = solve_1m(ba, tt, scene, label,
                                                     SCHED_KERNELS[schedule],
                                                     use_autoscheduler=1)
        if plan.compiled.groups[0].schedule.value != schedule:
            raise AssertionError(f"{label}: planned {schedule}, solved "
                                 f"{plan.compiled.groups[0].schedule.value}")
        never_rising(label, costs)
        if not costs[-1] <= 1e-2 * costs[0]:
            raise AssertionError(f"{label}: final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
        profiled_step(f"{label}, {schedule}", plan)
        del plan

    variants = (("linearize", "1M LINEARIZE (use_autoscheduler=2)", 2, False, False),
                ("inline", "1M INLINE (exhaustive candidate 1)", 4, False, False),
                ("inline tiled", "1M INLINE, THALLO_SEGSUM=tiled", 4, True, False),
                ("inline f64 tiled", "1M INLINE f64, THALLO_SEGSUM=tiled", 4, True, True))
    for key, label, mode, tiled, double in variants:
        want = "segment_sum_f64" if double else "segment_sum" if tiled else "oh_setup_aggregate"
        if tiled:
            os.environ["THALLO_SEGSUM"] = "tiled"  # read by plan.init
        bodies0 = dict(segsum.BODY_LAUNCHES)
        try:
            with own_store(), tally(lower, "segment_sum", lambda data, plan: plan.num_segments,
                                    segsum.segment_sum_f64 if double else None) as by_plan, \
                    tally(lower, "oh_setup_aggregate", lambda parts, ids, N: N) as by_n:
                costs, Us, launches, plan = solve_1m(
                    ba, tt, scene, label, (want,), n_steps=SCHED_BA_STEPS,
                    keep_unknowns=SCHED_BA_STEPS, use_autoscheduler=mode, double=double)
        finally:
            os.environ.pop("THALLO_SEGSUM", None)
        got = plan.compiled.groups[0].schedule.value
        if got != key.split()[0]:
            raise AssertionError(f"{label}: schedule {got}")
        log(f"{label}: segment_sum launches by plan (segments) {dict(by_plan)}, "
            f"oh_setup_aggregate launches by image size {dict(by_n)}; segment sum bodies "
            f"{({k: v - bodies0.get(k, 0) for k, v in segsum.BODY_LAUNCHES.items()})}")
        if tiled:
            launches[want] = by_plan[dims["P"]]
            launches[want + "_cameras"] = by_plan[dims["C"]]
            if min(by_plan[dims["P"]], by_plan[dims["C"]]) <= 0 or sum(by_n.values()):
                raise AssertionError(f"{label}: not every transpose went through the "
                                     "segment sum")
        elif by_n[dims["C"]] <= 0:
            raise AssertionError(f"{label}: the camera transposes never launched "
                                 "oh_setup_aggregate")
        runs[key] = launches
        never_rising(label, costs)
        base = ref_f64 if double else ref
        check_steps(f"{label} vs PRECOMPUTE_J{' f64' if double else ''} (jacobi)",
                    costs[:SCHED_BA_STEPS + 1], Us, base[0], base[1],
                    *(F64_CROSS if double else SCHED_BA_TRAJ))
        profiled_step(label, plan)
        del plan
    return runs


def arap_sched_plan(tt, inputs, **options):
    """A GN plan of ARAP 256² (lIterations ARAP_L_ITERATIONS) under `options`,
    initialized."""
    from thallo_tpu_torch.models import arap_mesh_deformation as arap

    plan = tt.load_energy(arap.ENERGY).plan({"N": ARAP_SIDE ** 2, "E": len(inputs["V0"])},
                                            solver="gauss_newton", device="cuda", **options)
    plan.set_solver_parameter("lIterations", ARAP_L_ITERATIONS)
    plan.set_solver_parameter("nIterations", 10_000)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    return plan


def arap_costs(plan, steps):
    costs = [plan.final_cost]
    for _ in range(steps):
        plan.step()
        costs.append(plan.cost())
    return costs


def ranks(x):
    """Ranks of x from 0, ties at their mean rank (Spearman's)."""
    x = np.asarray(x, np.float64)
    r = np.empty(len(x))
    r[np.argsort(x, kind="stable")] = np.arange(len(x))
    for v in np.unique(x):
        r[x == v] = r[x == v].mean()
    return r


def phase_schedule_arap(tt):
    """Phase 23(c) (the module docstring)."""
    from thallo_tpu_torch.autotune import autoschedule_search
    from thallo_tpu_torch.models import arap_mesh_deformation as arap
    from thallo_tpu_torch.schedule import estimate_group_cost

    label = f"ARAP {ARAP_SIDE}² GN"
    inputs = arap.synthetic_inputs(side=ARAP_SIDE)
    n = 1 + SCHED_ARAP_STEPS
    with own_store() as d:
        lin = arap_sched_plan(tt, inputs, use_autoscheduler=2)
        scheds = [gp.schedule.value for gp in lin.compiled.groups]
        lin_costs = arap_costs(lin, n)
        del lin
        refs = {"scalar": arap_costs(arap_sched_plan(tt, inputs, preconditioner="jacobi"), n),
                "block": arap_costs(arap_sched_plan(tt, inputs), n)}
        log(f"{label} use_autoscheduler=2 {scheds}: costs {lin_costs}; the default plan "
            f"under scalar Jacobi {refs['scalar']}, block-Jacobi {refs['block']}")
        if scheds != ["linearize", "linearize"]:
            raise AssertionError(f"{label} use_autoscheduler=2: schedules {scheds}")
        for k, tol in ((1, ARAP_TRAJ_RTOL[1]), (2, ARAP_TRAJ_RTOL[2]), (3, ARAP_TRAJ_RTOL[3])):
            rel = abs(lin_costs[k] - refs["scalar"][k]) / abs(refs["scalar"][k])
            if not (np.isfinite(lin_costs[k]) and rel <= tol):
                raise AssertionError(f"{label} LINEARIZE, step {k}: cost {lin_costs[k]} vs "
                                     f"{refs['scalar'][k]} (rel {rel:.3e} > {tol})")

        t0 = time.perf_counter()
        best, results = autoschedule_search(
            arap.make_spec, {"N": ARAP_SIDE ** 2, "E": len(inputs["V0"])},
            lambda: {k: np.copy(v) for k, v in inputs.items()}, solver="gauss_newton",
            n_steps=SCHED_ARAP_STEPS, l_iters=ARAP_L_ITERATIONS,
            max_candidates=SCHED_ARAP_CANDIDATES, log_path=str(d / "schedules.txt"),
            verbose=False)
        log(f"{label} autoschedule_search over {len(results)} candidates: "
            f"{time.perf_counter() - t0:.2f} s")
        if len(results) != SCHED_ARAP_CANDIDATES:
            raise AssertionError(f"{label}: {len(results)} candidates measured")
        est = []
        for idx, sch, dt, cost in results:
            groups = tt.load_energy(arap.ENERGY).plan(
                {"N": ARAP_SIDE ** 2, "E": len(inputs["V0"])}, solver="gauss_newton",
                device="cuda", use_autoscheduler=3 + idx).compiled.groups
            est.append(sum(estimate_group_cost(gp, gp.schedule, ARAP_L_ITERATIONS)[0]
                           for gp in groups))
            ref = refs["block" if sch[1] == "precompute_jtj" else "scalar"][n]
            rel = abs(cost - ref) / abs(ref)
            log(f"{label} candidate {idx} fit={sch[0]} reg={sch[1]}: {dt * 1e3:.3f} ms/step, "
                f"est {est[-1]:.4g} bytes, cost after {n} steps {cost!r} (rel {rel:.3e} to "
                f"its preconditioner's run)")
            if not (np.isfinite(cost) and rel <= SCHED_ARAP_RTOL):
                raise AssertionError(f"{label} candidate {idx} {sch}: cost {cost} vs {ref}")
        measured = [r[2] for r in results]
        rho = float(np.corrcoef(ranks(est), ranks(measured))[0, 1])
        win = min(results, key=lambda r: r[2])
        log(f"{label}: estimated vs measured rank correlation (Spearman) {rho:.3f}; measured "
            f"winner candidate {win[0]} {win[1]} {win[2] * 1e3:.3f} ms/step, estimated best "
            f"candidate {int(np.argmin(est))} {results[int(np.argmin(est))][1]}")
        del best
        heur = tt.load_energy(arap.ENERGY).plan(
            {"N": ARAP_SIDE ** 2, "E": len(inputs["V0"])}, solver="gauss_newton",
            device="cuda", use_autoscheduler=1)
        for line in heur.schedule_log:
            log(f"{label} use_autoscheduler=1 on the measured store: {line}")
        picked = [gp.schedule.value for gp in heur.compiled.groups]
        if picked != list(win[1]):
            raise AssertionError(f"{label}: the heuristic picked {picked}, the measured winner "
                                 f"is {win[1]}")


def _state_of(plan):
    return {k: v.cpu().numpy() for k, v in plan.unknowns().items()}, plan.cost()


def _u_rel(a, b):
    return max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b)


def within_spread(spread, got, floors=(STEP_U_TOL, STEP_COST_RTOL), exact=True):
    """Phase 24's rule (DISPATCH_SPREAD_X): a run's distance `got` =
    (unknowns, cost) from the farthest of a path's repeated runs against
    their `spread`, each limit at least its floor, bit for bit where the
    runs all agree (exact; off for a run on another device); the limits."""
    if exact and spread == (0.0, 0.0):
        return got == (0.0, 0.0), (0.0, 0.0)
    lim = tuple(max(DISPATCH_SPREAD_X * s, f) for s, f in zip(spread, floors))
    return got[0] <= lim[0] and got[1] <= lim[1], lim


def held_by_spread(runs, tested, c0, floors, exact=True):
    """Phase 24's rule at one point of a path, for phases 12 and 24-26:
    `runs` are the path's repeated runs and `tested` a run held against
    them, each (unknowns, a cost or a list of costs); the distance of two
    is (max|dU|/max|U|, max|d cost|/|c0|), the spread the largest distance
    of two of `runs`, and `tested` must lie within_spread of the farthest.
    Returns (ok, spread, the farthest distance, the limits, pairs)."""
    def dist(a, b):
        return _u_rel(a[0], b[0]), float(np.max(np.abs(np.subtract(a[1], b[1])))) / abs(c0)

    pairs = [dist(a, b) for i, a in enumerate(runs) for b in runs[i + 1:]]
    spread = (max(p[0] for p in pairs), max(p[1] for p in pairs))
    got = [dist(tested, r) for r in runs]
    far = (max(g[0] for g in got), max(g[1] for g in got))
    ok, lim = within_spread(spread, far, floors, exact)
    return ok and bool(np.all(np.isfinite(tested[1]))), spread, far, lim, len(pairs)


def more_runs_while_they_differ(runs, make_run, differ, others=()):
    """Phase 24's repeats: make_run() appended to `runs` until they are
    two, or DISPATCH_EAGER_RUNS where the first differs (differ(a, b):
    not bit for bit) from a later one or from one of `others`."""
    while len(runs) < 2 or (len(runs) < DISPATCH_EAGER_RUNS and
                            any(differ(runs[0], r) for r in [*runs[1:], *others])):
        runs.append(make_run())
    return runs


def _batches(plan, sizes):
    """run_steps(n) for each n of sizes, each ended by a sync: [(ms a step
    of the batch, unknowns, cost)]."""
    out = []
    for n in sizes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan.run_steps(n)
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) / n * 1e3, *_state_of(plan)))
    return out


def graphed_dispatch_busy(label, plan):
    """One dispatch of the plan's step graph (steps_per_dispatch replays,
    on copies of its state) under torch.profiler: host wall, device busy,
    idle share, logged; and the replays' device time by CUDA events."""
    from torch_ba_profile import busy_seconds, device_events

    k = plan.steps_per_dispatch
    graph = plan._step_graph()
    ran = torch.zeros((), dtype=torch.int64, device="cuda")
    graph.run(plan._U, plan._lm, ran, k)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph.run(plan._U, plan._lm, ran, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_seconds(prof.events())
    launches = len(device_events(prof.events())) / k
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    graph.run(plan._U, plan._lm, ran, k)
    end.record()
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    log(f"{label}: one graphed dispatch of {k} steps under the profiler: wall "
        f"{wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, idle share "
        f"{1 - busy / wall:.3f}, {launches:.0f} device kernels and copies a replayed step; "
        f"unprofiled: wall {bare * 1e3:.2f} ms ({bare / k * 1e3:.2f} a "
        f"step), CUDA events around the replays {start.elapsed_time(end):.2f} ms, idle share "
        f"against the profiled busy time {max(0.0, 1 - busy / bare):.3f}")
    return wall, busy


def hold_vs_eager(label, make, sizes, tested, profile=True, u_calls=None):
    """Phase 24's rule, one for phases 24(a), (b) and 25: eager plans
    make(1), two, and DISPATCH_EAGER_RUNS of them where the first two
    differ or a tested run differs from them (bit for bit only where every
    eager run agrees), and each plan of `tested` ({run: factory}), each
    after warmup(), through the run_steps calls `sizes`: each tested run after
    each call within_spread of every eager run (the spread: the largest
    distance of two eager runs there; floors STEP_U_TOL and
    DISPATCH_COST_FLOOR); past the first `u_calls` calls (None: every
    call holds both) the cost alone where the eager runs differ; ms a step
    by call logged; with `profile`, one dispatch of each graphed tested
    plan profiled.  Returns (the last eager plan, {run: wrapper launches during its warmup()}, {run:
    launches during its warmup() and calls (a graph's replays launch
    through no wrapper: its capture counts)}, {run: [(ms a step, unknowns,
    cost)] by call}, the initial cost)."""
    fns = counters()
    runs, warm, ran = {}, {}, {}

    def go(name, plan):
        n0 = {n: fn.launches for n, fn in fns.items()}
        t0 = time.perf_counter()
        plan.warmup()  # k > 1: the capture, and the eager throwaway step
        torch.cuda.synchronize()
        n1 = {n: fn.launches for n, fn in fns.items()}
        warm[name] = {n: n1[n] - n0[n] for n in fns}
        log(f"{label} {name}: warmup {time.perf_counter() - t0:.3f} s")
        runs[name] = _batches(plan, sizes)
        ran[name] = {n: fn.launches - n0[n] for n, fn in fns.items() if fn.launches > n0[n]}
        log(f"{label} {name}: ms a step by call {[round(r[0], 3) for r in runs[name]]}, "
            f"costs {[r[2] for r in runs[name]]}")

    def differ(a, b):
        return any(x[2] != y[2] or _u_rel(x[1], y[1]) != 0.0 for x, y in zip(a, b))

    eager_names = []

    def eager_run():
        nonlocal eager, c0
        name = f"eager {len(eager_names) + 1}"
        eager = make(1)
        c0 = eager.cost()
        go(name, eager)
        return name

    def names_differ(a, b):
        return differ(runs[a], runs[b])

    eager = c0 = None
    more_runs_while_they_differ(eager_names, eager_run, names_differ)
    for name, factory in tested.items():
        plan = factory()
        go(name, plan)
        if plan.steps_per_dispatch > 1 and profile:
            graphed_dispatch_busy(label, plan)
        del plan
    # two eager runs of a path with atomics may agree by chance: a tested
    # run that differs from them calls for the spread of more
    more_runs_while_they_differ(eager_names, eager_run, names_differ, list(tested))

    for j in range(len(sizes)):
        eager_j = [runs[n][j][1:] for n in eager_names]
        for name in tested:
            ok, spread, far, (lu, lc), n_pairs = held_by_spread(
                eager_j, runs[name][j][1:], c0, (STEP_U_TOL, DISPATCH_COST_FLOOR))
            cost_only = u_calls is not None and j >= u_calls and spread != (0.0, 0.0)
            if cost_only:
                ok = far[1] <= lc and np.isfinite(runs[name][j][2])
            log(f"{label} {name} after call {j + 1}"
                f"{' (the cost alone held)' if cost_only else ''}: {len(eager_j)} eager runs' spread "
                f"(largest of {n_pairs} pairs) max|dU|/max|U| {spread[0]:.3e}, cost "
                f"{spread[1]:.3e} x c0; {name} vs the farthest eager run {far[0]:.3e}, "
                f"{far[1]:.3e} (limits {lu:.3e}, {lc:.3e}); costs eager "
                f"{[e[1] for e in eager_j]}, {name} {runs[name][j][2]!r}, c0 {c0!r}")
            if not ok:
                raise AssertionError(f"{label}, call {j + 1}: {name} run off the eager runs")
    return eager, warm, ran, runs, c0


def phase_dispatch_1m(ba, tt, scene, skew_scene):
    """Phase 24(a), (b), (e), (f) (the module docstring)."""
    import tempfile

    def make(scene):
        inputs, dims = scene

        def plan_at(k):
            plan = ba_plan(ba, tt, inputs, dims, "cuda", 100, steps_per_dispatch=k)
            plan.init({n: np.copy(v) for n, v in inputs.items()})
            return plan
        return plan_at

    plan_at = make(scene)
    eager = hold_vs_eager(f"1M LM steps_per_dispatch={DISPATCH_1M_K}", plan_at,
                          [DISPATCH_1M_K] * DISPATCH_1M_BATCHES,
                          {"graphed": lambda: plan_at(DISPATCH_1M_K)},
                          u_calls=DISPATCH_1M_U_CALLS)[0]
    if eager._finished:  # an LM stop: (e) and (f) step it again from the start
        eager.reset_unknowns()

    # (e) the production step's own kernels, and (f) one traced step
    eager.kernel_stats(interior=True)
    rows = {k: v for k, v in eager.get_performance_summary().stats.items()
            if k.startswith("interior:")}
    for k, v in rows.items():
        log(f"1M kernel_stats(interior=True) {k}: {v['total_ms']:.4f} ms")
    missing = [n for n in INTERIOR_KERNELS if not any(n in k for k in rows)]
    if missing:
        raise AssertionError(f"1M kernel_stats(interior=True): no row names {missing}")
    with tempfile.TemporaryDirectory() as d:
        eager.trace_dir = d
        eager.set_solver_parameter("nIterations", eager.num_iterations + 1)
        eager.solve()
        files = list(Path(d).glob("*.json"))
        names = {e.get("name", "") for f in files for e in json.loads(f.read_text())
                 .get("traceEvents", [])}
        log(f"1M trace_dir: {[f.name for f in files]}, "
            f"{sum(f.stat().st_size for f in files)} bytes, {len(names)} event names")
        want = {"thallo::setup", "thallo::pcg", "thallo::finish"}
        if len(files) != 1 or not want <= names or \
                not any(n in e for e in names for n in INTERIOR_KERNELS):
            raise AssertionError(f"1M trace_dir: {len(files)} files, phases "
                                 f"{sorted(want & names)}, no hand-written kernel named")
    del eager

    # (b) the skewed scene: its level tables and W-loop pair inside the capture
    label = f"skewed 1M LM steps_per_dispatch=2, {DISPATCH_SKEW_STEPS} steps"
    skew_at = make(skew_scene)
    warm = hold_vs_eager(label, skew_at, [DISPATCH_SKEW_STEPS], {"graphed": lambda: skew_at(2)},
                         profile=False)[1]
    wloop = {n: w["fused_pair_apply_wloop"] for n, w in warm.items()}
    log(f"{label}: fused_pair_apply_wloop launches in warmup() {wloop}")
    # warmup(): one eager step; at k = 2 also the graph's warm-up step and
    # the capture, each one step's launches
    if not 0 < 3 * wloop["eager 1"] == wloop["graphed"]:
        raise AssertionError(f"{label}: the W-loop pair is not in the captured step")


def phase_dispatch_grid(tt):
    """Phase 24(c), (e)'s probe rows and (g) (the module docstring)."""
    from torch_grid_profile import make_grid_plan

    from thallo_tpu_torch.utils.roofline import roofline

    cases = {"ARAP": (lambda k: arap_plan(tt, ARAP_SIDE, "grouped", "cuda",
                                          steps_per_dispatch=k),
                      ARAP_JAX_COSTS["grouped"][ARAP_STEPS], ARAP_TRAJ_RTOL[ARAP_STEPS]),
             "image_warping": (lambda k: make_grid_plan(GRID_SIZE, "cuda",
                                                        l_iterations=GRID_L_ITERATIONS,
                                                        n_iter=GRID_STEPS,
                                                        steps_per_dispatch=k),
                               GRID_JAX_COSTS[GRID_STEPS], GRID_TRAJ_RTOL[GRID_STEPS])}
    for name, (make, ref, tol) in cases.items():
        label = f"{name} GN solve() at steps_per_dispatch={DISPATCH_GRID_K}"
        ms = {}
        for k in (1, DISPATCH_GRID_K):
            plan = make(k)
            plan.warmup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = plan.solve()
            ms[k] = (time.perf_counter() - t0) / plan.num_iterations * 1e3
            rel = abs(final - ref) / abs(ref)
            log(f"{label}, k={k}: {ms[k]:.2f} ms a step over {plan.num_iterations} steps "
                f"(solve() / steps), final cost {final!r} vs JAX {ref!r}, rel {rel:.3e} "
                f"(limit {tol})")
            if not (np.isfinite(final) and rel <= tol and plan.num_iterations == GRID_STEPS):
                raise AssertionError(f"{label}, k={k}: final cost {final} vs JAX {ref}")
            if k > 1:  # solve() ran its first step eagerly: the replays alone
                graphed_dispatch_busy(label, plan)
            del plan
        log(f"{label}: graphed {ms[DISPATCH_GRID_K]:.2f} ms a step, eager {ms[1]:.2f}")

    # (e) the six probe rows of a timing_level=3 solve
    plan = arap_plan(tt, ARAP_SIDE, "grouped", "cuda", n_iter=2, timing_level=3)
    plan.solve()
    s = plan.get_performance_summary()
    probes = ("computeCost", "PCGInit1", "PCGStep1", "PCGStep2", "PCGStep3", "PCGLinearUpdate")
    log("ARAP timing_level=3 probe rows: " + ", ".join(
        f"{p} {s[p]['mean_ms']:.4f} ms x {s[p]['count']}" for p in probes if s.get(p)))
    if not all(s.get(p) and s[p]["count"] == 3 for p in probes):
        raise AssertionError(f"ARAP timing_level=3: rows {sorted(s.stats)}")
    del plan

    # (g) the marginal PCG iteration as phase 16 measures it, eagerly and
    # graphed, against the traffic model
    lo, hi = ARAP_MARGINAL
    for k in (1, ARAP_MARGINAL_STEPS):
        plan = arap_plan(tt, ARAP_SIDE, "grouped", "cuda", n_iter=1000, steps_per_dispatch=k)
        times = {}
        for li in ARAP_MARGINAL:
            plan.set_solver_parameter("lIterations", li)
            plan.run_steps(ARAP_MARGINAL_STEPS)  # warm (k > 1: the capture)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.run_steps(ARAP_MARGINAL_STEPS)
            torch.cuda.synchronize()
            times[li] = (time.perf_counter() - t0) / ARAP_MARGINAL_STEPS
        marginal = (times[hi] - times[lo]) / (hi - lo)
        r = roofline(plan, marginal)
        log(f"ARAP {ARAP_SIDE}² marginal PCG iteration, steps_per_dispatch={k}: "
            f"{marginal * 1e3:.4f} ms (steps {times[lo] * 1e3:.3f} / {times[hi] * 1e3:.3f} ms at "
            f"lIterations {lo} / {hi}); roofline {r}")
        if not 0 < r["hbm_fraction"] <= ROOFLINE_MAX:
            raise AssertionError(f"ARAP roofline: hbm_fraction {r['hbm_fraction']}")
        del plan


def phase_dispatch_paths_and_determinism(tt):
    """Phase 24(d) and (h) (the module docstring)."""
    from torch_dispatch_paths import main as dispatch_paths

    # bundle_fusion's small case steps eagerly in 3-4 s (the other paths in
    # under 0.5 s); it captured, and matched its eager runs bit for bit
    at = [a for path, n in PATHS_EAGER_RUNS_AT.items() for a in ("--path-eager-runs", path, str(n))]
    for rec in dispatch_paths(["--steps", "2", "--eager-runs", str(PATHS_EAGER_RUNS), *at,
                               "--skip", "model bundle_fusion"]):
        if "error" in rec or "raises" in rec:
            raise AssertionError(f"steps_per_dispatch on {rec['path']}: "
                                 f"{rec.get('error') or rec['raises']}")
        spread, got = tuple(rec["eager_spread"]), tuple(rec["graphed_vs_eager"])
        ok, lim = within_spread(spread, got)
        log(f"steps_per_dispatch on {rec['path']}: graphed vs the farthest of "
            f"{len(rec['eager_ms'])} eager runs {got}, their spread {spread}, limits {lim}; "
            f"ms a step eager {rec['eager_ms']}, graphed "
            f"{rec['graphed_ms']:.2f}; a replay read the host {rec['replay_host_reads']} times")
        if not ok:
            raise AssertionError(f"steps_per_dispatch on {rec['path']}: graphed vs eager {got}")

    # (h) the in-order scatter: deconvolution 16², two card runs
    Us = []
    for _ in range(2):
        plan = model_plan(tt, "deconvolution", "cuda", False)
        plan.step()
        Us.append(plan.unknowns()["X"].cpu())
    same = bool(torch.equal(Us[0], Us[1]))
    log(f"deconvolution 16² card vs card after step 1: bit-identical {same}")
    if not same:
        raise AssertionError("deconvolution 16²: two card runs differ after step 1")


def phase_sharded(ba, tt, scene):
    """Phase 25 (the module docstring).  Returns {run: kernel launches}
    of the sharded runs."""
    import torch.distributed as dist

    from thallo_tpu_torch import parallel
    from thallo_tpu_torch.models import arap_mesh_deformation as arap
    from thallo_tpu_torch.parallel.launch import free_port

    if not dist.is_nccl_available():
        raise AssertionError("phase 25: this torch has no NCCL; the port shards plans on the "
                             "card over NCCL alone")
    out, recs, calls = {}, {}, [SHARD_K] * SHARD_CALLS
    inputs, dims = scene
    ains = arap.synthetic_inputs(side=ARAP_SIDE)
    ains, _ = parallel.sort_edges_by_owner(ains, arap.make_spec(), "E", "V0", 1)

    def ba_make(k):
        plan = ba_plan(ba, tt, inputs, dims, "cuda", 100, steps_per_dispatch=k)
        plan.init({n: np.copy(v) for n, v in inputs.items()})
        return plan

    def arap_make(k):
        return arap_plan(tt, ARAP_SIDE, None, "cuda", n_iter=100,
                         inputs=(ains, {"N": ARAP_SIDE ** 2, "E": len(ains["V0"])}),
                         steps_per_dispatch=k)

    def sharded(make, k, dim_axes, name):
        def factory():
            plan = make(k)
            parallel.shard_plan_inputs(plan, parallel.make_mesh(), dim_axes=dim_axes)
            recs[name] = (parallel.step_collectives(plan), bsr_kernels(plan))
            return plan
        return factory

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for label, make, axes, key in (
                ("1M LM {P, O}", ba_make, {"P": "x", "O": "x"}, "sharded ba_uniform_1m"),
                (f"ARAP {ARAP_SIDE}² GN {{N, E}}", arap_make, {"N": "x", "E": "x"},
                 f"sharded arap_{ARAP_SIDE}")):
            t0 = time.perf_counter()
            names = {1: key, SHARD_K: f"{key} k={SHARD_K}"}
            _, _, ran, runs, c0 = hold_vs_eager(
                f"phase 25 {label}", make, calls,
                {names[k]: sharded(make, k, axes, names[k]) for k in names}, profile=False,
                u_calls=DISPATCH_1M_U_CALLS if key.startswith("sharded ba") else None)
            eager = [r for n, r in runs.items() if n.startswith("eager")]
            ms_plain = float(np.mean([r[0] for r in eager[0]]))
            for k, name in names.items():
                rec, want = recs[name]
                st = parallel.collective_stats(rec)
                ms = float(np.mean([r[0] for r in runs[name]]))
                log(f"phase 25{'(c)' if k > 1 else ''} {label}, steps_per_dispatch={k}: "
                    f"collectives of one step {st}; ms a step sharded {ms:.3f}, unsharded "
                    f"eager {ms_plain:.3f} (mean over the calls); kernel launches "
                    f"{ran[name]}")
                missing = sorted(n for n in want if not ran[name].get(n))
                if missing:
                    raise AssertionError(f"{label} k={k}: the sharded run launched no {missing}")
                if key.startswith("sharded arap") and \
                        st["all_reduce_bytes"] > SHARD_MAX_ALL_REDUCE:
                    raise AssertionError(f"{label}: {st['all_reduce_bytes']} all_reduce bytes "
                                         f"a step")
                out[name] = ran[name]
            log(f"phase 25 {label}: {len(eager)} unsharded eager runs and two sharded, "
                f"{time.perf_counter() - t0:.2f} s")
            if key.startswith("sharded ba"):
                ba_after_k = [r[0][2] for r in eager]
        t0 = time.perf_counter()
        if torch.cuda.device_count() >= 2:
            from torch_sharded_solve import main as sharded_solve

            r = sharded_solve(["--ranks", "2", "--device", "cuda", "--scene", "ba",
                               "--steps", str(SHARD_K * SHARD_CALLS)])
            log(f"phase 25(e) two ranks on two cards: {r}")
            # after the first SHARD_K steps, before LM's accepts split the
            # runs: within STEP_COST_RTOL of the range of (a)'s eager runs
            got = r["costs"][SHARD_K - 1]
            lo, hi = min(ba_after_k), max(ba_after_k)
            if not lo * (1 - STEP_COST_RTOL) <= got <= hi * (1 + STEP_COST_RTOL):
                raise AssertionError(f"phase 25(e): cost {got} after {SHARD_K} steps against "
                                     f"(a)'s eager {ba_after_k}")
        else:
            log("phase 25(e) not run: this machine has one card, and NCCL refuses two ranks "
                "on one card")
        log(f"phase 25(e): {time.perf_counter() - t0:.2f} s")
    finally:
        dist.destroy_process_group()
    return out


def capi_in_process(lib_path, energy, ins, n_steps, l_iters):
    """The port's C library loaded into this process (ctypes.PyDLL: the
    shim's interpreter is this one, so the launch counters see the
    bridge's calls): Thallo_NewState on the GPU, ProblemDefine, ProblemPlan,
    ProblemInit, ProblemStep n_steps times on numpy buffers.  Returns the
    costs after init and each step, and the solved unknowns."""
    import ctypes

    class InitParams(ctypes.Structure):  # Thallo_InitializationParameters
        _fields_ = [(n, ctypes.c_int) for n in ("doublePrecision", "verbosityLevel",
                                                "timingLevel", "threadsPerBlock",
                                                "useAutoscheduler", "cpuOnly")]

    lib = ctypes.PyDLL(str(lib_path))
    vp = ctypes.c_void_p
    lib.Thallo_NewState.restype = vp
    lib.Thallo_NewState.argtypes = [InitParams]
    lib.Thallo_ProblemDefine.restype = vp
    lib.Thallo_ProblemDefine.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
    lib.Thallo_ProblemPlan.restype = vp
    lib.Thallo_ProblemPlan.argtypes = [vp, vp, ctypes.POINTER(ctypes.c_uint)]
    lib.Thallo_SetSolverParameter.argtypes = [vp, vp, ctypes.c_char_p, vp]
    lib.Thallo_ProblemInit.argtypes = [vp, vp, ctypes.POINTER(vp)]
    lib.Thallo_ProblemStep.argtypes = [vp, vp, ctypes.POINTER(vp)]
    lib.Thallo_ProblemStep.restype = ctypes.c_int
    lib.Thallo_ProblemCurrentCost.argtypes = [vp, vp]
    lib.Thallo_ProblemCurrentCost.restype = ctypes.c_double
    lib.Thallo_PlanFree.argtypes = [vp, vp]
    lib.Thallo_ProblemDelete.argtypes = [vp, vp]
    st = lib.Thallo_NewState(InitParams(0, 0, 1, 0, 0, 0))
    if not st:
        raise AssertionError("phase 26(c): Thallo_NewState returned NULL")
    pr = lib.Thallo_ProblemDefine(st, str(energy).encode(), b"levenberg_marquardt")
    dims = (ctypes.c_uint * 3)(len(ins["cameras"]), len(ins["points"]), len(ins["oToC"]))
    pl = lib.Thallo_ProblemPlan(st, pr, dims)
    if not pl:
        raise AssertionError("phase 26(c): Thallo_ProblemPlan returned NULL on the GPU")
    for name, v in (("nIterations", n_steps), ("lIterations", l_iters)):
        c = ctypes.c_int(v)
        lib.Thallo_SetSolverParameter(st, pl, name.encode(), ctypes.cast(ctypes.byref(c), vp))
    bufs = [np.ascontiguousarray(ins[k], dtype=np.int32 if k.startswith("oTo") else np.float32)
            for k in ("cameras", "points", "observations", "oToC", "oToP")]
    ptrs = (vp * len(bufs))(*[b.ctypes.data for b in bufs])
    lib.Thallo_ProblemInit(st, pl, ptrs)
    costs = [lib.Thallo_ProblemCurrentCost(st, pl)]
    for _ in range(n_steps):
        lib.Thallo_ProblemStep(st, pl, ptrs)
        costs.append(lib.Thallo_ProblemCurrentCost(st, pl))
    lib.Thallo_PlanFree(st, pl)
    lib.Thallo_ProblemDelete(st, pr)
    return costs, {"cameras": bufs[0].copy(), "points": bufs[1].copy()}


def phase_grid_sharded_and_capi(ba, tt, scene):
    """Phase 26 (the module docstring).  Returns {run: kernel launches} of
    the C-API run."""
    import tempfile

    import torch.distributed as dist

    from thallo_tpu_torch import parallel
    from thallo_tpu_torch.io import bal
    from thallo_tpu_torch.lib_env import load_energy_file
    from thallo_tpu_torch.parallel.launch import free_port
    from torch_grid_profile import make_grid_plan

    root = Path(__file__).resolve().parent
    capi = root / "thallo_tpu_torch" / "capi"
    out, recs = {}, {}

    def sharded(make, k, dim_axes, axes, name):
        def factory():
            plan = make(k)
            parallel.shard_plan_inputs(plan, parallel.make_mesh(axis_names=axes),
                                       dim_axes=dim_axes)
            recs[name] = (parallel.step_collectives(plan), plan._halo_log,
                          dict(plan._halo_widths))
            return plan
        return factory

    def iw_make(k):
        return make_grid_plan(GRID_SIZE, "cuda", l_iterations=GRID_L_ITERATIONS, n_iter=100,
                              steps_per_dispatch=k)

    def dc_make(_k):  # eager alone: a blocked contraction's step is not graphed here
        plan, _ = full_plan(tt, "deconvolution", "cuda")
        plan.set_solver_parameter("nIterations", 100)
        return plan

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for tag, label, make, axes, dim_axes, sizes, ks in (
                ("a", f"image_warping {GRID_SIZE}² GN {{W, H}}", iw_make, ("x", "y"),
                 {"W": "x", "H": "y"}, [SHARD_K] * SHARD_CALLS, (1, SHARD_K)),
                ("b", f"deconvolution {FULL_SIZE}² GN {{W}}", dc_make, ("x",), {"W": "x"},
                 [1] * GRID_SHARD_DC_STEPS, (1,))):
            t0 = time.perf_counter()
            names = {k: f"sharded {tag} k={k}" for k in ks}
            _, _, _, runs, _ = hold_vs_eager(
                f"phase 26({tag}) {label}", make, sizes,
                {names[k]: sharded(make, k, dim_axes, axes, names[k]) for k in ks},
                profile=False)
            eager = [r for n, r in runs.items() if n.startswith("eager")]
            ms_plain = float(np.mean([r[0] for r in eager[0]]))
            for k, name in names.items():
                rec, halo_log, widths = recs[name]
                st = parallel.collective_stats(rec)
                kinds = sorted(set(rec))
                ms = float(np.mean([r[0] for r in runs[name]]))
                log(f"phase 26({tag}) {label}, steps_per_dispatch={k}: halo plan {halo_log}, "
                    f"widths {widths}; collectives of one eager step {st} (kind, bytes: "
                    f"{kinds}); ms a step sharded {ms:.3f}, unsharded eager {ms_plain:.3f} "
                    f"(mean over the calls)")
                if st["all_gather"]:
                    raise AssertionError(f"phase 26({tag}): a sharded grid step gathered an "
                                         f"image ({st})")
                if not st["collective_permute"]:
                    raise AssertionError(f"phase 26({tag}): no halo exchange ran in a step")
            want_h = {"W": 1, "H": 1} if tag == "a" else {"W": FULL_CON_HALO}
            if widths != want_h:
                raise AssertionError(f"phase 26({tag}): halo widths {widths}, not {want_h}")
            log(f"phase 26({tag}): {len(eager)} unsharded eager runs, "
                f"{time.perf_counter() - t0:.2f} s")
    finally:
        dist.destroy_process_group()

    # (c) BA 1M through the C API
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-s", "-C", str(capi)], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"phase 26(c): make failed:\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
    log(f"phase 26(c) make the port's C API: {time.perf_counter() - t0:.2f} s")
    energy = capi / "test" / "ba_energy.py"
    inputs, _ = scene
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
    with tempfile.TemporaryDirectory(prefix="thallo_capi_") as tmp:
        path = Path(tmp) / "ba_1m.bal"
        t0 = time.perf_counter()
        bal.save_bal(str(path), inputs["cameras"], inputs["points"], inputs["oToC"],
                     inputs["oToP"], inputs["observations"])
        bins, bdims = bal.bal_to_inputs(str(path))
        log(f"phase 26(c) BAL file of the uniform 1M scene written and read: "
            f"{path.stat().st_size / 1e6:.1f} MB, {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        solved = Path(tmp) / "solved.f32"
        r = subprocess.run([str(capi / "build" / "bin" / "bal_solve"), "--gpu", str(path),
                            str(CAPI_STEPS), str(CAPI_L_ITERATIONS), str(solved)], cwd=capi,
                           env=env, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"phase 26(c): bal_solve --gpu failed ({r.returncode}):\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        c_costs = [float(line.split()[2]) for line in r.stdout.splitlines()
                   if line.startswith("cost ")]
        raw = np.fromfile(solved, dtype="<f4")
        nc = bins["cameras"].size
        c_U = {"cameras": raw[:nc].reshape(bins["cameras"].shape),
               "points": raw[nc:].reshape(bins["points"].shape)}
        log(f"phase 26(c) bal_solve --gpu, {CAPI_STEPS} LM steps of {CAPI_L_ITERATIONS}: "
            f"costs {c_costs}, {time.perf_counter() - t0:.2f} s (process start, plan, steps)")

    def eager_run():
        spec = load_energy_file(str(energy))
        plan = spec.plan(bdims, solver="levenberg_marquardt", device="cuda")
        plan.set_solver_parameter("nIterations", CAPI_STEPS)
        plan.set_solver_parameter("lIterations", CAPI_L_ITERATIONS)
        costs = [plan.init({k: np.copy(v) for k, v in bins.items()})]
        for _ in range(CAPI_STEPS):
            plan.step()
            costs.append(plan.cost())
        return {k: v.cpu().numpy() for k, v in plan.unknowns().items()}, costs

    t0 = time.perf_counter()

    def differ(a, b):
        return a[1] != b[1] or _u_rel(a[0], b[0]) != 0.0

    tested = (c_U, c_costs)
    eager = more_runs_while_they_differ([], eager_run, differ, [tested])
    ok, spread, got, lim, _ = held_by_spread(eager, tested, eager[0][1][0],
                                             (STEP_U_TOL, DISPATCH_COST_FLOOR))
    log(f"phase 26(c) the C-API run against {len(eager)} eager Python runs of the same BAL "
        f"file: their spread max|dU|/max|U| {spread[0]:.3e}, costs {spread[1]:.3e} x c0; the "
        f"C-API run's farthest {got[0]:.3e}, {got[1]:.3e} (limits {lim[0]:.3e}, "
        f"{lim[1]:.3e}); eager costs {[e[1] for e in eager[:2]]}; "
        f"{time.perf_counter() - t0:.2f} s")
    if not (ok and all(np.isfinite(c_costs))):
        raise AssertionError("phase 26(c): the C-API run lies off the eager Python runs")

    t0 = time.perf_counter()
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    in_costs, in_U = capi_in_process(capi / "build" / "lib" / "libthallo_tpu_torch.so", energy,
                                     bins, CAPI_STEPS, CAPI_L_ITERATIONS)
    launched = {n: fn.launches for n, fn in fns.items() if fn.launches}
    log(f"phase 26(c) the C library in this process (ctypes.PyDLL): costs {in_costs}, "
        f"vs the bal_solve run max|dU|/max|U| {_u_rel(in_U, c_U):.3e}; kernel launches "
        f"{launched}; {time.perf_counter() - t0:.2f} s")
    missing = [n for n in CAPI_KERNELS if not launched.get(n)]
    if missing:
        raise AssertionError(f"phase 26(c): the C-API run launched no {missing}")
    out["capi ba_uniform_1m"] = launched

    # (d) the CLI on the card, the two models' processes at once
    t0 = time.perf_counter()
    models = ("image_warping", "bundle_adjustment")
    procs = [subprocess.Popen([sys.executable, "-m", "thallo_tpu_torch.cli", model, "--device",
                               "cuda", "--iters", "3", "--verbosity", "0"], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for model in models]
    for model, proc in zip(models, procs):
        stdout, stderr = proc.communicate(timeout=600)
        line = next((x for x in stdout.splitlines() if " -> " in x), "")
        log(f"phase 26(d) python -m thallo_tpu_torch.cli {model} --device cuda --iters 3: "
            f"exit {proc.returncode}, {line!r}, {time.perf_counter() - t0:.2f} s")
        if proc.returncode != 0 or not line:
            raise AssertionError(f"phase 26(d): the CLI failed on {model}:\n{stderr[-2000:]}")
        c0, final = (float(v) for v in line.rsplit(": ", 1)[1].split(" -> "))
        if not final < c0:
            raise AssertionError(f"phase 26(d): {model} {c0} -> {final}")
    return out


def run_kernel_cases(cases):
    """Each case's kernel against its plain version (and a library call,
    where there is one) on the card, with the times of each; returns the
    RECORD entries."""
    record = {}
    for name, tag, kern, plain, lib, in_bytes, flops, terms, *tol in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = compare(f"{name}[{tag}]", got, ref, terms() if terms else None, *tol)
        ms, dev_ms = timed_ms(kern, 20), device_ms(kern)
        plain_ms = timed_ms(plain, 5)
        lib_ms = lib_dev_ms = None
        if lib is not None:
            lib_ms, lib_dev_ms = timed_ms(lib, 20), device_ms(lib)
        moved = in_bytes + nbytes(*got)
        peak = F64_FLOP_PER_S if got[0].dtype == torch.float64 else F32_FLOP_PER_S
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
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
    return record


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
    cases = kernel_cases(dev, rng, scene[0], skew_scene[0]["oToC"])
    cases += skew_kernel_cases(dev, rng, skew_tables(ba, tt, skew_scene))
    cases += measurement_kernel_cases(dev, rng)
    for order in ("grouped", "shuffled"):
        arap_reg = arap_plan(tt, ARAP_SIDE, order, "cuda")._prep["consts"][1]["bsr"]
        cases += arap_kernel_cases(dev, rng, arap_reg, order)
        cases += arap_kernel_cases(dev, rng, arap_reg, order, bf16=True)
    cases += bf16_wide_cases(dev, rng)
    cases += model_kernel_cases(dev, rng, tt)
    cases += f64_kernel_cases(dev, rng, ba, tt, scene)
    record = run_kernel_cases(cases)
    del cases
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
    runs["bf16 block-sparse"], bf16_final = phase_ba_1m_bf16(ba, tt, scene, f32_final)
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

    for k, name in ((18, "deconvolution"), (19, "optical_flow")):
        t0 = time.perf_counter()
        phase_full_width(tt, name)
        torch.cuda.synchronize()
        log(f"phase {k} {name} {FULL_SIZE}², the full-width path: "
            f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs["f64 block-sparse"] = phase_f64_1m(ba, tt, scene, f32_final, bf16_final)
    runs["arap256 f64"] = phase_arap_f64(tt)
    phase_schur_skew_f64(ba, tt)
    runs["f64 precompute_j"], ref_f64 = phase_precompute_j_f64(ba, tt, scene, ref[0][-1])
    phase_f64_models(tt)
    torch.cuda.synchronize()
    log(f"phase 20 double_precision: BA 1M (block-sparse and PRECOMPUTE_J), ARAP "
        f"{ARAP_SIDE}², the small skewed schur_dense scene, the aggregation models at "
        f"test size: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_jacobian(ba, tt, scene)
    torch.cuda.synchronize()
    log(f"phase 21 Plan.jacobian: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_drivers(tt)
    torch.cuda.synchronize()
    log(f"phase 22 the drivers: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    runs.update(phase_schedule_ba(ba, tt, scene, ref, ref_f64))
    phase_schedule_arap(tt)
    torch.cuda.synchronize()
    log(f"phase 23 scheduling: BA 1M under the heuristic, LINEARIZE and INLINE; ARAP "
        f"{ARAP_SIDE}²'s measured candidates: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_dispatch_1m(ba, tt, scene, skew_scene)
    phase_dispatch_grid(tt)
    phase_dispatch_paths_and_determinism(tt)
    torch.cuda.synchronize()
    log(f"phase 24 steps_per_dispatch as a CUDA graph of the step; kernel_stats, "
        f"timing_level 3, trace_dir, roofline: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model_runs.update(phase_sharded(ba, tt, scene))
    torch.cuda.synchronize()
    log(f"phase 25 the sharded path on a one-rank NCCL group: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model_runs.update(phase_grid_sharded_and_capi(ba, tt, scene))
    torch.cuda.synchronize()
    log(f"phase 26 grid energies sharded by halo exchange, BA 1M through the C API, the "
        f"CLI: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    bf16_runs = phase_arap_256_bf16(tt)
    model_runs.update(bf16_runs)
    runs.update(bf16_runs)
    torch.cuda.synchronize()
    log(f"phase 27 ARAP {ARAP_SIDE}² GN under block_dtype=bf16, both edge orders: "
        f"{time.perf_counter() - t0:.2f} s")

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
