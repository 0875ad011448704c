"""End-to-end smoke run of thallo_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

The BA 1M-observation scene (1024 cameras, 250 000 points, 4
observations per point, random from a seed) is generated once, on the
host, and each solve gets its own copy.  Phases (each prints its
seconds; any failure exits non-zero):
  1. build the CUDA kernels from thallo_tpu_torch/csrc (one nvcc per
     source, in parallel) and print nvcc's register/spill report;
  2. each of the five kernels against its plain torch version on the
     card, at the 1M shapes (the segment sum with plans built from the
     scene's oToP and oToC) and at a small ragged shape with out-of-range
     ids or padded plan lanes; kernel, plain and index_add_ times in ms;
  3. the small BA scene solved with LM on the card and on the CPU (the
     plain versions): per-step unknowns and costs agree;
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
     agree with phase 5's.
Each solve's kernel counts are set to 0 just before it and read just
after.

Needs CUDA: exits 1 without printing a result when none is available.
The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# phase 2: f32 on both sides; only the order of (atomic) sums differs
KERNEL_TOL = 1e-5
# phase 3: the unknowns after each LM step agree to f32 trajectory noise;
# near convergence this scene's cost moves ~2e-3 relative under such
# changes of the unknowns (measured CPU-port vs CPU-JAX), hence the cost
# tolerance.  Phases 5 and 6 hold their first 3 steps to the same bounds:
# the two solves compared apply the same JᵀJ·p and preconditioner and
# differ only in f32 summation order (atomics, assembly order).
STEP_U_TOL = 1e-4
STEP_COST_RTOL = 1e-2
CROSS_STEPS = 3
BA_1M = (1024, 250_000, 4)
N_STEPS_1M = 10
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


def compare(name, got, ref):
    """max|got - ref| over all outputs; fails above KERNEL_TOL * max|ref|."""
    err, scale = 0.0, 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
        err = max(err, float((g - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
    if err > KERNEL_TOL * scale:
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


def kernel_cases(dev, rng, scene):
    """(name, shape tag, kernel call, plain call, index_add_ call or None,
    input bytes, f32 operations) per kernel, at the BA-1M shapes and at a
    small ragged shape with out-of-range ids or padded plan lanes."""
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
        cases.append(("fused_pair_apply", tag,
                      lambda a=a, S=S: fusedpair.fused_pair_apply(*a, Ci=3, Cj=9, S=S),
                      lambda a=a, S=S: fusedpair.fused_pair_apply_reference(*a, Ci=3, Cj=9, S=S),
                      None, nbytes(*a), 4 * W * N * 27))
    oh_recipe = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))
    for tag, (R, N) in (("ba1m", (1_000_000, 1024)), ("ragged", (2349, 97))):
        ids = rng.integers(0, N, R).astype(np.int32)
        if tag == "ragged":
            ids[:3] = N + 7
            ids[3] = -2
        a = (t(rng.normal(size=(2, R)).astype(np.float32)),
             t(rng.normal(size=(18, R)).astype(np.float32)), t(ids))
        cases.append(("oh_setup_products", tag,
                      lambda a=a, N=N: (ohsetup.oh_setup_products(*a, N=N, recipe=oh_recipe),),
                      lambda a=a, N=N: (ohsetup.oh_setup_products_reference(
                          *a, N=N, recipe=oh_recipe),),
                      None, nbytes(*a), (9 + 9 + 81) * 2 * 2 * R))
    fr_recipe = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 6, 9, 0), ("diag", 0, 3, 0, 3))
    for tag, (N_t, W) in (("ba1m", (250_000, 4)), ("ragged", (131, 3))):
        a = (t(rng.normal(size=(2, N_t * W)).astype(np.float32)),
             t(rng.normal(size=(24, N_t * W)).astype(np.float32)))

        def run(fn, a=a, N_t=N_t, W=W):
            agg, crosses = fn(*a, W=W, N_t=N_t, recipe=fr_recipe)
            return (agg, *crosses)

        cases.append(("fullrepeat_setup", tag,
                      lambda run=run: run(fullrepeat.fullrepeat_setup),
                      lambda run=run: run(fullrepeat.fullrepeat_setup_reference),
                      None, nbytes(*a), (3 + 3 + 27 + 9) * 2 * 2 * N_t * W))
    # the camera scatter of the materialized-J schedules: [9, 1M] by oToC
    for tag, (R, N) in (("ba1m", (len(scene["oToC"]), BA_1M[0])), ("ragged", (2349, 97))):
        if tag == "ba1m":
            ids = np.asarray(scene["oToC"], np.int32)
        else:
            ids = rng.integers(0, N, R).astype(np.int32)
            ids[:3] = N + 7
            ids[3] = -2
        a = (t(rng.normal(size=(9, R)).astype(np.float32)), t(ids))
        ok = (a[1] >= 0) & (a[1] < N)
        lib_args = (a[1][ok].long(), a[0][:, ok].contiguous())
        cases.append(("oh_setup_aggregate", tag,
                      lambda a=a, N=N: (ohsetup.oh_setup_aggregate(*a, N=N),),
                      lambda a=a, N=N: (ohsetup.oh_setup_aggregate_reference(*a, N=N),),
                      lambda la=lib_args, N=N: torch.zeros(
                          (9, N), device=dev).index_add_(1, *la),
                      nbytes(*a), 9 * R))
    # the segment sum of APPLY_SEPARATELY + THALLO_SEGSUM=tiled: points
    # [1M, 3] -> [250000, 3] and cameras [1M, 9] -> [1024, 9], plans from
    # the scene's maps, data as the strided transpose of a channel-major
    # buffer (what lower.py's scatter passes)
    n_pt = BA_1M[1]
    seg = [("ba1m", np.asarray(scene["oToP"], np.int32), n_pt, 3),
           ("ba1m_cameras", np.asarray(scene["oToC"], np.int32), BA_1M[0], 9)]
    ragged_ids = rng.integers(0, 300, 1001).astype(np.int32)
    seg.append(("ragged", ragged_ids, 300, 3))
    for tag, ids, S, C in seg:
        plan = segsum.build_plan(ids, S, device=dev)
        if plan is None:
            raise AssertionError(f"segment_sum[{tag}]: build_plan refused the map")
        if tag == "ragged" and not bool((plan.mask == 0).any()):
            raise AssertionError("segment_sum[ragged]: the plan has no padded lanes")
        cm = t(rng.normal(size=(C, len(ids))).astype(np.float32))
        data = cm.T if tag != "ragged" else cm.T.contiguous()
        lib_args = (t(ids).long(), data)
        cases.append(("segment_sum", tag,
                      lambda d=data, p=plan: (segsum.segment_sum(d, p),),
                      lambda d=data, p=plan: (segsum.segment_sum_reference(d, p),),
                      lambda la=lib_args, S=S, C=C: torch.zeros(
                          (S, C), device=dev).index_add_(0, *la),
                      nbytes(cm, plan.gather_idx, plan.rel, plan.mask), 2 * len(ids) * C))
    return cases


# kernel -> (source, the TPU kernel it replaces: file:line of the def,
# the smoke solve that runs it)
KERNELS = {
    "fused_pair_apply": ("thallo_tpu_torch/csrc/fused_pair.cu",
                         "thallo_tpu/ops/fusedpair.py:309", "block-sparse"),
    "oh_setup_products": ("thallo_tpu_torch/csrc/oh_setup.cu",
                          "thallo_tpu/ops/ohsetup.py:192", "block-sparse"),
    "fullrepeat_setup": ("thallo_tpu_torch/csrc/fullrepeat.cu",
                         "thallo_tpu/ops/fullrepeat.py:178", "block-sparse"),
    "oh_setup_aggregate": ("thallo_tpu_torch/csrc/oh_aggregate.cu",
                           "thallo_tpu/ops/ohsetup.py:236", "precompute_j"),
    "segment_sum": ("thallo_tpu_torch/csrc/segsum.cu",
                    "thallo_tpu/ops/segsum.py:254", "apply_separately_tiled"),
}


def counters():
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup, segsum

    return {"fused_pair_apply": fusedpair.fused_pair_apply,
            "oh_setup_products": ohsetup.oh_setup_products,
            "fullrepeat_setup": fullrepeat.fullrepeat_setup,
            "oh_setup_aggregate": ohsetup.oh_setup_aggregate,
            "segment_sum": segsum.segment_sum}


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


def check_steps(what, costs, Us, ref_costs, ref_Us):
    """Costs within STEP_COST_RTOL and unknowns within STEP_U_TOL x max|U|
    of the reference, step by step (as far as both lists go)."""
    for k, (a, b) in enumerate(zip(costs, ref_costs)):
        if not (np.isfinite(a) and abs(a - b) <= STEP_COST_RTOL * abs(b)):
            raise AssertionError(f"{what}, step {k}: cost {a} vs {b}")
    for k, (u, ref) in enumerate(zip(Us, ref_Us)):
        for name in ref:
            err = np.abs(u[name] - ref[name]).max()
            if not err <= STEP_U_TOL * np.abs(ref[name]).max():
                raise AssertionError(f"{what}, step {k + 1}: {name} differs by {err}")


def solve_1m(ba, tt, scene, label, kernels, n_steps=N_STEPS_1M, schedule=None,
             keep_unknowns=0, **options):
    """One LM solve of the 1M scene on the card, on its own copy of the
    scene.  The counts of `kernels` are set to 0 just before the solve and
    read just after; every one of them must have launched.  Returns
    (costs, unknowns of the first `keep_unknowns` steps, launches)."""
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
    return costs, Us, launches


def never_rising(label, costs):
    """LM keeps the unknowns of a rejected step, so the cost after each
    step is at most the one before it."""
    for k, (a, b) in enumerate(zip(costs, costs[1:])):
        if not b <= a:
            raise AssertionError(f"{label}: cost rose at step {k + 1}: {a} -> {b}")


def phase_ba_1m(ba, tt, scene):
    costs, _, launches = solve_1m(ba, tt, scene, "1M block-sparse", (
        "fused_pair_apply", "oh_setup_products", "fullrepeat_setup"))
    if not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    return launches


def phase_precompute_j(ba, tt, scene):
    costs, Us, launches = solve_1m(ba, tt, scene, "1M PRECOMPUTE_J", ("oh_setup_aggregate",),
                                   schedule="J", keep_unknowns=CROSS_STEPS,
                                   preconditioner="jacobi")
    never_rising("1M PRECOMPUTE_J", costs)
    ref_costs, ref_Us, _ = solve_1m(ba, tt, scene, "1M block-sparse, jacobi",
                                    ("fused_pair_apply",), n_steps=CROSS_STEPS,
                                    keep_unknowns=CROSS_STEPS, preconditioner="jacobi")
    check_steps("PRECOMPUTE_J vs block-sparse (jacobi)", costs[:CROSS_STEPS + 1], Us,
                ref_costs, ref_Us)
    return launches, (costs, Us)


def phase_apply_separately_tiled(ba, tt, scene, ref):
    os.environ["THALLO_SEGSUM"] = "tiled"  # read by plan.init, as thallo_tpu reads it
    try:
        costs, Us, launches = solve_1m(ba, tt, scene, "1M APPLY_SEPARATELY tiled",
                                       ("segment_sum",), schedule="Jp",
                                       keep_unknowns=CROSS_STEPS)
    finally:
        del os.environ["THALLO_SEGSUM"]
    never_rising("1M APPLY_SEPARATELY tiled", costs)
    check_steps("APPLY_SEPARATELY tiled vs PRECOMPUTE_J", costs[:CROSS_STEPS + 1], Us,
                ref[0], ref[1])
    return launches


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
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

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    record = {}
    for name, tag, kern, plain, lib, in_bytes, flops in kernel_cases(dev, rng, scene[0]):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = compare(f"{name}[{tag}]", got, ref)
        ms = timed_ms(kern, 20)
        plain_ms = timed_ms(plain, 5)
        lib_ms = timed_ms(lib, 20) if lib is not None else None
        moved = in_bytes + nbytes(*got)
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        lib_txt = f", index_add_ {lib_ms:.4f} ms" if lib is not None else ""
        log(f"{name}[{tag}]: max|err| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            f"{lib_txt}, bound {bound_ms:.4f} ms ({moved / 1e6:.1f} MB, {flops / 1e6:.1f} MFLOP)")
        if tag == "ba1m":
            record[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms,
                            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                            "library_ms": lib_ms}
    torch.cuda.synchronize()
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_small_scene(ba, tt)
    log(f"phase 3 small scene cuda vs cpu: {time.perf_counter() - t0:.2f} s")

    runs = {}
    t0 = time.perf_counter()
    runs["block-sparse"] = phase_ba_1m(ba, tt, scene)
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

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": runs[path][name], **record[name]}
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
