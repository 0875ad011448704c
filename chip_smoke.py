"""End-to-end smoke run of thallo_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):
  1. build the CUDA kernels from thallo_tpu_torch/csrc and print nvcc's
     register/spill report;
  2. each kernel against its plain torch version on the card, at the
     bundle-adjustment 1M-observation shapes and at a small ragged shape
     with out-of-range ids; kernel and plain times in ms;
  3. the small BA scene solved with LM on the card and on the CPU (the
     plain versions): per-step unknowns and costs agree;
  4. the BA 1M-observation LM solve on the card (1024 cameras, 250 000
     points, 4 observations per point, random scene from a seed): every
     kernel launched, costs finite, final cost <= 1e-2 x initial.

Needs CUDA: exits 1 without printing a result when none is available.
The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
import json
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
# tolerance
STEP_U_TOL = 1e-4
STEP_COST_RTOL = 1e-2


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


def kernel_cases(dev, rng):
    """(name, shape tag, kernel call, plain call) per kernel, at the BA-1M
    shapes and at a small ragged shape with out-of-range ids."""
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup

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
                      lambda a=a, S=S: fusedpair.fused_pair_apply_reference(*a, Ci=3, Cj=9, S=S)))
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
                          *a, N=N, recipe=oh_recipe),)))
    fr_recipe = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 6, 9, 0), ("diag", 0, 3, 0, 3))
    for tag, (N_t, W) in (("ba1m", (250_000, 4)), ("ragged", (131, 3))):
        a = (t(rng.normal(size=(2, N_t * W)).astype(np.float32)),
             t(rng.normal(size=(24, N_t * W)).astype(np.float32)))

        def run(fn, a=a, N_t=N_t, W=W):
            agg, crosses = fn(*a, W=W, N_t=N_t, recipe=fr_recipe)
            return (agg, *crosses)

        cases.append(("fullrepeat_setup", tag,
                      lambda run=run: run(fullrepeat.fullrepeat_setup),
                      lambda run=run: run(fullrepeat.fullrepeat_setup_reference)))
    return cases


KERNELS = {
    "fused_pair_apply": ("thallo_tpu_torch/csrc/fused_pair.cu",
                         "thallo_tpu/ops/fusedpair.py:307"),
    "oh_setup_products": ("thallo_tpu_torch/csrc/oh_setup.cu",
                          "thallo_tpu/ops/ohsetup.py:191"),
    "fullrepeat_setup": ("thallo_tpu_torch/csrc/fullrepeat.cu",
                         "thallo_tpu/ops/fullrepeat.py:176"),
}


def counters():
    from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup

    return {"fused_pair_apply": fusedpair.fused_pair_apply,
            "oh_setup_products": ohsetup.oh_setup_products,
            "fullrepeat_setup": fullrepeat.fullrepeat_setup}


def ba_plan(ba, tt, n_cameras, n_points, obs_per_point, device, n_iter):
    t0 = time.perf_counter()
    inputs, _ = ba.synthetic_inputs(n_cameras=n_cameras, n_points=n_points,
                                    obs_per_point=obs_per_point, seed=SEED)
    log(f"scene {n_cameras}x{n_points}x{obs_per_point}: host generation "
        f"{time.perf_counter() - t0:.2f} s")
    dims = {"C": n_cameras, "P": n_points, "O": len(inputs["oToC"])}
    plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt",
                                          device=device)
    plan.set_solver_parameter("nIterations", n_iter)
    return plan, inputs


def phase_small_scene(ba, tt):
    runs = {}
    for device in ("cuda", "cpu"):
        plan, inputs = ba_plan(ba, tt, 16, 1400, 4, device, 5)
        costs, Us = [plan.init(inputs)], []
        for _ in range(5):
            plan.step()
            costs.append(plan.cost())
            Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
        torch.cuda.synchronize()
        runs[device] = (costs, Us)
    (cg, Ug), (cc, Uc) = runs["cuda"], runs["cpu"]
    log(f"small scene costs cuda {cg}")
    log(f"small scene costs cpu  {cc}")
    for k, (a, b) in enumerate(zip(cg, cc)):
        if not (np.isfinite(a) and abs(a - b) <= STEP_COST_RTOL * abs(b)):
            raise AssertionError(f"step {k}: cost {a} (cuda) vs {b} (cpu)")
    for k, (ug, uc) in enumerate(zip(Ug, Uc)):
        for name in uc:
            err = np.abs(ug[name] - uc[name]).max()
            if not err <= STEP_U_TOL * np.abs(uc[name]).max():
                raise AssertionError(f"step {k + 1}: {name} differs by {err}")
    if not cg[-1] <= 1e-2 * cg[0]:
        raise AssertionError("small scene did not converge on the card")


def phase_ba_1m(ba, tt):
    plan, inputs = ba_plan(ba, tt, 1024, 250_000, 4, "cuda", 10)
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    c0 = plan.init(inputs)
    torch.cuda.synchronize()
    log(f"1M init (tables, upload, initial cost) {time.perf_counter() - t0:.3f} s; "
        f"initial cost {c0!r}")
    costs, step_s = [c0], []
    while True:
        t0 = time.perf_counter()
        more = plan.step()  # LM reads its stop flag: the step has finished
        torch.cuda.synchronize()
        if plan.num_iterations > len(step_s):
            step_s.append(time.perf_counter() - t0)
            costs.append(plan.cost())
            log(f"1M LM step {len(step_s)}: {step_s[-1] * 1e3:.2f} ms, cost {costs[-1]!r}")
        if not more:
            break
    launches = {name: fn.launches for name, fn in fns.items()}
    log(f"1M launches {launches}")
    if not all(np.isfinite(costs)):
        raise AssertionError(f"non-finite cost in {costs}")
    if not costs[-1] <= 1e-2 * costs[0]:
        raise AssertionError(f"final cost {costs[-1]} > 1e-2 * initial {costs[0]}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for name, U in plan.unknowns().items():
        if not bool(torch.isfinite(U).all()):
            raise AssertionError(f"non-finite unknowns {name}")
    steady = step_s[1:] or step_s
    log(f"1M LM step time: first {step_s[0] * 1e3:.2f} ms, median of the rest "
        f"{float(np.median(steady)) * 1e3:.2f} ms over {len(steady)} steps")
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
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    for line in open(f"{path}.log"):
        if "entry function" in line or "registers" in line or "spill" in line:
            log(line.rstrip())
    log(f"phase 1 build {path.name}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    record = {}
    for name, tag, kern, plain in kernel_cases(dev, rng):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = compare(f"{name}[{tag}]", got, ref)
        ms = timed_ms(kern, 20)
        plain_ms = timed_ms(plain, 5)
        log(f"{name}[{tag}]: max|err| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if tag == "ba1m":
            record[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    torch.cuda.synchronize()
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_small_scene(ba, tt)
    log(f"phase 3 small scene cuda vs cpu: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    launches = phase_ba_1m(ba, tt)
    torch.cuda.synchronize()
    log(f"phase 4 BA 1M LM solve: {time.perf_counter() - t0:.2f} s")

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **record[name]}
               for name, (src, rep) in KERNELS.items()]
    log(f"total {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
