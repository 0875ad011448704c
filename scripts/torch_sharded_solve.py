"""Sharded solves of graph energies over N ranks (the port's
parallel/), and the workers that the tests and chip_smoke.py drive.

    python3 scripts/torch_sharded_solve.py --ranks N --device cpu|cuda
        --scene ba|ba_skew|arap [--steps 10] [--size S] [--dispatch K]

starts N processes (parallel/launch.py; gloo on the CPU, NCCL on the
card, rank r on card r), shards the scene over a one-axis mesh of the N
ranks and runs --steps steps: BA (``ba``: the uniform scene, 1024 cameras
and --size points seen 4 times each, LM, {"P", "O"}; ``ba_skew``: the
power-law scene of --size observations; default sizes 250 000 points and
1 000 000 observations on the card, 2 000 and 8 000 on the CPU) or ARAP
(side --size, default 256 on the card and 32 on the CPU, GN, edges sorted
by owner, {"N", "E"}).  Prints one JSON line: the costs after each step,
the collectives of one step (parallel.collective_stats), each rank's
owned bytes and whether an unknown is replicated, and the median ms a
step.  With --dispatch K the steps run K to a dispatch (a CUDA graph on
the card).

This file imports the port alone (the ranks are fresh processes that
must not import JAX): ``run_case``/``run_cases`` are the rank workers,
``case`` builds their arguments.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BA_SPARSE = ("\nr.snavely_reprojection_error.JtJ.set_materialize(True)"
             "\nr.snavely_reprojection_error.JtJ.set_sparse(True)\n")


def case(energy, dims, inputs, solver="levenberg_marquardt", options=None, params=None,
         dim_axes=None, axis_names=("x",), steps=1, want=(), double=False, dispatch=1):
    """The argument of run_case: the energy text, its dims and seeded
    inputs, the plan's solver, options and solver parameters, the mesh
    (dim_axes None: no mesh, every rank solves the whole problem) and
    what to return (want: "U1" the unknowns after step 1, "U" after the
    last, "record" one step's collectives, "report" distribution_report,
    "tables" each GroupBsr's row tables, "times" ms a step)."""
    return {"energy": energy, "dims": dict(dims), "inputs": dict(inputs), "solver": solver,
            "options": dict(options or {}), "params": dict(params or {}),
            "dim_axes": dim_axes, "axis_names": tuple(axis_names), "steps": steps,
            "want": tuple(want), "double": double, "dispatch": dispatch}


def _np(t):
    return t.detach().cpu().numpy()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_case(c, device="cpu"):
    """One case on this rank (every rank of the job calls it alike)."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch import parallel

    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    spec = tt.load_energy(c["energy"], tt.ProblemSpec(double_precision=c["double"]))
    plan = spec.plan(c["dims"], solver=c["solver"], device=device,
                     steps_per_dispatch=c["dispatch"], **c["options"])
    for k, v in c["params"].items():
        plan.set_solver_parameter(k, v)
    out = {"c0": plan.init({k: np.copy(v) for k, v in c["inputs"].items()})}
    want = c["want"]
    if c["dim_axes"] is not None:
        mesh = parallel.make_mesh(axis_names=c["axis_names"])
        parallel.shard_plan_inputs(plan, mesh, dim_axes=c["dim_axes"])
        out["mesh_shape"] = mesh.shape
        if "record" in want:
            rec = parallel.step_collectives(plan)
            out["record"] = rec
            out["collectives"] = parallel.collective_stats(rec)
        if "report" in want:
            out["report"] = parallel.distribution_report(plan)
        if "tables" in want:
            out["tables"] = [
                {"perms": [tuple(p.shape) for p in bsr.perms],
                 "base": [t for t, s in enumerate(bsr.row_sels) if s is None],
                 "row_win": list(bsr.row_win),
                 "onehot": [x is not None for x in bsr.oh_idxs],
                 "cols": [tuple(x.shape) for x in bsr.cols],
                 "col_row": list(bsr.col_row)}
                for bsr in parallel.shard_bsr_tables(plan)]
        out["complete"] = sorted(plan.compiled.shard_ctx.complete)
        out["sharded_groups"] = list(plan.compiled.shard_ctx.sharded)
    costs, ms = [], []
    k = c["dispatch"]
    n_calls = c["steps"] // k
    for i in range(n_calls):
        _sync(device)
        t0 = time.perf_counter()
        plan.run_steps(k)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3 / k)
        costs.append(plan.cost())
        if i == 0 and "U1" in want:
            out["U1"] = {n: _np(plan.get_unknown(n, squeeze=False)) for n in plan._U}
    out["costs"] = costs
    out["final"] = costs[-1] if costs else out["c0"]
    if "U" in want:
        out["U"] = {n: _np(plan.get_unknown(n, squeeze=False)) for n in plan._U}
    if "times" in want:
        out["ms"] = ms
    return out


def run_cases(cases, device="cpu"):
    """run_case of each case in turn (one start of the ranks for many)."""
    return [run_case(c, device) for c in cases]


CONTRACTION_ENERGY = """
N, K = Dims("N", "K")
Inputs(C=Unknown(float, (K,), 0), R=Array(float, (N,), 1), T=Array(float, (N,), 2))
n, k = N(), K()
acc = Sum([k], Select(InBounds(n - k + 1), R(n - k + 1), 0) * C(k))
r = Residuals(conv=T(n) - acc)
"""


def refusals(device="cpu"):
    """What shard_plan_inputs refuses, on this rank: {case: (exception
    type, message)} for a stencil energy (image_warping), a contraction,
    linear_solver schur_dense and direct, and a backend that does not suit
    the plan's device (the process group's backend read as "nccl" for a
    plan on the CPU)."""
    import torch.distributed as dist

    import thallo_tpu_torch as tt
    from thallo_tpu_torch import parallel
    from thallo_tpu_torch.models import bundle_adjustment as ba
    from thallo_tpu_torch.models import image_warping as iw

    def stencil():
        plan = tt.load_energy(iw.ENERGY).plan({"W": 16, "H": 8}, device=device)
        plan.init(iw.synthetic_inputs(16, 8))
        return plan, {"W": "x"}

    def contraction():
        rng = np.random.RandomState(0)
        plan = tt.load_energy(CONTRACTION_ENERGY).plan({"N": 16, "K": 3}, device=device)
        plan.init({"C": rng.randn(3).astype(np.float32), "R": rng.randn(16).astype(np.float32),
                   "T": rng.randn(16).astype(np.float32)})
        return plan, {"N": "x"}

    def ba_with(linear_solver):
        def make():
            ins, _ = ba.synthetic_inputs(n_cameras=4, n_points=32, obs_per_point=3)
            plan = tt.load_energy(ba.ENERGY + BA_SPARSE).plan(
                {"C": 4, "P": 32, "O": len(ins["oToC"])}, device=device,
                linear_solver=linear_solver)
            plan.init(ins)
            return plan, {"P": "x", "O": "x"}
        return make

    out = {}
    for name, make in (("stencil", stencil), ("contraction", contraction),
                       ("schur_dense", ba_with("schur_dense")), ("direct", ba_with("direct")),
                       ("backend", ba_with("pcg"))):
        plan, dim_axes = make()
        real = dist.get_backend
        if name == "backend":
            dist.get_backend = lambda group=None: "nccl"
        try:
            parallel.shard_plan_inputs(plan, parallel.make_mesh(), dim_axes=dim_axes)
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
        finally:
            dist.get_backend = real
    return out


def rebind(device="cpu", steps=2):
    """A sharded plan bound anew: init() again and update_inputs() shard
    the new inputs.  Returns the costs of `steps` steps after the first
    init, after the second, the cost after update_inputs (observations
    scaled by 1.001) and the unsharded plan's after the same steps and
    update."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch import parallel
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    dims = {"C": 8, "P": 64, "O": len(ins["oToC"])}

    def make():
        plan = tt.load_energy(ba.ENERGY + BA_SPARSE).plan(dims, device=device)
        plan.set_solver_parameter("lIterations", 8)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        return plan

    plan = make()
    parallel.shard_plan_inputs(plan, parallel.make_mesh(), dim_axes={"P": "x", "O": "x"})
    out = {"first": [], "again": []}
    for key in ("first", "again"):
        if key == "again":
            plan.init({k: np.copy(v) for k, v in ins.items()})
        for _ in range(steps):
            plan.run_steps(1)
            out[key].append(plan.cost())
    new = {"observations": np.asarray(ins["observations"]) * 1.001}
    plan.update_inputs(new)
    out["updated"] = plan.cost()
    plain = make()
    plain.run_steps(steps)
    plain.update_inputs(new)
    out["updated_unsharded"] = plain.cost()
    return out


def checks(device="cpu"):
    """refusals() and rebind() in one start of the ranks."""
    return {"refusals": refusals(device), "rebind": rebind(device)}


def multihost_worker(ckpt_fmt, arap_side=8, steps=3):
    """The multihost checks on this rank, joined by
    parallel.multihost.initialize (RANK, WORLD_SIZE, MASTER_PORT from the
    launcher): is_coordinator, global_mesh over the world (one and two
    axes), checkpoint_per_host's round trip through load_state on a
    sharded plan, and a sharded GN solve of ARAP (side arap_side)."""
    import os

    import thallo_tpu_torch as tt
    from thallo_tpu_torch import parallel
    from thallo_tpu_torch.models import arap_mesh_deformation as arap
    from thallo_tpu_torch.parallel import multihost

    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    multihost.initialize(f"localhost:{os.environ['MASTER_PORT']}", n, rank, device="cpu")
    out = {"is_coordinator": multihost.is_coordinator(), "rank": rank}
    out["mesh"] = multihost.global_mesh(("x",)).shape
    out["mesh2"] = multihost.global_mesh(("x", "y")).shape
    ins = arap.synthetic_inputs(side=arap_side)
    dims = {"N": arap_side ** 2, "E": len(ins["V0"])}

    def make():
        plan = tt.load_energy(arap.ENERGY).plan(dims, solver="gauss_newton", device="cpu")
        plan.set_solver_parameter("nIterations", steps)
        plan.set_solver_parameter("lIterations", 6)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        parallel.shard_plan_inputs(plan, multihost.global_mesh(("x",)),
                                   dim_axes={"N": "x", "E": "x"})
        return plan

    plan = make()
    multihost.checkpoint_per_host(plan, ckpt_fmt)
    saved = {k: _np(plan.get_unknown(k, squeeze=False)) for k in plan._U}
    plan.run_steps(2)
    plan.load_state(ckpt_fmt.format(process=0))
    out["iter_after_load"] = plan._iter
    out["restored"] = all(np.array_equal(saved[k], _np(plan.get_unknown(k, squeeze=False)))
                          for k in saved)
    out["ckpt_exists"] = os.path.exists(ckpt_fmt.format(process=0))
    out["cost"] = make().solve()
    return out


# ---------------------------------------------------------------------------
# the scenes of the command line
# ---------------------------------------------------------------------------
def arap_case(side, n_ranks, steps, want=(), order="owner", dispatch=1, l_iterations=10,
              dim_axes=None):
    from thallo_tpu_torch import parallel
    from thallo_tpu_torch.models import arap_mesh_deformation as arap

    ins = arap.synthetic_inputs(side=side)
    E = len(ins["V0"])
    if order == "owner":
        ins, _ = parallel.sort_edges_by_owner(ins, arap.make_spec(), "E", "V0", n_ranks)
    elif order == "shuffle":
        perm = np.random.RandomState(7).permutation(E)
        ins = dict(ins, V0=np.asarray(ins["V0"])[perm], V1=np.asarray(ins["V1"])[perm])
    return case(arap.ENERGY, {"N": side * side, "E": E}, ins, solver="gauss_newton",
                params={"nIterations": steps, "lIterations": l_iterations},
                dim_axes={"N": "x", "E": "x"} if dim_axes is None else dim_axes,
                steps=steps, want=want, dispatch=dispatch)


def ba_case(scene, size, steps, want=(), dispatch=1, l_iterations=10, dim_axes=None):
    from thallo_tpu_torch.models import bundle_adjustment as ba

    if scene == "ba":
        ins, _ = ba.synthetic_inputs(n_cameras=1024, n_points=size, obs_per_point=4)
    else:
        ins, _ = ba.skewed_inputs(1024, size // 4, size)
    dims = {"C": int(ins["cameras"].shape[0]), "P": int(ins["points"].shape[0]),
            "O": len(ins["oToC"])}
    return case(ba.ENERGY, dims, ins, params={"nIterations": steps,
                                             "lIterations": l_iterations},
                dim_axes={"P": "x", "O": "x"} if dim_axes is None else dim_axes,
                steps=steps, want=want, dispatch=dispatch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--scene", choices=("ba", "ba_skew", "arap"), default="ba")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--dispatch", type=int, default=1)
    a = ap.parse_args(argv)
    from thallo_tpu_torch.parallel.launch import run_ranks

    card = a.device == "cuda"
    if card and torch.cuda.device_count() < a.ranks:
        raise SystemExit(f"--ranks {a.ranks} on the card needs {a.ranks} cards; this machine "
                         f"has {torch.cuda.device_count()} (NCCL refuses two ranks on one card)")
    want = ("record", "report", "times")
    if a.scene == "arap":
        c = arap_case(a.size or (256 if card else 32), a.ranks, a.steps, want,
                      dispatch=a.dispatch)
    else:
        default = {"ba": 250_000 if card else 2_000, "ba_skew": 1_000_000 if card else 8_000}
        c = ba_case(a.scene, a.size or default[a.scene], a.steps, want, dispatch=a.dispatch)
    t0 = time.perf_counter()
    r = run_ranks(run_case, a.ranks, device=a.device, args=(c, a.device), timeout=3000)
    rec = {"scene": a.scene, "ranks": a.ranks, "device": a.device, "steps": a.steps,
           "dispatch": a.dispatch, "c0": r["c0"], "costs": r["costs"],
           "collectives": r["collectives"],
           "report": {k: {"bytes_per_device": v["bytes_per_device"],
                          "replicated": v["replicated"], "shard_shapes": v["shard_shapes"]}
                      for k, v in r["report"].items()},
           "ms": r["ms"], "wall_s": time.perf_counter() - t0}
    if card:
        import subprocess

        rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True,
                                     text=True).stdout.strip().splitlines()
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
