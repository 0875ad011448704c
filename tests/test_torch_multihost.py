"""The port's parallel/multihost.py (tests/test_multihost.py's
counterpart): the helpers of a one-process job, then two processes joined
by multihost.initialize("localhost:<port>", 2, i) over gloo, each running
scripts/torch_sharded_solve.py's multihost_worker (the port alone, no
JAX): is_coordinator, global_mesh over the world, checkpoint_per_host's
round trip through load_state on a sharded plan, and a sharded GN solve
against the single-process cost.

JAX's two-process worker (tests/mh_worker.py) solves image_warping, a grid
energy: tests/test_torch_parallel_grid.py holds that solve; this file
solves ARAP side 8 (a graph energy).  The bound is mh_worker.py's:
the two processes' f32 sums run in another order than one process's, so
an unconverged checkpoint's cost may move by ~0.2%.
"""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import arap_mesh_deformation as jarap  # noqa: E402
from thallo_tpu.parallel import make_mesh, shard_plan_inputs  # noqa: E402
from thallo_tpu_torch.models import arap_mesh_deformation as arap  # noqa: E402
from thallo_tpu_torch.parallel import multihost  # noqa: E402
from thallo_tpu_torch.parallel.launch import run_ranks  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "torch_sharded_solve", Path(__file__).resolve().parent.parent / "scripts" /
    "torch_sharded_solve.py")
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

MH_RTOL = 5e-3  # tests/mh_worker.py:36-38


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Two processes joined by multihost.initialize, every check on them."""
    fmt = str(tmp_path_factory.mktemp("ckpt") / "ckpt_{process}.npz")
    return run_ranks(S.multihost_worker, 2, device="cpu", args=(fmt,), join=False,
                     timeout=300), fmt


def _single_cost(steps=3):
    ins = arap.synthetic_inputs(side=8)
    plan = tt.load_energy(arap.ENERGY).plan({"N": 64, "E": len(ins["V0"])},
                                            solver="gauss_newton", device="cpu")
    plan.set_solver_parameter("nIterations", steps)
    plan.set_solver_parameter("lIterations", 6)
    plan.init(ins)
    return plan.solve()


def test_is_coordinator_single_process():
    assert multihost.is_coordinator() is True


def test_global_mesh_single_process():
    assert multihost.global_mesh(("x",)).size == 1
    assert set(multihost.global_mesh(("x", "y")).axis_names) == {"x", "y"}


def test_checkpoint_per_host_single_process(tmp_path):
    """An unsharded plan: the coordinator writes, load_state restores."""
    src = """
W = Dims("W")
Inputs(X=Unknown(float, (W,), 0), A=Array(float, (W,), 1))
x = W()
r = Residuals(fit=X(x) - A(x))
"""
    plan = tt.load_energy(src).plan({"W": 8}, device="cpu")
    rng = np.random.RandomState(0)
    plan.init({"X": rng.randn(8).astype(np.float32), "A": rng.randn(8).astype(np.float32)})
    path = str(tmp_path / "ckpt_{process}.npz")
    multihost.checkpoint_per_host(plan, path)
    assert os.path.exists(path.format(process=0))
    plan.run_steps(2)
    plan.load_state(path.format(process=0))
    assert plan._iter == 0


def test_two_process_helpers(two):
    r, _ = two
    assert r["rank"] == 0 and r["is_coordinator"] is True
    assert r["mesh"] == {"x": 2} and r["mesh2"] == {"x": 2, "y": 1}


def test_two_process_checkpoint_round_trip(two):
    """A sharded plan's checkpoint: gathered to rank 0, written once, read
    on rank 0 and handed out; the state after two more steps is undone."""
    r, fmt = two
    assert r["ckpt_exists"] and os.path.exists(fmt.format(process=0))
    assert r["iter_after_load"] == 0 and r["restored"]
    with np.load(fmt.format(process=0)) as z:
        assert z["U::Position"].shape == (64, 3)  # the whole unknown, not a shard


def test_two_process_sharded_solve(two):
    """The sharded GN solve over two processes against one process, and
    against JAX's solve of the same ARAP scene sharded alike ({"N", "E"})
    over two devices of its CPU mesh."""
    r, _ = two
    ref = _single_cost()
    assert abs(r["cost"] - ref) <= MH_RTOL * max(abs(ref), 1.0), (r["cost"], ref)
    jins = jarap.synthetic_inputs(side=8)
    jplan = jarap.make_spec().plan({"N": 64, "E": len(jins["V0"])}, solver="gauss_newton")
    jplan.set_solver_parameter("nIterations", 3)
    jplan.set_solver_parameter("lIterations", 6)
    jplan.init(jins)
    mesh = make_mesh(2, axis_names=("x",))
    shard_plan_inputs(jplan, mesh, dim_axes={"N": "x", "E": "x"})
    with mesh:
        jref = float(jplan.solve())
    assert abs(r["cost"] - jref) <= MH_RTOL * max(abs(jref), 1.0), (r["cost"], jref)
