"""Start one process per rank on this machine and return rank 0's result.

``run_ranks(fn, n, device, backend)`` runs ``fn(*args)`` in n fresh
Python processes joined into one process group (a file store in a
temporary directory, so no port is raced for).  Each child is ``python -m thallo_tpu_torch.parallel.launch``:
it imports torch, this package and fn's module, nothing else (no test
configuration, no JAX), so fn must live in a module that imports only the
port (a script's functions qualify: a script run as __main__ is loaded
from its file).  On the CPU each child runs one torch thread; on the card
rank r works on card r.  A child that fails makes run_ranks raise with
every child's output.
"""
from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fn_ref(fn):
    """(module name, or the file of a module outside the package, and the
    qualified name) of a module-level fn."""
    if fn.__module__.split(".")[0] == "thallo_tpu_torch":
        return fn.__module__, fn.__qualname__
    return str(Path(fn.__code__.co_filename).resolve()), fn.__qualname__


def _load_fn(where, qualname):
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_thallo_rank_main", where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def run_ranks(fn, n: int, device: str = "cuda", backend: str = None, args=(), join=True,
              timeout: float = 600.0):
    """fn(*args) on n ranks; returns rank 0's result.  device: "cuda"
    (the default, as every entry point of the port; raises here, before
    any rank starts, where torch finds no CUDA device) or "cpu".  backend
    defaults to the device's ("gloo" on the CPU, "nccl" on the card); a collective
    waits at most `timeout` seconds, and so do the ranks.  join=False
    leaves joining to fn (e.g. parallel.multihost.initialize): the child
    then finds its rank, the world size and a free port in RANK,
    WORLD_SIZE and MASTER_PORT."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: device='cuda' but torch finds no CUDA device; "
                               "pass device='cpu' to run the ranks on the CPU")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="thallo_ranks_") as tmp:
        job = Path(tmp) / "job.pkl"
        job.write_bytes(pickle.dumps({"fn": _fn_ref(fn), "args": tuple(args),
                                      "device": device, "backend": backend, "join": join,
                                      "timeout": timeout}))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env.update(WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        if device == "cpu":
            env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs = []
        for r in range(n):
            env_r = dict(env, RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "thallo_tpu_torch.parallel.launch", tmp],
                env=env_r, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs, late = [], False
        try:
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=timeout)[0])
                except subprocess.TimeoutExpired:
                    late = True
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            outs += [p.communicate()[0] for p in procs[len(outs):]]
        if late or any(p.returncode != 0 for p in procs):
            raise RuntimeError(("the ranks ran past their time limit" if late else
                                "a rank failed") + ":\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode}):\n{o}"
                for r, (p, o) in enumerate(zip(procs, outs))))
        return pickle.loads((Path(tmp) / "rank0.pkl").read_bytes())


def _child(tmp):
    import torch
    import torch.distributed as dist

    job = pickle.loads((Path(tmp) / "job.pkl").read_bytes())
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if job["join"]:  # a file store in the job's directory: no port to race for
        dist.init_process_group(job["backend"], init_method=f"file://{tmp}/store",
                                world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=job["timeout"]))
    try:
        result = _load_fn(*job["fn"])(*job["args"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        (Path(tmp) / "rank0.pkl").write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _child(sys.argv[1])
