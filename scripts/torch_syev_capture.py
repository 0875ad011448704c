"""Which cuSOLVER symmetric eigensolver a CUDA graph can hold on this
card: the evidence behind ops/linalg.py's SYEV_CAPTURE_MAX.

    python3 scripts/torch_syev_capture.py [--out FILE]

Each case runs in a fresh process (a failed capture spoils the CUDA
context): the solver on a seeded S = M Mᵀ, eagerly, then captured in a
CUDA graph and replayed.  Solvers: ``batched`` (cusolverDnXsyevBatched,
a batch of one, as ops/linalg.eigh calls it) at K = 144, 512, 1024,
2048 in f32 and 512 in f64, and the legacy ``syevd`` and ``syevj`` at
K = 144.  One JSON line a case: whether it captured, the largest
eigenvalue error of the replay against torch.linalg.eigh in f64
(relative to the largest eigenvalue), and the eager and replay ms.
Needs CUDA.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CASES = [("batched", 144, "f32"), ("batched", 512, "f32"), ("batched", 1024, "f32"),
         ("batched", 2048, "f32"), ("batched", 512, "f64"), ("syevd", 144, "f32"),
         ("syevj", 144, "f32")]
V = ctypes.c_void_p


def legacy(which, S):
    """cusolverDn{S,D}syevd / syevj on S (eigenvalues, eigenvectors)."""
    cs = ctypes.CDLL("libcusolver.so.11")
    h = V()
    assert cs.cusolverDnCreate(ctypes.byref(h)) == 0
    assert cs.cusolverDnSetStream(h, V(torch.cuda.current_stream().cuda_stream)) == 0
    K, p = S.shape[0], "D" if S.dtype == torch.float64 else "S"
    A, W = S.clone(), torch.empty(K, dtype=S.dtype, device=S.device)
    info, lw = torch.zeros(1, dtype=torch.int32, device=S.device), ctypes.c_int()
    extra = ()
    if which == "syevj":
        params = V()
        assert cs.cusolverDnCreateSyevjInfo(ctypes.byref(params)) == 0
        extra = (params,)
    bs = getattr(cs, f"cusolverDn{p}{which}_bufferSize")
    assert bs(h, 1, 0, K, V(A.data_ptr()), K, V(W.data_ptr()), ctypes.byref(lw), *extra) == 0
    work = torch.empty(lw.value, dtype=S.dtype, device=S.device)
    fn = getattr(cs, f"cusolverDn{p}{which}")
    st = fn(h, 1, 0, K, V(A.data_ptr()), K, V(W.data_ptr()), V(work.data_ptr()), lw,
            V(info.data_ptr()), *extra)
    if st != 0:
        raise RuntimeError(f"cusolverDn{p}{which}: status {st}")
    return W, A.mT


def one(which, K, dt):
    from thallo_tpu_torch.ops import linalg

    dtype = torch.float64 if dt == "f64" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(0)
    M = torch.randn(K, K, device="cuda", dtype=dtype, generator=g)
    S = M @ M.T
    ref = torch.linalg.eigvalsh(S.double())
    solve = (lambda X: linalg.eigh(X)) if which == "batched" else (lambda X: legacy(which, X))
    if which == "batched" and K > linalg.SYEV_CAPTURE_MAX:
        linalg.SYEV_CAPTURE_MAX = K  # the batched call itself, above the port's limit
    rec = {"solver": which, "K": K, "dtype": dt}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve(S)
    torch.cuda.synchronize()
    rec["eager_ms"] = (time.perf_counter() - t0) * 1e3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve(S)
    torch.cuda.current_stream().wait_stream(side)
    graph, out = torch.cuda.CUDAGraph(), {}
    try:
        with torch.cuda.graph(graph):
            out["lam"] = solve(S)[0]
        graph.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        rec["replay_ms"] = (time.perf_counter() - t0) * 1e3
        rec["captured"] = True
        rec["max_err"] = float((out["lam"].double() - ref).abs().max() / ref.abs().max())
    except Exception as e:  # noqa: BLE001 - the record says what failed
        rec["captured"] = False
        rec["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--case", nargs=3, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.case:
        print(json.dumps(one(a.case[0], int(a.case[1]), a.case[2])))
        return
    for which, K, dt in CASES:
        p = subprocess.run([sys.executable, __file__, "--case", which, str(K), dt],
                           capture_output=True, text=True, timeout=300)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if lines else {
            "solver": which, "K": K, "dtype": dt, "captured": False,
            "error": (p.stderr.strip().splitlines() or ["no output"])[-1][:200]}
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
