"""Shared pieces of the card-side measurement scripts
(torch_fused_pair_micro.py, torch_fused_variants.py, torch_loop_floor.py,
torch_redesign_sweep.py):
the card's name and power limit, per-launch times of a callable run n
times eagerly and captured in one CUDA graph, and the skewed 1M BA
scene's real fused-pair tables.  Import only; nothing runs on import.
"""
import contextlib
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the JAX scripts' cases: name, Ci, Cj, W, S, N (scripts/tpu_fused_pair_micro.py:161-167)
JAX_CASES = [
    ("ba_1m_pt_cam", 3, 9, 4, 1024, 250_000),
    ("ba_250k_pt_cam", 3, 9, 4, 256, 62_500),
    ("skew_level_w8", 3, 9, 8, 256, 16_384),
    ("skew_level_w2", 3, 9, 2, 256, 32_768),
]
SKEW_1M = (1024, 250_000, 1_000_000)  # cameras, points, target observations


def card():
    """`name, power.limit` as nvidia-smi reports them; exits without a GPU."""
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def eager_ms(fn, n):
    """ms per call of fn over n calls back to back on the current stream
    (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n, replays=1):
    """ms per call of fn over n calls captured in one CUDA graph and
    replayed `replays` times after a warm-up replay (CUDA events around
    the replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def per_launch_ms(fn, n):
    """(eager, graph) ms per call of fn."""
    return eager_ms(fn, n), graph_ms(fn, n)


def max_rel_err(got, ref):
    """max |got - ref| / max |ref| over paired tensors."""
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    return err / max(float(r.abs().max()) for r in ref)


@functools.lru_cache(maxsize=1)
def _skew_bsr():
    """The block-sparse tables of the skewed 1M BA scene's plan, on the
    card."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    C, P, target = SKEW_1M
    inputs, _ = ba.skewed_inputs(n_cameras=C, n_points=P, target_obs=target, seed=0)
    plan = tt.load_energy(ba.ENERGY).plan({"C": C, "P": P, "O": len(inputs["oToC"])},
                                          solver="levenberg_marquardt", device="cuda")
    plan.init(inputs)
    return plan._prep["consts"][0]["bsr"]


def skew_tables(levels=(0, -1)):
    """[(tag, ids [W, N_t] int32 on the card)] of the skewed 1M BA scene
    (skewed_inputs(1024, 250000, target_obs=1_000_000), seed 0) after the
    residual sort: the col tables of `levels` (by default level 0 and the
    widest one; None: all five) that the fused-pair kernels read."""
    bsr = _skew_bsr()
    cols = [bsr.cols[bsr.col_gathers[pr[3]][0]] for pr in bsr.pairs if pr[2] == "col"]
    if levels is None:
        levels = range(len(cols))
    return [(f"skew_1m_{'tail' if k == -1 else f'level{k}'}_w{cols[k].shape[0]}", cols[k])
            for k in levels]


def skew_camera_ids():
    """The skewed 1M BA scene's camera ids in its sorted residual order
    (what oh_setup_products sums by; one camera has half of them)."""
    return next(x for x in _skew_bsr().oh_idxs if x is not None)


def random_ids(rng, W, N, S):
    return torch.from_numpy(rng.integers(0, S, (W, N)).astype(np.int32)).cuda()


def pair_operands(rng, ids, Ci, Cj, S):
    """bf16 blocks [W*Ci*Cj, N], pcol [Cj, S], prow [Ci, N] (seeded)."""
    W, N = ids.shape
    blocks = torch.from_numpy(rng.normal(size=(W * Ci * Cj, N)).astype(np.float32))
    return (ids, blocks.cuda().bfloat16(),
            torch.from_numpy(rng.normal(size=(Cj, S)).astype(np.float32)).cuda(),
            torch.from_numpy(rng.normal(size=(Ci, N)).astype(np.float32)).cuda())


@contextlib.contextmanager
def kept(module, *names):
    """Restores module.<names> when the block ends."""
    saved = {n: getattr(module, n) for n in names}
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(module, n, v)


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
