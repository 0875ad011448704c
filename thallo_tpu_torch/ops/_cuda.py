"""Build and load the port's CUDA kernels.

On first use, every ``thallo_tpu_torch/csrc/*.cu`` is compiled by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/thallo_tpu_torch/`` beside the package under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing build.  nvcc's register and spill
report (``-Xptxas -v``) is kept beside the library as ``<lib>.log``.
Nothing here runs at import time.

Every exported launcher takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream without synchronising, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` turns a non-zero
code into an exception.

The solver's ``double_precision`` runs f64 instantiations of the kernels
its default schedules launch (the ``*_f64`` exports: the same sources,
templated on the value type).  A kernel without one refuses an f64
tensor with NotImplementedError (``require``), naming ``F64_TODO``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dynamic shared memory a launcher may request (csrc/*.cu kMaxSmem)
MAX_DYNAMIC_SMEM = 96 * 1024
SM_SMEM = 227 * 1024  # shared memory the blocks resident on one H100 SM share
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thallo_tpu_torch"

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
IP = ctypes.POINTER(ctypes.c_int)
# exported symbol -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "thallo_fused_pair_persistent": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, P),
    "thallo_fused_pair_persistent_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    "thallo_fused_pair_atomics": (P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_fused_pair_atomics_slots": (P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_fused_pair_atomics_slots_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, P),
    "thallo_oh_setup_products": (P, P, P, P, P, I, I, I, I, P),
    "thallo_fullrepeat_setup_thread": (P, P, P, P, P, I, I, I, I, P),
    "thallo_fullrepeat_setup_tiles": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P),
    "thallo_oh_setup_aggregate_atomics": (P, P, P, I, I, I, P),
    "thallo_oh_setup_aggregate_smem": (P, P, P, I, I, I, I, I, I, I, I, P),
    "thallo_segment_sum": (P, L, L, P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_segment_sum_staged": (P, L, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_segment_sum_ring": (P, L, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "thallo_segment_sum_staged_order": (P, L, L, P, P, P, P, P, I, I, I, I, P),
    "thallo_fused_pair_wloop": (P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_fused_pair_wloop_persistent": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    "thallo_fused_pair_wloop_persistent_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    "thallo_oh_setup_products_persistent": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    "thallo_fused_pair_bf16": (P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "thallo_fused_pair_cluster": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P),
    "thallo_fused_pair_cluster_occupancy": (I, I, I, I, I, IP),
    "thallo_loop_floor_add_one": (P, P, I, P),
    "thallo_fused_pair_rows": (P, P, P, P, I, I, I, I, I, I, I, I, P),
    # f64 instantiations (double_precision)
    "thallo_fused_pair_persistent_f64": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, P),
    "thallo_fused_pair_atomics_f64": (P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_fused_pair_atomics_slots_f64": (P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_oh_setup_products_persistent_f64": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    "thallo_fullrepeat_setup_tiles_f64": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P),
    "thallo_oh_setup_aggregate_smem_f64": (P, P, P, I, I, I, I, I, I, I, I, P),
    "thallo_segment_sum_f64": (P, L, L, P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_segment_sum_staged_f64": (P, L, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_segment_sum_ring_f64": (P, L, P, P, P, P, P, I, I, I, I, I, I, I, P),
    "thallo_segment_sum_staged_order_f64": (P, L, L, P, P, P, P, P, I, I, I, I, P),
}
# where the kernels without an f64 instantiation wait
F64_TODO = "ROADMAP queue 2, item 7"

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of thallo_tpu_torch are "
                       "built on first use and need the CUDA toolkit")


def build() -> Path:
    """Compile the kernels if no build of the current sources exists;
    returns the library path."""
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(_CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libthallo_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{lib.name}.{os.getpid()}"
    objs = [BUILD_DIR / f".{s.stem}.{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    log = []
    for s, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        log.append(f"== {s.name}\n{out}")
        if proc.returncode != 0:
            for other in procs:
                other.wait()
            raise RuntimeError(f"nvcc failed on {s.name} ({proc.returncode}):\n{out}")
    tmp = BUILD_DIR / f".{tag}.tmp"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for o in objs:
        o.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    Path(f"{lib}.log").write_text("".join(log))
    os.replace(tmp, lib)
    return lib


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def blocks_per_sm(block_smem: int, wanted: int) -> int:
    """Blocks of block_smem bytes of shared memory (plus the 1 KB a block
    reserves) that one SM holds at once, at most wanted, at least 1."""
    return max(1, min(wanted, SM_SMEM // (block_smem + 1024)))


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Wrapper-side validation before a pointer crosses into C.  An f64
    tensor where the kernel takes another type raises NotImplementedError:
    that kernel has no f64 instantiation (F64_TODO); no f64 value is cast
    down on the card."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype == torch.float64 and dtype != torch.float64:
        raise NotImplementedError(f"{name}: this kernel has no f64 instantiation ({F64_TODO})")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.lru_cache(maxsize=64)
def recipe_tensor(rows, device) -> torch.Tensor:
    """A static table (tuple of equal-length int tuples: a recipe, a
    channel plan), as [len, width] int32 on the device; cached, so a
    repeated call uploads nothing."""
    flat = [int(v) for row in rows for v in row]
    return torch.tensor(flat, dtype=torch.int32).reshape(len(rows), -1).to(device)
