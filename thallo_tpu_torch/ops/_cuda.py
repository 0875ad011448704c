"""Build and load the port's CUDA kernels.

On first use, every ``thallo_tpu_torch/csrc/*.cu`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, and loaded with ``ctypes``.  The library lands in
``build/thallo_tpu_torch/`` beside the package under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing build.  nvcc's register and spill
report (``-Xptxas -v``) is kept beside the library as ``<lib>.log``.
Nothing here runs at import time.

Every exported launcher takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream without synchronising, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` turns a non-zero
code into an exception.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thallo_tpu_torch"

P, I = ctypes.c_void_p, ctypes.c_int
# exported symbol -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "thallo_fused_pair_apply": (P, P, P, P, P, P, I, I, I, I, I, P),
    "thallo_oh_setup_products": (P, P, P, P, P, I, I, I, I, P),
    "thallo_fullrepeat_setup": (P, P, P, P, P, I, I, I, I, P),
}

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
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
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


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Wrapper-side validation before a pointer crosses into C."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.lru_cache(maxsize=64)
def recipe_tensor(rows, device) -> torch.Tensor:
    """A static recipe (tuple of 6-int tuples), as [len, 6] int32 on the
    device; cached, so a repeated call uploads nothing."""
    flat = [int(v) for row in rows for v in row]
    return torch.tensor(flat, dtype=torch.int32).reshape(-1, 6).to(device)
