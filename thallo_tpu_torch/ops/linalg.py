"""The symmetric eigendecomposition of Gauss-Newton's dense Schur solve,
in a form a CUDA graph can hold.

``torch.linalg.eigh`` checks cuSOLVER's info on the host, and
cuSOLVER's ``syevd``, ``syevj`` and ``Xsyevd`` fail a stream capture on
the H100.  ``cusolverDnXsyevBatched`` with a batch of one captures up to
``SYEV_CAPTURE_MAX`` rows (144 and 512 capture, 1024 fails:
scripts/torch_syev_capture.py) and needs no host workspace.  ``eigh``
calls it through ctypes on the card at that size, with its info left on
the device (a failed solve gives NaN eigenvalues), and torch.linalg.eigh
elsewhere: on the CPU (the plain version), and on the card above that
size (a step then cannot be captured; ``CompiledSolver.uncapturable``
names it).  Nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# the largest symmetric matrix whose cuSOLVER eigendecomposition a CUDA
# graph holds (cusolverDnXsyevBatched; measured on the H100)
SYEV_CAPTURE_MAX = 512
_CUSOLVER_EIG_MODE_VECTOR = 1
_CUBLAS_FILL_MODE_LOWER = 0
_CUDA_R = {torch.float32: 0, torch.float64: 1}  # cudaDataType CUDA_R_32F, CUDA_R_64F
_V, _I64, _SZ = ctypes.c_void_p, ctypes.c_int64, ctypes.c_size_t


@functools.lru_cache(maxsize=None)
def _cusolver():
    """libcusolver, as the CUDA build of torch loaded it."""
    lib = ctypes.CDLL("libcusolver.so.11")
    lib.cusolverDnXsyevBatched_bufferSize.argtypes = [
        _V, _V, ctypes.c_int, ctypes.c_int, _I64, ctypes.c_int, _V, _I64, ctypes.c_int, _V,
        ctypes.c_int, ctypes.POINTER(_SZ), ctypes.POINTER(_SZ), _I64]
    lib.cusolverDnXsyevBatched.argtypes = [
        _V, _V, ctypes.c_int, ctypes.c_int, _I64, ctypes.c_int, _V, _I64, ctypes.c_int, _V,
        ctypes.c_int, _V, _SZ, _V, _SZ, _V, _I64]
    return lib


@functools.lru_cache(maxsize=None)
def _handle(device_index: int):
    """(cusolverDn handle, params) of one card, made once (outside any
    capture: the first call is an eager step)."""
    lib = _cusolver()
    with torch.cuda.device(device_index):
        h, params = _V(), _V()
        _check(lib.cusolverDnCreate(ctypes.byref(h)), "cusolverDnCreate")
        _check(lib.cusolverDnCreateParams(ctypes.byref(params)), "cusolverDnCreateParams")
    return h, params


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: cusolverStatus {status}")


def eigh(S: torch.Tensor):
    """(eigenvalues ascending [K], eigenvectors as the columns of [K, K])
    of a symmetric S, as torch.linalg.eigh gives them; on the card at
    K <= SYEV_CAPTURE_MAX with no host read."""
    K = S.shape[0]
    if S.device.type != "cuda" or K > SYEV_CAPTURE_MAX:
        return torch.linalg.eigh(S)
    lib = _cusolver()
    h, params = _handle(S.device.index if S.device.index is not None
                        else torch.cuda.current_device())
    _check(lib.cusolverDnSetStream(h, _V(torch.cuda.current_stream(S.device).cuda_stream)),
           "cusolverDnSetStream")
    A = S.contiguous().clone()  # overwritten by the eigenvectors, column-major
    W = torch.empty(K, dtype=S.dtype, device=S.device)
    info = torch.zeros(1, dtype=torch.int32, device=S.device)
    t = _CUDA_R[S.dtype]
    dev_bytes, host_bytes = _SZ(), _SZ()
    _check(lib.cusolverDnXsyevBatched_bufferSize(
        h, params, _CUSOLVER_EIG_MODE_VECTOR, _CUBLAS_FILL_MODE_LOWER, K, t, A.data_ptr(), K,
        t, W.data_ptr(), t, ctypes.byref(dev_bytes), ctypes.byref(host_bytes), 1),
        "cusolverDnXsyevBatched_bufferSize")
    work = torch.empty(max(dev_bytes.value, 1), dtype=torch.uint8, device=S.device)
    host = ctypes.create_string_buffer(max(host_bytes.value, 1))
    _check(lib.cusolverDnXsyevBatched(
        h, params, _CUSOLVER_EIG_MODE_VECTOR, _CUBLAS_FILL_MODE_LOWER, K, t, A.data_ptr(), K,
        t, W.data_ptr(), t, work.data_ptr(), dev_bytes.value, ctypes.addressof(host),
        host_bytes.value, info.data_ptr(), 1), "cusolverDnXsyevBatched")
    W = torch.where(info == 0, W, torch.full_like(W, float("nan")))
    return W, A.mT
