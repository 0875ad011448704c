// Fused cross-pair block apply (replaces the Pallas kernel of
// thallo_tpu/ops/fusedpair.py::fused_pair_apply).  See
// thallo_tpu_torch/ops/fusedpair.py for the contract.
//
//   rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
//   cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s
//
// One thread per element n, looping over the W degree slots.  Blocks are
// w-major [W, Ci*Cj, N] with N innermost, so a warp reads 32 neighbouring
// floats per block entry (coalesced).  The thread owns rows[:, n]; the
// column side is an atomic add into cols[:, id], whose Cj*S floats stay
// in L2.  Entries with an id outside [0, S) contribute nothing.  The
// caller zeroes cols; the kernel allocates nothing.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxCi = 8;   // ops/fusedpair.py MAX_CI
constexpr int kMaxCj = 16;  // ops/fusedpair.py MAX_CJ

__global__ void fused_pair_kernel(const int* __restrict__ ids,
                                  const float* __restrict__ blocks,
                                  const float* __restrict__ pcol,
                                  const float* __restrict__ prow,
                                  float* __restrict__ rows,
                                  float* __restrict__ cols,
                                  int W, int N, int Ci, int Cj, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t Nz = static_cast<size_t>(N);
  const size_t F = static_cast<size_t>(Ci) * Cj;

  float pr[kMaxCi];
  float acc[kMaxCi];
#pragma unroll
  for (int ci = 0; ci < kMaxCi; ++ci) {
    pr[ci] = ci < Ci ? prow[ci * Nz + n] : 0.f;
    acc[ci] = 0.f;
  }

  for (int w = 0; w < W; ++w) {
    const int id = ids[static_cast<size_t>(w) * Nz + n];
    if (id < 0 || id >= S) continue;  // padded / out-of-range: dropped
    const float* b = blocks + static_cast<size_t>(w) * F * Nz + n;
    float pc[kMaxCj];
    float z[kMaxCj];
#pragma unroll
    for (int cj = 0; cj < kMaxCj; ++cj) {
      pc[cj] = cj < Cj ? __ldg(pcol + static_cast<size_t>(cj) * S + id) : 0.f;
      z[cj] = 0.f;
    }
#pragma unroll
    for (int ci = 0; ci < kMaxCi; ++ci) {
      if (ci < Ci) {
#pragma unroll
        for (int cj = 0; cj < kMaxCj; ++cj) {
          if (cj < Cj) {
            const float bv = __ldg(b + static_cast<size_t>(ci * Cj + cj) * Nz);
            acc[ci] = fmaf(bv, pc[cj], acc[ci]);
            z[cj] = fmaf(bv, pr[ci], z[cj]);
          }
        }
      }
    }
#pragma unroll
    for (int cj = 0; cj < kMaxCj; ++cj) {
      if (cj < Cj) atomicAdd(cols + static_cast<size_t>(cj) * S + id, z[cj]);
    }
  }

#pragma unroll
  for (int ci = 0; ci < kMaxCi; ++ci) {
    if (ci < Ci) rows[ci * Nz + n] = acc[ci];
  }
}

}  // namespace

extern "C" int thallo_fused_pair_apply(const void* ids, const void* blocks,
                                       const void* pcol, const void* prow,
                                       void* rows, void* cols, int W, int N,
                                       int Ci, int Cj, int S, void* stream) {
  if (Ci < 1 || Ci > kMaxCi || Cj < 1 || Cj > kMaxCj) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0) {
    constexpr int kThreads = 256;
    const int grid = (N + kThreads - 1) / kThreads;
    fused_pair_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(blocks),
        static_cast<const float*>(pcol), static_cast<const float*>(prow),
        static_cast<float*>(rows), static_cast<float*>(cols), W, N, Ci, Cj, S);
  }
  return static_cast<int>(cudaGetLastError());
}
