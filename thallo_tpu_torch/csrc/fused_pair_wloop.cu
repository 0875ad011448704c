// Fused cross-pair block apply for wide degree levels (replaces the
// W-loop body of thallo_tpu/ops/fusedpair.py::fused_pair_apply,
// `_kernel_wloop`, which JAX takes where W > 8).  The contract is that of
// csrc/fused_pair.cu (thallo_tpu_torch/ops/fusedpair.py):
//
//   rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
//   cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s
//
// The skewed levels are wide and short (W = 716 over N = 325 elements on
// the skewed 1M BA scene): one thread per element, as in fused_pair.cu,
// would run 11 warps, each looping 716 times.  Here the grid is
// (32-element tile, w-chunk, cj-chunk).  The 8 warps of a block take the
// w of its chunk in turn, lane = element, so a warp reads 32 neighbouring
// floats of one w-plane (coalesced).  Rows: each thread sums its w's in
// registers, the 8 warps' sums meet in shared memory, and the block adds
// them to rows with one global atomic per (ci, element).  Cols: the block
// sums its z values into a shared [cj-chunk, S] accumulator (36 KB for
// 9 x 1024) with shared atomics and then adds each nonzero entry to cols
// with one global atomic, so a hot column id meets the other lanes of its
// block in shared memory first (csrc/oh_aggregate.cu's design).  A
// cj-chunk is as many channels as fit kMaxSmem; chunks past the first
// re-read the ids and their own block rows.  The bound is the block read,
// W*Ci*Cj*N*4 bytes.  The caller zeroes rows and cols; the kernel
// allocates nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kMaxCi = 8;    // ops/fusedpair.py MAX_CI
constexpr int kMaxCj = 16;   // ops/fusedpair.py MAX_CJ
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 96 * 1024;  // ops/_cuda.py MAX_DYNAMIC_SMEM

__global__ void fused_pair_wloop_kernel(const int* __restrict__ ids,
                                        const float* __restrict__ blocks,
                                        const float* __restrict__ pcol,
                                        const float* __restrict__ prow,
                                        float* __restrict__ rows,
                                        float* __restrict__ cols,
                                        int W, int N, int Ci, int Cj, int S,
                                        int w_per_block, int c_chunk) {
  extern __shared__ float acc_cols[];  // [cc, S]
  __shared__ float part_rows[kMaxCi][kWarps][32];
  const int c0 = blockIdx.z * c_chunk;
  const int cc = min(c_chunk, Cj - c0);
  const int n_acc = cc * S;
  for (int i = threadIdx.x; i < n_acc; i += kThreads) acc_cols[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int w_end = min(W, (blockIdx.y + 1) * w_per_block);
  const size_t Nz = static_cast<size_t>(N);
  const size_t F = static_cast<size_t>(Ci) * Cj;

  float acc[kMaxCi];
  float pr[kMaxCi];
#pragma unroll
  for (int ci = 0; ci < kMaxCi; ++ci) {
    acc[ci] = 0.f;
    pr[ci] = (ci < Ci && n < N) ? __ldg(prow + ci * Nz + n) : 0.f;
  }
  if (n < N) {
    for (int w = blockIdx.y * w_per_block + warp; w < w_end; w += kWarps) {
      const int id = __ldg(ids + static_cast<size_t>(w) * Nz + n);
      if (id < 0 || id >= S) continue;  // padded / out-of-range: dropped
      const float* b = blocks + static_cast<size_t>(w) * F * Nz + n;
      float pc[kMaxCj];
      float z[kMaxCj];
#pragma unroll
      for (int k = 0; k < kMaxCj; ++k) {
        pc[k] = k < cc ? __ldg(pcol + static_cast<size_t>(c0 + k) * S + id) : 0.f;
        z[k] = 0.f;
      }
#pragma unroll
      for (int ci = 0; ci < kMaxCi; ++ci) {
        if (ci < Ci) {
#pragma unroll
          for (int k = 0; k < kMaxCj; ++k) {
            if (k < cc) {
              const float bv = __ldg(b + static_cast<size_t>(ci * Cj + c0 + k) * Nz);
              acc[ci] = fmaf(bv, pc[k], acc[ci]);
              z[k] = fmaf(bv, pr[ci], z[k]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxCj; ++k) {
        if (k < cc && z[k] != 0.f) atomicAdd(acc_cols + k * S + id, z[k]);
      }
    }
  }
#pragma unroll
  for (int ci = 0; ci < kMaxCi; ++ci) {
    if (ci < Ci) part_rows[ci][warp][lane] = acc[ci];
  }
  __syncthreads();

  if (warp == 0 && n < N) {
    for (int ci = 0; ci < Ci; ++ci) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += part_rows[ci][k][lane];
      if (s != 0.f) atomicAdd(rows + ci * Nz + n, s);
    }
  }
  float* out = cols + static_cast<size_t>(c0) * S;
  for (int i = threadIdx.x; i < n_acc; i += kThreads) {
    const float v = acc_cols[i];
    if (v != 0.f) atomicAdd(out + i, v);
  }
}

}  // namespace

extern "C" int thallo_fused_pair_wloop(const void* ids, const void* blocks,
                                       const void* pcol, const void* prow,
                                       void* rows, void* cols, int W, int N,
                                       int Ci, int Cj, int S, void* stream) {
  if (Ci < 1 || Ci > kMaxCi || Cj < 1 || Cj > kMaxCj || S < 1 ||
      static_cast<size_t>(S) * sizeof(float) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0 && W > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int c_chunk = std::min(Cj, kMaxSmem / static_cast<int>(S * sizeof(float)));
    const int c_chunks = (Cj + c_chunk - 1) / c_chunk;
    const int n_tiles = (N + 31) / 32;
    // w per thread: enough blocks for about two per SM over all chunks,
    // no more w-chunks than W has rounds of kWarps
    const long long work = static_cast<long long>(W) * n_tiles * c_chunks;
    const int w_rounds = (W + kWarps - 1) / kWarps;
    const int per_thread = static_cast<int>(std::max<long long>(
        1, std::min<long long>(w_rounds, (work + kWarps * 2LL * sms - 1) / (kWarps * 2LL * sms))));
    const int w_per_block = per_thread * kWarps;
    const int w_chunks = (W + w_per_block - 1) / w_per_block;
    const size_t smem = static_cast<size_t>(c_chunk) * S * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(fused_pair_wloop_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    fused_pair_wloop_kernel<<<dim3(n_tiles, w_chunks, c_chunks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(blocks),
        static_cast<const float*>(pcol), static_cast<const float*>(prow),
        static_cast<float*>(rows), static_cast<float*>(cols), W, N, Ci, Cj, S,
        w_per_block, c_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
