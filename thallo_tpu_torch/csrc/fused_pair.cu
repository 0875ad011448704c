// Fused cross-pair block apply (replaces the Pallas kernel of
// thallo_tpu/ops/fusedpair.py::fused_pair_apply, body `_kernel`).  See
// thallo_tpu_torch/ops/fusedpair.py for the contract.
//
//   rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
//   cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s
//
// Blocks are w-major [W, Ci*Cj, N] with N innermost; entries with an id
// outside [0, S) contribute nothing.  The bound is the block read
// (W*Ci*Cj*N*4 bytes); what costs beyond it is the cols side, W*N*Cj
// scattered additions, half of them onto one camera's Cj addresses on a
// degree-skewed scene.  Two kernels:
//
// fused_pair_persistent_kernel<Ci, Cj, kCols>  (thallo_fused_pair_persistent)
//   Specialised on the pair's channel counts (3 x 9, the point-camera
//   pair of bundle adjustment), so the Ci*Cj products are unrolled with
//   no guard and a thread keeps ~44 registers: many warps stay resident
//   to cover the shared atomics.  A fixed grid of blocks (a few per SM)
//   strides over tiles of one element per thread, neighbouring threads on
//   neighbouring elements of each block plane.  (Two or four neighbouring
//   elements per thread with 8- or 16-byte loads were measured on the
//   H100: the rows side alone gained up to 20%, the whole kernel lost
//   30-55% to the registers and the serial merges, so one it is.)  The cols
//   side goes to a [Cj, S] f32 accumulator in dynamic shared memory,
//   zeroed once per block and flushed once with one global atomic per
//   nonzero entry.  Before the shared atomics a warp merges equal ids:
//   __match_any_sync groups the lanes, and only when some group has at
//   least merge_min lanes (a warp-uniform test, one match and one vote
//   when ids are spread) the groups sum their z vectors by shuffles and
//   each group's first lane adds once, so the hot camera costs a warp one
//   addition per channel instead of up to 32 serialised ones.  kCols =
//   false compiles the cols side out: the rows-only floor of the design.
//
// fused_pair_atomics_kernel  (thallo_fused_pair_atomics)
//   Any (Ci, Cj) up to 8 x 16 and any S: one thread per element, rows
//   owned, cols by one global atomic per (w, n, cj).  Takes the shapes
//   the persistent kernel does not (an accumulator beyond the shared
//   memory, another pair).
//
// add_cols (the warp merge) lives in block_accum.cuh, shared with the
// W-loop kernel and oh_setup.cu.  The caller zeroes cols; the kernels
// allocate nothing.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_accum.cuh"  // add_cols

namespace {

constexpr int kMaxCi = 8;   // ops/fusedpair.py MAX_CI
constexpr int kMaxCj = 16;  // ops/fusedpair.py MAX_CJ
constexpr int kThreads = 256;      // the atomics kernel's block
constexpr int kMaxThreads = 1024;  // the persistent kernel's largest block
constexpr int kMaxSmem = 112 * 1024;  // ops/fusedpair.py PERSISTENT_MAX_SMEM

__global__ void fused_pair_atomics_kernel(const int* __restrict__ ids,
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

template <int kCi, int kCj, bool kCols>
__global__ void __launch_bounds__(kMaxThreads)
    fused_pair_persistent_kernel(const int* __restrict__ ids, const float* __restrict__ blocks,
                                 const float* __restrict__ pcol,
                                 const float* __restrict__ prow, float* __restrict__ rows,
                                 float* __restrict__ cols, int W, int N, int S, int n_tiles,
                                 int merge_min) {
  extern __shared__ float acc_cols[];  // [kCj, S]
  const int n_acc = kCj * S;
  if (kCols) {
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_cols[i] = 0.f;
    __syncthreads();
  }
  constexpr int kF = kCi * kCj;
  const size_t Nz = static_cast<size_t>(N);
  const int lane = threadIdx.x & 31;

  // the trip counts of both loops are the same for every lane of a warp,
  // so all 32 lanes reach add_cols's warp primitives together
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile * blockDim.x + threadIdx.x;
    const bool live = n < N;
    float pr[kCi];
    float acc[kCi];
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
      pr[ci] = live ? __ldg(prow + ci * Nz + n) : 0.f;
      acc[ci] = 0.f;
    }
    for (int w = 0; w < W; ++w) {
      const int id = live ? __ldg(ids + static_cast<size_t>(w) * Nz + n) : -1;
      const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(S);
      float z[kCj];
#pragma unroll
      for (int cj = 0; cj < kCj; ++cj) z[cj] = 0.f;
      if (ok) {  // padded / out-of-range entries read no block
        float pc[kCj];
#pragma unroll
        for (int cj = 0; cj < kCj; ++cj) pc[cj] = __ldg(pcol + static_cast<size_t>(cj) * S + id);
        const float* b = blocks + static_cast<size_t>(w) * kF * Nz + n;
#pragma unroll
        for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
          for (int cj = 0; cj < kCj; ++cj) {
            // read once: streamed past the caches that hold pcol and ids
            const float bv = __ldcs(b + static_cast<size_t>(ci * kCj + cj) * Nz);
            acc[ci] = fmaf(bv, pc[cj], acc[ci]);
            if (kCols) z[cj] = fmaf(bv, pr[ci], z[cj]);
          }
        }
      }
      if (kCols) add_cols<kCj>(acc_cols, S, id, ok, z, lane, merge_min);
    }
    if (live) {
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) rows[ci * Nz + n] = acc[ci];
    }
  }

  if (kCols) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
      const float v = acc_cols[i];
      if (v != 0.f) atomicAdd(cols + i, v);
    }
  }
}

template <bool kCols>
cudaError_t launch_persistent(const void* ids, const void* blocks, const void* pcol,
                              const void* prow, void* rows, void* cols, int W, int N, int S,
                              int threads, int grid, int merge_min, cudaStream_t stream) {
  auto kernel = fused_pair_persistent_kernel<3, 9, kCols>;
  const size_t smem = kCols ? static_cast<size_t>(9) * S * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int n_tiles = (N + threads - 1) / threads;
  kernel<<<grid < n_tiles ? grid : n_tiles, threads, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const float*>(blocks),
      static_cast<const float*>(pcol), static_cast<const float*>(prow),
      static_cast<float*>(rows), static_cast<float*>(cols), W, N, S, n_tiles, merge_min);
  return cudaGetLastError();
}

}  // namespace

// The persistent kernel for the specialised pairs (3 x 9).  threads: per
// block, a multiple of 32; grid: blocks to launch at most (fewer when the
// elements make fewer tiles); cols null: rows only.
extern "C" int thallo_fused_pair_persistent(const void* ids, const void* blocks,
                                            const void* pcol, const void* prow, void* rows,
                                            void* cols, int W, int N, int Ci, int Cj, int S,
                                            int threads, int grid, int merge_min,
                                            void* stream) {
  if (Ci != 3 || Cj != 9 || S < 1 || grid < 1 || merge_min < 2 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<size_t>(Cj) * S * sizeof(float) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cols != nullptr ? launch_persistent<true>(ids, blocks, pcol, prow, rows, cols, W, N, S,
                                                threads, grid, merge_min, s)
                      : launch_persistent<false>(ids, blocks, pcol, prow, rows, cols, W, N, S,
                                                 threads, grid, merge_min, s);
  return static_cast<int>(err);
}

extern "C" int thallo_fused_pair_atomics(const void* ids, const void* blocks,
                                         const void* pcol, const void* prow,
                                         void* rows, void* cols, int W, int N,
                                         int Ci, int Cj, int S, void* stream) {
  if (Ci < 1 || Ci > kMaxCi || Cj < 1 || Cj > kMaxCj) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0) {
    const int grid = (N + kThreads - 1) / kThreads;
    fused_pair_atomics_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(blocks),
        static_cast<const float*>(pcol), static_cast<const float*>(prow),
        static_cast<float*>(rows), static_cast<float*>(cols), W, N, Ci, Cj, S);
  }
  return static_cast<int>(cudaGetLastError());
}
