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
// would run 11 warps, each looping 716 times.  The bound is the block
// read, W*Ci*Cj*N*4 bytes.  Two kernels:
//
// wloop_persistent_kernel<T>  (thallo_fused_pair_wloop_persistent: T
//     float; thallo_fused_pair_wloop_persistent_bf16: T __nv_bfloat16)
//   Specialised on 3 x 9.  The work is cut into items of (32-element
//   tile, range of w_item w's); a warp takes one item at a time, lane =
//   element, so each load of a w-plane is 32 neighbouring values (128 bytes
//   in f32, 64 in bf16), read once with __ldcs past the caches that hold
//   pcol and ids (pair_slot, fused_pair_slot.cuh, as in fused_pair.cu);
//   arithmetic is f32.  (Two bf16 elements a lane, as the bf16 persistent
//   kernel reads them, halve the items: 8% slower at (96, 2054), the one
//   even wide level of the skewed 1M scene, H100.)  A fixed grid
//   (a few blocks per SM) strides over the items, so a block zeroes and
//   flushes its [9, S] shared cols accumulator once, not once per tile.
//   Before the shared atomics a warp merges equal ids (add_cols,
//   block_accum.cuh): the hot camera, carried by about half the lanes on
//   the skewed scene, costs one shared addition per channel.  Rows: an
//   item that covers all W of its elements stores them; where w is split
//   it adds its 3 partial sums per element with global atomics (the
//   caller zeroes rows then).  The flush adds each nonzero accumulator
//   entry to cols with a global atomic: on the H100 it beat per-block
//   slabs [G, 9, S] summed by a second kernel at all five levels of the
//   skewed 1M scene.
//
// fused_pair_wloop_kernel  (thallo_fused_pair_wloop, the first body)
//   Any (Ci, Cj) up to 8 x 16, S up to kMaxSmem / 4: the grid is
//   (32-element tile, w-chunk, cj-chunk).  The 8 warps of a block take
//   the w of its chunk in turn; rows meet in shared memory and are added
//   with one global atomic per (ci, element); cols go to a shared
//   [cj-chunk, S] accumulator (chunks of as many channels as fit
//   kMaxSmem, each re-reading the ids and its own block rows), zeroed and
//   flushed once per block with one global atomic per nonzero entry.  It
//   takes the shapes the persistent kernel does not: other pairs, and
//   [9, S] accumulators beyond kMaxPersistentSmem.
//
// The caller zeroes what the kernels add to; they allocate nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "block_accum.cuh"      // add_cols
#include "fused_pair_slot.cuh"  // pair_slot

namespace {

constexpr int kMaxCi = 8;    // ops/fusedpair.py MAX_CI
constexpr int kMaxCj = 16;   // ops/fusedpair.py MAX_CJ
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 96 * 1024;  // ops/_cuda.py MAX_DYNAMIC_SMEM
constexpr int kMaxPersistentSmem = 112 * 1024;  // ops/fusedpair.py PERSISTENT_MAX_SMEM
constexpr int kMaxThreads = 1024;

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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    wloop_persistent_kernel(const int* __restrict__ ids, const T* __restrict__ blocks,
                            const float* __restrict__ pcol, const float* __restrict__ prow,
                            float* __restrict__ rows, float* __restrict__ cols, int W, int N,
                            int S, int w_item, int n_items, int merge_min) {
  constexpr int kCi = 3, kCj = 9;
  extern __shared__ float acc_cols[];  // [kCj, S]
  const int n_acc = kCj * S;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_cols[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int w_chunks = (W + w_item - 1) / w_item;
  const size_t Nz = static_cast<size_t>(N);

  // item, w0 and w1 are the same for every lane of a warp, so all 32
  // lanes reach add_cols's warp primitives together
  for (int item = blockIdx.x * warps + (threadIdx.x >> 5); item < n_items;
       item += gridDim.x * warps) {
    const int tile = item / w_chunks;
    const int w0 = (item - tile * w_chunks) * w_item;
    const int w1 = min(W, w0 + w_item);
    const int n = tile * 32 + lane;
    const bool live = n < N;
    // pair_slot's one-element form: the lane's element is entry [0]
    float pr[1][kCi];
    float acc[1][kCi];
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
      pr[0][ci] = live ? __ldg(prow + ci * Nz + n) : 0.f;
      acc[0][ci] = 0.f;
    }
    for (int w = w0; w < w1; ++w) {
      float z[1][kCj];
      int id[1];
      bool ok[1];
      pair_slot<T, kCi, kCj, 1, true>(ids, blocks, pcol, S, Nz, w, n, live, pr, acc, z, id, ok);
      add_cols<kCj>(acc_cols, S, id[0], ok[0], z[0], lane, merge_min);
    }
    if (live) {
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
        if (w_item >= W) {
          rows[ci * Nz + n] = acc[0][ci];
        } else {
          atomicAdd(rows + ci * Nz + n, acc[0][ci]);
        }
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const float v = acc_cols[i];
    if (v != 0.f) atomicAdd(cols + i, v);
  }
}

template <typename T>
cudaError_t launch_wloop_persistent(const void* ids, const void* blocks, const void* pcol,
                                    const void* prow, void* rows, void* cols, int W, int N,
                                    int S, int threads, int grid, int w_item, int merge_min,
                                    cudaStream_t stream) {
  auto kernel = wloop_persistent_kernel<T>;
  const size_t smem = static_cast<size_t>(9) * S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int n_items = ((N + 31) / 32) * ((W + w_item - 1) / w_item);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(blocks),
      static_cast<const float*>(pcol), static_cast<const float*>(prow),
      static_cast<float*>(rows), static_cast<float*>(cols), W, N, S, w_item, n_items, merge_min);
  return cudaGetLastError();
}

bool wloop_persistent_args_ok(int W, int N, int Ci, int Cj, int S, int threads, int grid,
                              int w_item, int merge_min, int max_threads) {
  return Ci == 3 && Cj == 9 && S >= 1 && W >= 0 && N >= 0 && grid >= 1 && w_item >= 1 &&
         merge_min >= 2 && threads >= 32 && threads <= max_threads && threads % 32 == 0 &&
         static_cast<size_t>(Cj) * S * sizeof(float) <= kMaxPersistentSmem;
}

}  // namespace

// The persistent W-loop kernel for 3 x 9, f32 blocks.  threads: per
// block, a multiple of 32; grid: the blocks to launch; w_item: w's per work
// item (>= W: rows are stored, else added to rows, zeroed by the caller);
// cols zeroed by the caller.
extern "C" int thallo_fused_pair_wloop_persistent(const void* ids, const void* blocks,
                                                  const void* pcol, const void* prow, void* rows,
                                                  void* cols, int W, int N, int Ci, int Cj, int S,
                                                  int threads, int grid, int w_item,
                                                  int merge_min, void* stream) {
  if (!wloop_persistent_args_ok(W, N, Ci, Cj, S, threads, grid, w_item, merge_min,
                                kMaxThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_wloop_persistent<float>(
      ids, blocks, pcol, prow, rows, cols, W, N, S, threads, grid, w_item, merge_min,
      static_cast<cudaStream_t>(stream)));
}

// The same for bf16 blocks.
extern "C" int thallo_fused_pair_wloop_persistent_bf16(const void* ids, const void* blocks,
                                                       const void* pcol, const void* prow,
                                                       void* rows, void* cols, int W, int N,
                                                       int Ci, int Cj, int S, int threads,
                                                       int grid, int w_item, int merge_min,
                                                       void* stream) {
  if (!wloop_persistent_args_ok(W, N, Ci, Cj, S, threads, grid, w_item, merge_min,
                                kMaxThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_wloop_persistent<__nv_bfloat16>(
      ids, blocks, pcol, prow, rows, cols, W, N, S, threads, grid, w_item, merge_min,
      static_cast<cudaStream_t>(stream)));
}

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
