// Fused cross-pair block apply (replaces the Pallas kernel of
// thallo_tpu/ops/fusedpair.py::fused_pair_apply, body `_kernel`).  See
// thallo_tpu_torch/ops/fusedpair.py for the contract.
//
//   rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
//   cols[cj, s] += sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s
//
// Blocks are w-major [W, Ci*Cj, N] with N innermost; entries with an id
// outside [0, S) contribute nothing.  The bound is the block read
// (W*Ci*Cj*N*4 bytes, 2 in bf16); what costs beyond it is the cols side,
// W*N*Cj scattered additions, half of them onto one camera's Cj addresses
// on a degree-skewed scene.  Two kernels:
//
// fused_pair_persistent_kernel<T, Ci, Cj, kElems, kCols>
//     (thallo_fused_pair_persistent: T float; thallo_fused_pair_persistent_bf16:
//     T __nv_bfloat16, the bf16 block storage of the solver's block_dtype)
//   Specialised on the pair's channel counts (3 x 9, the point-camera
//   pair of bundle adjustment), so the Ci*Cj products are unrolled with
//   no guard and a thread keeps ~44 registers: many warps stay resident
//   to cover the shared atomics.  A fixed grid of blocks (a few per SM)
//   strides over tiles of kElems elements per thread, neighbouring threads
//   on neighbouring elements of each block plane.  In f32 kElems is 1:
//   two or four neighbouring elements per thread with 8- or 16-byte loads
//   were measured on the H100, the rows side alone gained up to 20%, the
//   whole kernel lost 30-55% to the registers and the serial merges.  In
//   bf16 one element a lane is a 64-byte warp load; kElems = 2 (an even N
//   only: the planes start 4-byte aligned) reads a __nv_bfloat162, 128
//   bytes a warp (pair_slot, fused_pair_slot.cuh).  Block values widen to
//   f32 on load; every other operand and all arithmetic is f32.  The cols
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
//   Any (Ci, Cj) up to 16 x 16 and any S: one thread per element, rows
//   owned, cols by one global atomic per (w, n, cj).  Instantiated for Ci
//   up to 4, 8 and 16 by Cj up to 4 and 16, so the unrolled products of a
//   small pair carry few predicated-off iterations while a thread still
//   starts all its pcol gathers at once.  Takes the shapes the persistent
//   kernel does not (an accumulator beyond the shared memory, another
//   pair: the graph models' 3 x 3 pairs and the embedded graph's
//   9-channel rotation rows against 3-channel offsets).
//
// f64 (the solver's double_precision): both kernels are templated on the
// value type V of pcol, prow, rows, cols and the shared accumulator.
// thallo_fused_pair_persistent_f64 is the persistent kernel with T = V =
// double (one double a lane; the [9, S] accumulator is 72 KB at S =
// 1024, within kMaxSmem up to S = 1592), thallo_fused_pair_atomics_f64
// the atomics kernel with V = double (atomicAdd on double is native on
// sm_90).  Registers and shared memory double; every sum is an f64 sum.
//
// add_cols (the warp merge) lives in block_accum.cuh, shared with the
// W-loop kernel and oh_aggregate.cu; pair_slot (one slot's loads and
// products) in fused_pair_slot.cuh, shared with the W-loop kernel.  The
// caller zeroes cols; the kernels allocate nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "block_accum.cuh"      // add_cols
#include "fused_pair_slot.cuh"  // pair_slot

namespace {

constexpr int kMaxCj = 16;         // ops/fusedpair.py MAX_CJ
constexpr int kAtomicsMaxCi = 16;  // ops/fusedpair.py ATOMICS_MAX_CI
constexpr int kThreads = 256;      // the atomics kernel's block
constexpr int kMaxThreads = 1024;  // the persistent kernel's largest block
constexpr int kMaxSmem = 112 * 1024;  // ops/fusedpair.py PERSISTENT_MAX_SMEM

template <typename V, int kCiMax, int kCjMax>
__global__ void fused_pair_atomics_kernel(const int* __restrict__ ids,
                                          const V* __restrict__ blocks,
                                          const V* __restrict__ pcol,
                                          const V* __restrict__ prow,
                                          V* __restrict__ rows,
                                          V* __restrict__ cols,
                                          int W, int N, int Ci, int Cj, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t Nz = static_cast<size_t>(N);
  const size_t F = static_cast<size_t>(Ci) * Cj;

  V pr[kCiMax];
  V acc[kCiMax];
#pragma unroll
  for (int ci = 0; ci < kCiMax; ++ci) {
    pr[ci] = ci < Ci ? prow[ci * Nz + n] : V(0);
    acc[ci] = V(0);
  }

  for (int w = 0; w < W; ++w) {
    const int id = ids[static_cast<size_t>(w) * Nz + n];
    if (id < 0 || id >= S) continue;  // padded / out-of-range: dropped
    const V* b = blocks + static_cast<size_t>(w) * F * Nz + n;
    V pc[kCjMax];
    V z[kCjMax];
#pragma unroll
    for (int cj = 0; cj < kCjMax; ++cj) {
      pc[cj] = cj < Cj ? __ldg(pcol + static_cast<size_t>(cj) * S + id) : V(0);
      z[cj] = V(0);
    }
#pragma unroll
    for (int ci = 0; ci < kCiMax; ++ci) {
      if (ci < Ci) {
#pragma unroll
        for (int cj = 0; cj < kCjMax; ++cj) {
          if (cj < Cj) {
            const V bv = __ldg(b + static_cast<size_t>(ci * Cj + cj) * Nz);
            acc[ci] = fma_v(bv, pc[cj], acc[ci]);
            z[cj] = fma_v(bv, pr[ci], z[cj]);
          }
        }
      }
    }
#pragma unroll
    for (int cj = 0; cj < kCjMax; ++cj) {
      if (cj < Cj) atomicAdd(cols + static_cast<size_t>(cj) * S + id, z[cj]);
    }
  }

#pragma unroll
  for (int ci = 0; ci < kCiMax; ++ci) {
    if (ci < Ci) rows[ci * Nz + n] = acc[ci];
  }
}

template <typename V>
using AtomicsKernel = void (*)(const int*, const V*, const V*, const V*, V*, V*, int, int, int,
                               int, int);

// the instantiation for Ci <= kCiMax and this Cj
template <typename V, int kCiMax>
AtomicsKernel<V> atomics_kernel_for(int Cj) {
  return Cj <= 4 ? fused_pair_atomics_kernel<V, kCiMax, 4>
                 : fused_pair_atomics_kernel<V, kCiMax, kMaxCj>;
}

template <typename V>
cudaError_t launch_atomics(const void* ids, const void* blocks, const void* pcol,
                           const void* prow, void* rows, void* cols, int W, int N, int Ci,
                           int Cj, int S, void* stream) {
  if (Ci < 1 || Ci > kAtomicsMaxCi || Cj < 1 || Cj > kMaxCj) return cudaErrorInvalidValue;
  if (N > 0) {
    const int grid = (N + kThreads - 1) / kThreads;
    const AtomicsKernel<V> kernel = Ci <= 4   ? atomics_kernel_for<V, 4>(Cj)
                                    : Ci <= 8 ? atomics_kernel_for<V, 8>(Cj)
                                              : atomics_kernel_for<V, kAtomicsMaxCi>(Cj);
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const V*>(blocks),
        static_cast<const V*>(pcol), static_cast<const V*>(prow), static_cast<V*>(rows),
        static_cast<V*>(cols), W, N, Ci, Cj, S);
  }
  return cudaGetLastError();
}

template <typename T, typename V, int kCi, int kCj, int kElems, bool kCols>
__global__ void __launch_bounds__(kMaxThreads / kElems)
    fused_pair_persistent_kernel(const int* __restrict__ ids, const T* __restrict__ blocks,
                                 const V* __restrict__ pcol, const V* __restrict__ prow,
                                 V* __restrict__ rows, V* __restrict__ cols, int W, int N, int S,
                                 int n_tiles, int merge_min) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* acc_cols = reinterpret_cast<V*>(smem_raw);  // [kCj, S]
  const int n_acc = kCj * S;
  if (kCols) {
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_cols[i] = V(0);
    __syncthreads();
  }
  const size_t Nz = static_cast<size_t>(N);
  const int lane = threadIdx.x & 31;

  // the trip counts of both loops are the same for every lane of a warp,
  // so all 32 lanes reach add_cols's warp primitives together
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile * blockDim.x + threadIdx.x) * kElems;
    const bool live = n0 < N;  // kElems = 2 only for an even N: both or neither
    V pr[kElems][kCi];
    V acc[kElems][kCi];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
        pr[e][ci] = live ? __ldg(prow + ci * Nz + n0 + e) : V(0);
        acc[e][ci] = V(0);
      }
    }
    for (int w = 0; w < W; ++w) {
      V z[kElems][kCj];
      int id[kElems];
      bool ok[kElems];
      pair_slot<T, kCi, kCj, kElems, kCols>(ids, blocks, pcol, S, Nz, w, n0, live, pr, acc, z,
                                            id, ok);
      if (kCols) {
#pragma unroll
        for (int e = 0; e < kElems; ++e) add_cols<kCj>(acc_cols, S, id[e], ok[e], z[e], lane,
                                                       merge_min);
      }
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
#pragma unroll
        for (int ci = 0; ci < kCi; ++ci) rows[ci * Nz + n0 + e] = acc[e][ci];
      }
    }
  }

  if (kCols) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
      const V v = acc_cols[i];
      if (v != V(0)) atomicAdd(cols + i, v);
    }
  }
}

template <typename T, typename V, int kElems, bool kCols>
cudaError_t launch_persistent(const void* ids, const void* blocks, const void* pcol,
                              const void* prow, void* rows, void* cols, int W, int N, int S,
                              int threads, int grid, int merge_min, cudaStream_t stream) {
  auto kernel = fused_pair_persistent_kernel<T, V, 3, 9, kElems, kCols>;
  const size_t smem = kCols ? static_cast<size_t>(9) * S * sizeof(V) : 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int per_tile = threads * kElems;
  const int n_tiles = (N + per_tile - 1) / per_tile;
  kernel<<<grid < n_tiles ? grid : n_tiles, threads, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(blocks), static_cast<const V*>(pcol),
      static_cast<const V*>(prow), static_cast<V*>(rows), static_cast<V*>(cols), W, N, S,
      n_tiles, merge_min);
  return cudaGetLastError();
}

bool persistent_args_ok(int Ci, int Cj, int S, int threads, int grid, int merge_min,
                        int max_threads, size_t value_bytes) {
  return Ci == 3 && Cj == 9 && S >= 1 && grid >= 1 && merge_min >= 2 && threads >= 32 &&
         threads <= max_threads && threads % 32 == 0 &&
         static_cast<size_t>(Cj) * S * value_bytes <= kMaxSmem;
}

}  // namespace

// The persistent kernel for the specialised pairs (3 x 9), f32 blocks.
// threads: per block, a multiple of 32; grid: blocks to launch at most
// (fewer when the elements make fewer tiles); cols null: rows only.
extern "C" int thallo_fused_pair_persistent(const void* ids, const void* blocks,
                                            const void* pcol, const void* prow, void* rows,
                                            void* cols, int W, int N, int Ci, int Cj, int S,
                                            int threads, int grid, int merge_min,
                                            void* stream) {
  if (!persistent_args_ok(Ci, Cj, S, threads, grid, merge_min, kMaxThreads, sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cols != nullptr
          ? launch_persistent<float, float, 1, true>(ids, blocks, pcol, prow, rows, cols, W, N,
                                                     S, threads, grid, merge_min, s)
          : launch_persistent<float, float, 1, false>(ids, blocks, pcol, prow, rows, cols, W,
                                                      N, S, threads, grid, merge_min, s);
  return static_cast<int>(err);
}

// The persistent kernel in f64: blocks, pcol, prow, rows and cols double
// (one element a thread); cols null: rows only.
extern "C" int thallo_fused_pair_persistent_f64(const void* ids, const void* blocks,
                                                const void* pcol, const void* prow, void* rows,
                                                void* cols, int W, int N, int Ci, int Cj, int S,
                                                int threads, int grid, int merge_min,
                                                void* stream) {
  if (!persistent_args_ok(Ci, Cj, S, threads, grid, merge_min, kMaxThreads, sizeof(double))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cols != nullptr
          ? launch_persistent<double, double, 1, true>(ids, blocks, pcol, prow, rows, cols, W,
                                                       N, S, threads, grid, merge_min, s)
          : launch_persistent<double, double, 1, false>(ids, blocks, pcol, prow, rows, cols, W,
                                                        N, S, threads, grid, merge_min, s);
  return static_cast<int>(err);
}

// The same for bf16 blocks: elems (1, or 2 for an even N) neighbouring
// elements per thread, read as one bf16 or one __nv_bfloat162 per block
// row; at most kMaxThreads / elems threads.
extern "C" int thallo_fused_pair_persistent_bf16(const void* ids, const void* blocks,
                                                 const void* pcol, const void* prow, void* rows,
                                                 void* cols, int W, int N, int Ci, int Cj,
                                                 int S, int threads, int grid, int merge_min,
                                                 int elems, void* stream) {
  if ((elems != 1 && elems != 2) || (elems == 2 && N % 2 != 0) ||
      !persistent_args_ok(Ci, Cj, S, threads, grid, merge_min, kMaxThreads / elems,
                          sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const bool c = cols != nullptr;
  using bf16 = __nv_bfloat16;
  const cudaError_t err =
      elems == 2
          ? (c ? launch_persistent<bf16, float, 2, true> : launch_persistent<bf16, float, 2, false>)(
                ids, blocks, pcol, prow, rows, cols, W, N, S, threads, grid, merge_min, s)
          : (c ? launch_persistent<bf16, float, 1, true> : launch_persistent<bf16, float, 1, false>)(
                ids, blocks, pcol, prow, rows, cols, W, N, S, threads, grid, merge_min, s);
  return static_cast<int>(err);
}

extern "C" int thallo_fused_pair_atomics(const void* ids, const void* blocks,
                                         const void* pcol, const void* prow,
                                         void* rows, void* cols, int W, int N,
                                         int Ci, int Cj, int S, void* stream) {
  return static_cast<int>(
      launch_atomics<float>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S, stream));
}

// The atomics kernel in f64: every operand but ids double.
extern "C" int thallo_fused_pair_atomics_f64(const void* ids, const void* blocks,
                                             const void* pcol, const void* prow, void* rows,
                                             void* cols, int W, int N, int Ci, int Cj, int S,
                                             void* stream) {
  return static_cast<int>(
      launch_atomics<double>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S, stream));
}
