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
// read, W*Ci*Cj*N*4 bytes.  Three kernels:
//
// wloop_persistent_kernel<T, V>  (thallo_fused_pair_wloop_persistent: T =
//     V = float; thallo_fused_pair_wloop_persistent_bf16: T __nv_bfloat16,
//     V float; _f64: T = V = double; _bf16_f64: T __nv_bfloat16, V double)
//   Specialised on 3 x 9.  The work is cut into items of (32-element
//   tile, range of w_item w's); a warp takes one item at a time, lane =
//   element, so each load of a w-plane is 32 neighbouring values (128 bytes
//   in f32, 64 in bf16), read once with __ldcs past the caches that hold
//   pcol and ids (pair_slot, fused_pair_slot.cuh, as in fused_pair.cu);
//   arithmetic is at the value type V (f32; f64 under double_precision,
//   where the [9, S] accumulator doubles to 72 KB at S = 1024 and a block
//   takes at most 512 threads).  (Two bf16 elements a lane, as the bf16 persistent
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
// wloop_lanes_kernel<T, V>  (thallo_fused_pair_wloop_lanes_bf16_f64: T
//     __nv_bfloat16, V double; the route of every wide bf16-f64 level
//     whose f64 accumulator fits, ops/fusedpair.py fused_pair_route)
//   The persistent kernel's sums, redesigned for f64 values at phase
//   28(a)'s level (W 10, N 100 000, S 1024; bound 0.0188 ms: the 54 MB of
//   bf16 blocks and 8 MB of the rest at 3.35 TB/s).  What held the <bf16,
//   double> persistent kernel at 0.094 ms, by probes on the H100
//   (scripts/torch_redesign_sweep.py --only wloop_f64): not the block
//   reads nor the pcol gathers (pcol staged in shared memory: no gain;
//   never gathered: -4 us) but the cols side, 9 M f64 additions into
//   shared memory, each a compare-and-swap loop (ATOMS.CAST.SPIN.64) at
//   about one lane a clock per SM: ~35 us that no layout removes; the
//   kernel without its cols side takes 0.033 ms.  So the design trims the
//   rest: an item is `elems` (16) elements x all W w's, its 32 lanes
//   (h, e) taking w-lane h of element e (w = w0 + h, w0 + h + 32 / elems,
//   ...), so 6 250 items fill 2 112 warps evenly (3 each, 5 steps) and
//   every item stores its rows after a shuffle over its w-lanes (no row
//   atomics, no memset); one 512-thread block an SM with up to 128
//   registers, so the block loads of a step are all in flight together;
//   pcol stays in the read-only cache; the flush as above, 132 blocks.
//   Measured against it and not kept: the staged pcol above, the flush
//   summed over a 2-block cluster through distributed shared memory first
//   (-2%), a share of the channels added by global reductions (slower),
//   and a cols side without atomics (each round's z vectors staged and
//   added by the warp that owns their ids: slower, two block barriers a
//   round).  Its plan: ops/fusedpair.py wloop_lanes_plan.
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

// the largest block of the persistent kernel at value type V: 1024 threads
// in f32, 512 in f64 (its doubles take twice the registers)
template <typename V>
constexpr int wloop_max_threads() {
  return kMaxThreads / static_cast<int>(sizeof(V) / sizeof(float));
}

template <typename T, typename V>
__global__ void __launch_bounds__(kMaxThreads * sizeof(float) / sizeof(V))
    wloop_persistent_kernel(const int* __restrict__ ids, const T* __restrict__ blocks,
                            const V* __restrict__ pcol, const V* __restrict__ prow,
                            V* __restrict__ rows, V* __restrict__ cols, int W, int N, int S,
                            int w_item, int n_items, int merge_min) {
  constexpr int kCi = 3, kCj = 9;
  extern __shared__ __align__(16) unsigned char wloop_smem[];
  V* acc_cols = reinterpret_cast<V*>(wloop_smem);  // [kCj, S]
  const int n_acc = kCj * S;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_cols[i] = V(0);
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
    V pr[1][kCi];
    V acc[1][kCi];
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
      pr[0][ci] = live ? __ldg(prow + ci * Nz + n) : V(0);
      acc[0][ci] = V(0);
    }
    for (int w = w0; w < w1; ++w) {
      V z[1][kCj];
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
    const V v = acc_cols[i];
    if (v != V(0)) atomicAdd(cols + i, v);
  }
}

template <typename T, typename V>
cudaError_t launch_wloop_persistent(const void* ids, const void* blocks, const void* pcol,
                                    const void* prow, void* rows, void* cols, int W, int N,
                                    int S, int threads, int grid, int w_item, int merge_min,
                                    cudaStream_t stream) {
  auto kernel = wloop_persistent_kernel<T, V>;
  const size_t smem = static_cast<size_t>(9) * S * sizeof(V);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_items = ((N + 31) / 32) * ((W + w_item - 1) / w_item);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(blocks), static_cast<const V*>(pcol),
      static_cast<const V*>(prow), static_cast<V*>(rows), static_cast<V*>(cols), W, N, S, w_item,
      n_items, merge_min);
  return cudaGetLastError();
}

template <typename V>
bool wloop_persistent_args_ok(int W, int N, int Ci, int Cj, int S, int threads, int grid,
                              int w_item, int merge_min) {
  return Ci == 3 && Cj == 9 && S >= 1 && W >= 0 && N >= 0 && grid >= 1 && w_item >= 1 &&
         merge_min >= 2 && threads >= 32 && threads <= wloop_max_threads<V>() &&
         threads % 32 == 0 && static_cast<size_t>(Cj) * S * sizeof(V) <= kMaxPersistentSmem;
}

template <typename T, typename V>
int wloop_persistent(const void* ids, const void* blocks, const void* pcol, const void* prow,
                     void* rows, void* cols, int W, int N, int Ci, int Cj, int S, int threads,
                     int grid, int w_item, int merge_min, void* stream) {
  if (!wloop_persistent_args_ok<V>(W, N, Ci, Cj, S, threads, grid, w_item, merge_min)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_wloop_persistent<T, V>(
      ids, blocks, pcol, prow, rows, cols, W, N, S, threads, grid, w_item, merge_min,
      static_cast<cudaStream_t>(stream)));
}


// The w-lane kernel (wloop_lanes_kernel; see the note at the top).
// kCols = false compiles the cols side out: scripts/torch_redesign_sweep.py
// builds that instantiation on its own to time the rows alone.
constexpr int kLanesThreads = 512;  // ops/fusedpair.py WLOOP_LANES_THREADS

template <typename T, typename V, bool kCols>
__global__ void __launch_bounds__(kLanesThreads, 1)
    wloop_lanes_kernel(const int* __restrict__ ids, const T* __restrict__ blocks,
                       const V* __restrict__ pcol, const V* __restrict__ prow,
                       V* __restrict__ rows, V* __restrict__ cols, int W, int N, int S,
                       int elems, int w_item, int n_items, int merge_min) {
  constexpr int kCi = 3, kCj = 9;
  extern __shared__ __align__(16) unsigned char wloop_smem[];
  V* acc_cols = reinterpret_cast<V*>(wloop_smem);  // [kCj, S]
  const int n_acc = kCj * S;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_cols[i] = V(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  // lane = (h, e): element e of the item's `elems`, w-lane h of 32 / elems
  const int e = lane & (elems - 1);
  const int h = lane / elems;
  const int w_lanes = 32 / elems;
  const int w_chunks = (W + w_item - 1) / w_item;
  const size_t Nz = static_cast<size_t>(N);

  // item, w0, w1 and the step count are the same for every lane of a
  // warp, so all 32 lanes reach the warp primitives together
  for (int item = blockIdx.x * warps + (threadIdx.x >> 5); item < n_items;
       item += gridDim.x * warps) {
    const int tile = item / w_chunks;
    const int w0 = (item - tile * w_chunks) * w_item;
    const int w1 = min(W, w0 + w_item);
    const int n = tile * elems + e;
    const bool live = n < N;
    V pr[1][kCi];
    V acc[1][kCi];
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
      pr[0][ci] = live ? __ldg(prow + ci * Nz + n) : V(0);
      acc[0][ci] = V(0);
    }
    const int steps = (w1 - w0 + w_lanes - 1) / w_lanes;
    for (int k = 0; k < steps; ++k) {
      const int w = w0 + k * w_lanes + h;
      V z[1][kCj];
      int id[1];
      bool ok[1];
      pair_slot<T, kCi, kCj, 1, kCols>(ids, blocks, pcol, S, Nz, w, n, live && w < w1, pr, acc,
                                       z, id, ok);
      if (kCols) add_cols<kCj>(acc_cols, S, id[0], ok[0], z[0], lane, merge_min);
    }
    // the element's rows: its w-lanes' sums, by shuffles in a fixed order
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
      for (int off = elems; off < 32; off <<= 1) {
        acc[0][ci] += __shfl_xor_sync(kFull, acc[0][ci], off);
      }
    }
    if (live && h == 0) {
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

  // the flush: one global atomic per nonzero accumulator entry
  __syncthreads();
  for (int i = threadIdx.x; i < n_acc && kCols; i += blockDim.x) {
    const V v = acc_cols[i];
    if (v != V(0)) atomicAdd(cols + i, v);
  }
}

template <typename T, typename V, bool kCols>
cudaError_t launch_wloop_lanes(const void* ids, const void* blocks, const void* pcol,
                               const void* prow, void* rows, void* cols, int W, int N, int S,
                               int grid, int elems, int w_item, int merge_min,
                               cudaStream_t stream) {
  auto kernel = wloop_lanes_kernel<T, V, kCols>;
  const size_t smem = static_cast<size_t>(9) * S * sizeof(V);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_items = ((N + elems - 1) / elems) * ((W + w_item - 1) / w_item);
  if (n_items == 0) return cudaGetLastError();  // nothing to add: cols stay zero
  kernel<<<grid, kLanesThreads, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(blocks), static_cast<const V*>(pcol),
      static_cast<const V*>(prow), static_cast<V*>(rows), static_cast<V*>(cols), W, N, S, elems,
      w_item, n_items, merge_min);
  return cudaGetLastError();
}

template <typename T, typename V>
int wloop_lanes(const void* ids, const void* blocks, const void* pcol, const void* prow,
                void* rows, void* cols, int W, int N, int Ci, int Cj, int S, int grid,
                int elems, int w_item, int merge_min, void* stream) {
  if (Ci != 3 || Cj != 9 || S < 1 || W < 0 || N < 0 || grid < 1 || w_item < 1 ||
      merge_min < 2 || (elems != 16 && elems != 32) ||
      static_cast<size_t>(9) * S * sizeof(V) > kMaxPersistentSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_wloop_lanes<T, V, true>(ids, blocks, pcol, prow, rows, cols, W,
                                                         N, S, grid, elems, w_item, merge_min,
                                                         static_cast<cudaStream_t>(stream)));
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
  return wloop_persistent<float, float>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S,
                                        threads, grid, w_item, merge_min, stream);
}

// The same for bf16 blocks.
extern "C" int thallo_fused_pair_wloop_persistent_bf16(const void* ids, const void* blocks,
                                                       const void* pcol, const void* prow,
                                                       void* rows, void* cols, int W, int N,
                                                       int Ci, int Cj, int S, int threads,
                                                       int grid, int w_item, int merge_min,
                                                       void* stream) {
  return wloop_persistent<__nv_bfloat16, float>(ids, blocks, pcol, prow, rows, cols, W, N, Ci,
                                                Cj, S, threads, grid, w_item, merge_min, stream);
}

// In f64: blocks, pcol, prow, rows and cols double (threads at most 512;
// the [9, S] f64 accumulator, 72 KB at S = 1024, in opted-in dynamic
// shared memory).
extern "C" int thallo_fused_pair_wloop_persistent_f64(const void* ids, const void* blocks,
                                                      const void* pcol, const void* prow,
                                                      void* rows, void* cols, int W, int N,
                                                      int Ci, int Cj, int S, int threads,
                                                      int grid, int w_item, int merge_min,
                                                      void* stream) {
  return wloop_persistent<double, double>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S,
                                          threads, grid, w_item, merge_min, stream);
}

// bf16 blocks with f64 values (pcol, prow, rows and cols double).
extern "C" int thallo_fused_pair_wloop_persistent_bf16_f64(const void* ids, const void* blocks,
                                                           const void* pcol, const void* prow,
                                                           void* rows, void* cols, int W, int N,
                                                           int Ci, int Cj, int S, int threads,
                                                           int grid, int w_item, int merge_min,
                                                           void* stream) {
  return wloop_persistent<__nv_bfloat16, double>(ids, blocks, pcol, prow, rows, cols, W, N, Ci,
                                                 Cj, S, threads, grid, w_item, merge_min,
                                                 stream);
}

// The w-lane kernel for 3 x 9, bf16 blocks with f64 values (pcol, prow,
// rows and cols double), 512 threads a block.  elems: 16 or 32 elements
// an item (32 / elems w-lanes an element); w_item: w's an item (>= W:
// rows stored, else added to rows, zeroed by the caller); cols zeroed by
// the caller.
extern "C" int thallo_fused_pair_wloop_lanes_bf16_f64(const void* ids, const void* blocks,
                                                      const void* pcol, const void* prow,
                                                      void* rows, void* cols, int W, int N,
                                                      int Ci, int Cj, int S, int grid,
                                                      int elems, int w_item, int merge_min,
                                                      void* stream) {
  return wloop_lanes<__nv_bfloat16, double>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj,
                                            S, grid, elems, w_item, merge_min, stream);
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
