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
// fused_pair_slots_kernel  (thallo_fused_pair_atomics_slots, the redesign
//     of the atomics kernel above for this card; _f64 the same template)
//   Bound by bytes, like the atomics kernel, which walks an element's W
//   slots one after another: id, then the pcol gather that needs it, then
//   the blocks, then Cj atomics, so W load chains run back to back and no
//   load of slot w + 1 starts before slot w's atomics (0.36 of the bound
//   at ARAP 256²'s 3 x 3 levels, W 4, N 65 536).  Here a thread starts
//   every load of its slots before any sum: the ids of kSlotIds slots,
//   then, for the exact 3 x 3 pair, all their blocks (kSlotAhead values),
//   then the pcol gathers, so one element's ~50 loads are in flight at
//   once.  On a level of fewer than kSlotSpreadMaxN elements one thread
//   per element leaves the card nearly empty (bundle_fusion's 700), so
//   there the W slots are spread over P slot lanes (P the largest power
//   of two <= min(W, 8)): a block of kSlotThreads covers kSlotThreads / P
//   elements, each warp 32 neighbouring elements at one slot lane (a
//   warp's loads of a block plane stay 128-byte rows), and lane 0 adds
//   the other lanes' rows from shared memory in lane order (a fixed
//   order).  On long levels spreading measured slower (the lane
//   bookkeeping, the shared rows and every lane's prow reads cost more
//   than the extra warps gave), so P is 1 there.  Cols: one global atomic
//   per (slot, element, cj), as before; in ARAP's grouped edge order a
//   warp's 32 ids are neighbouring vertices, so its atomics land on one
//   or two 128-byte lines, and a warp of ARAP holds no equal ids for a
//   merge to save.  Instantiated exactly for (3, 3) (P = 1 and P > 1) and
//   for (Ci, Cj) up to (4, 4), (16, 4) and (16, 16): the other levels
//   keep the first body unless they are short (fusedpair.py
//   atomics_keeps_thread), so fewer instantiations than the first body's
//   keep the build short.
//
// thallo_fused_pair_atomics_slots_bf16: the same kernel on bf16 block
//   storage (the solver's block_dtype="bf16"), T = __nv_bfloat16 beside
//   the value type V = float, as the persistent kernel has it: each block
//   value widens to f32 on load (load_block, fused_pair_slot.cuh), every
//   other operand and all arithmetic f32; the same order of loads (ids,
//   then blocks, then pcol, before any sum).  It replaces the first bf16
//   body (fused_pair_variants.cu mode 0, one thread walking its W slots)
//   on the bf16 levels the persistent kernels do not take.  Its blocks
//   are half the bytes, so one thread per element fills the card even
//   less: the caller passes the slot lanes P (fusedpair.py
//   bf16_slot_lanes: spread while the level's threads stay below a share
//   of the SMs' resident threads).  The 9 x 3 and 16 x 3 pairs (a
//   9-channel rotation row against 3-channel offsets, and BF16_WIDE's
//   bound) are instantiated exactly, their blocks loaded ahead like the
//   3 x 3 pair's (2 and 1 slots of them): the guarded (16, 4) instantiation
//   took 2-4x as long on the H100 (PERF.md).
//
// f64 (the solver's double_precision): both kernels are templated on the
// value type V of pcol, prow, rows, cols and the shared accumulator.
// thallo_fused_pair_persistent_f64 is the persistent kernel with T = V =
// double (one double a lane; the [9, S] accumulator is 72 KB at S =
// 1024, within kMaxSmem up to S = 1592), thallo_fused_pair_atomics_f64
// and thallo_fused_pair_atomics_slots_f64 the two atomics kernels with V
// = double (atomicAdd on double is native on sm_90).  Registers and
// shared memory double; every sum is an f64 sum.
//
// add_cols (the warp merge) lives in block_accum.cuh, shared with the
// W-loop kernel and oh_aggregate.cu; pair_slot (one slot's loads and
// products) in fused_pair_slot.cuh, shared with the W-loop kernel.  The
// caller zeroes cols; the kernels allocate nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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

constexpr int kSlotThreads = 256;    // the slots kernel's block
constexpr int kSlotIds = 4;          // slots whose ids and pcol a thread loads at once (Cj <= 4)
constexpr int kSlotAhead = 64;       // block values a thread loads ahead (kSlotIds slots of 3 x 3,
                                     // one of 16 x 3)
constexpr int kSlotSpreadMaxN = 4096;  // levels of fewer elements spread their slots over lanes

// Slot lane p of kSlotThreads / P elements: slots p, p + P, ... of element
// n.  kExact: Ci == kCi and Cj == kCj (no guards); else Ci <= kCi, Cj <=
// kCj.  Where the kIds slots' blocks fit kSlotAhead registers they are all
// loaded before the pcol gathers, so no load waits for another.  kSpread
// false: P is 1, and the lane bookkeeping and the shared rows compile out
// (with them the exact 3 x 3 pair took 80 registers a thread).
// one block value at its storage type T, widened to the value type V
template <typename V, typename T>
__device__ __forceinline__ V block_value(const T* p) {
  V v[1];
  load_block(p, v);
  return v[0];
}

template <typename T, typename V, int kCi, int kCj, bool kExact, bool kSpread>
__global__ void __launch_bounds__(kSlotThreads)
    fused_pair_slots_kernel(const int* __restrict__ ids, const T* __restrict__ blocks,
                            const V* __restrict__ pcol, const V* __restrict__ prow,
                            V* __restrict__ rows, V* __restrict__ cols, int W, int N, int Ci,
                            int Cj, int S, int P_arg) {
  const int P = kSpread ? P_arg : 1;
  constexpr int kF = kCi * kCj;
  // a wide pcol vector: one slot at a time; an exact pair: as many slots
  // as kSlotAhead block values hold (4 of 3 x 3, 2 of 9 x 3, 1 of 16 x 3)
  constexpr int kFit = kSlotAhead / kF < 1 ? 1 : kSlotAhead / kF;
  constexpr int kIds = kCj > 4 ? 1 : kExact ? (kFit < kSlotIds ? kFit : kSlotIds) : kSlotIds;
  constexpr bool kAhead = kExact && kF * kIds <= kSlotAhead;
  // [P - 1][kCi][E]: the rows of lanes 1.. of each element, dynamic and
  // none where P is 1 (shared memory taken from L1, which holds pcol)
  extern __shared__ __align__(16) unsigned char slot_smem[];
  V* lane_rows = reinterpret_cast<V*>(slot_smem);
  const int ci_n = kExact ? kCi : Ci;
  const int cj_n = kExact ? kCj : Cj;
  const int E = kSlotThreads / P;
  const int lane = threadIdx.x & 31;
  const int warps_per_lane = E >> 5;
  const int warp = threadIdx.x >> 5;
  const int p = kSpread ? warp / warps_per_lane : 0;  // warp-uniform
  const int e = kSpread ? (warp - p * warps_per_lane) * 32 + lane : threadIdx.x;
  const int n = blockIdx.x * E + e;
  const bool live = n < N;
  const size_t Nz = static_cast<size_t>(N);
  const size_t F = static_cast<size_t>(ci_n) * cj_n;

  V pr[kCi];
  V acc[kCi];
#pragma unroll
  for (int ci = 0; ci < kCi; ++ci) {
    pr[ci] = live && ci < ci_n ? __ldg(prow + ci * Nz + n) : V(0);
    acc[ci] = V(0);
  }
  for (int w0 = p; w0 < W; w0 += kIds * P) {
    int id[kIds];
    bool ok[kIds];
#pragma unroll
    for (int j = 0; j < kIds; ++j) {
      const int w = w0 + j * P;
      id[j] = live && w < W ? __ldg(ids + static_cast<size_t>(w) * Nz + n) : -1;
    }
    V ahead[kAhead ? kIds : 1][kAhead ? kF : 1];
    if (kAhead) {
#pragma unroll
      for (int j = 0; j < kIds; ++j) {
        const int w = w0 + j * P;
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          ahead[j][f] = live && w < W
                            ? block_value<V>(blocks + (static_cast<size_t>(w) * kF + f) * Nz + n)
                            : V(0);
        }
      }
    }
    V pc[kIds][kCj];
#pragma unroll
    for (int j = 0; j < kIds; ++j) {
      ok[j] = id[j] >= 0 && id[j] < S;  // padded / out-of-range: dropped
#pragma unroll
      for (int cj = 0; cj < kCj; ++cj) {
        pc[j][cj] = ok[j] && cj < cj_n ? __ldg(pcol + static_cast<size_t>(cj) * S + id[j]) : V(0);
      }
    }
#pragma unroll
    for (int j = 0; j < kIds; ++j) {
      const int w = w0 + j * P;
      if (w >= W) break;  // warp-uniform
      const T* b = blocks + static_cast<size_t>(w) * F * Nz + n;
      V z[kCj];
#pragma unroll
      for (int cj = 0; cj < kCj; ++cj) z[cj] = V(0);
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
        for (int cj = 0; cj < kCj; ++cj) {
          if (ci < ci_n && cj < cj_n) {
            const V bv = kAhead ? ahead[kAhead ? j : 0][kAhead ? ci * kCj + cj : 0]
                         : live ? block_value<V>(b + static_cast<size_t>(ci * cj_n + cj) * Nz)
                                : V(0);
            acc[ci] = fma_v(bv, pc[j][cj], acc[ci]);
            z[cj] = fma_v(bv, pr[ci], z[cj]);
          }
        }
      }
      if (ok[j]) {
#pragma unroll
        for (int cj = 0; cj < kCj; ++cj) {
          if (cj < cj_n) atomicAdd(cols + static_cast<size_t>(cj) * S + id[j], z[cj]);
        }
      }
    }
  }
  if (kSpread && P > 1) {  // P is the same for every block
    if (p > 0) {
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
        if (ci < ci_n) lane_rows[((p - 1) * ci_n + ci) * E + e] = acc[ci];
      }
    }
    __syncthreads();
    if (p > 0) return;
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
      if (ci < ci_n) {
        for (int q = 1; q < P; ++q) acc[ci] += lane_rows[((q - 1) * ci_n + ci) * E + e];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
      if (ci < ci_n) rows[ci * Nz + n] = acc[ci];
    }
  }
}

template <typename T, typename V>
using SlotsKernel = void (*)(const int*, const T*, const V*, const V*, V*, V*, int, int, int,
                             int, int, int);


// P: slot lanes, 1, 2, 4 or 8; 0: one, or on a level of fewer than
// kSlotSpreadMaxN elements the largest power of two <= min(W, 8)
template <typename T, typename V>
cudaError_t launch_slots(const void* ids, const void* blocks, const void* pcol,
                         const void* prow, void* rows, void* cols, int W, int N, int Ci, int Cj,
                         int S, int P, void* stream) {
  if (Ci < 1 || Ci > kAtomicsMaxCi || Cj < 1 || Cj > kMaxCj || W < 1 ||
      (P != 0 && P != 1 && P != 2 && P != 4 && P != 8)) {
    return cudaErrorInvalidValue;
  }
  if (N > 0) {
    if (P == 0) {
      P = 1;
      while (N < kSlotSpreadMaxN && P * 2 <= W && P < 8) P *= 2;
    }
    const int E = kSlotThreads / P;
    const int grid = (N + E - 1) / E;
    SlotsKernel<T, V> kernel =
        Ci == 3 && Cj == 3 ? (P > 1 ? fused_pair_slots_kernel<T, V, 3, 3, true, true>
                                    : fused_pair_slots_kernel<T, V, 3, 3, true, false>)
        : Cj > 4           ? fused_pair_slots_kernel<T, V, kAtomicsMaxCi, kMaxCj, false, true>
        : Ci <= 4          ? fused_pair_slots_kernel<T, V, 4, 4, false, true>
                           : fused_pair_slots_kernel<T, V, kAtomicsMaxCi, 4, false, true>;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16 blocks: the wide rotation rows exactly too (the guarded (16,
      // 4) instantiation loads no block ahead and took 2-4x as long)
      if (Ci == 9 && Cj == 3) kernel = fused_pair_slots_kernel<T, V, 9, 3, true, true>;
      if (Ci == 16 && Cj == 3) kernel = fused_pair_slots_kernel<T, V, 16, 3, true, true>;
    }
    const size_t smem = static_cast<size_t>(P - 1) * Ci * E * sizeof(V);  // <= 32 KB
    kernel<<<grid, kSlotThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const T*>(blocks),
        static_cast<const V*>(pcol), static_cast<const V*>(prow), static_cast<V*>(rows),
        static_cast<V*>(cols), W, N, Ci, Cj, S, P);
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

// The slots kernel (the redesigned atomics body): f32, and f64.
extern "C" int thallo_fused_pair_atomics_slots(const void* ids, const void* blocks,
                                               const void* pcol, const void* prow, void* rows,
                                               void* cols, int W, int N, int Ci, int Cj, int S,
                                               void* stream) {
  return static_cast<int>(launch_slots<float, float>(ids, blocks, pcol, prow, rows, cols, W, N,
                                                     Ci, Cj, S, 0, stream));
}

extern "C" int thallo_fused_pair_atomics_slots_f64(const void* ids, const void* blocks,
                                                   const void* pcol, const void* prow,
                                                   void* rows, void* cols, int W, int N, int Ci,
                                                   int Cj, int S, void* stream) {
  return static_cast<int>(launch_slots<double, double>(ids, blocks, pcol, prow, rows, cols, W,
                                                       N, Ci, Cj, S, 0, stream));
}

// The slots kernel on bf16 blocks (every other operand f32), on P slot
// lanes (1, 2, 4 or 8).
extern "C" int thallo_fused_pair_atomics_slots_bf16(const void* ids, const void* blocks,
                                                    const void* pcol, const void* prow,
                                                    void* rows, void* cols, int W, int N, int Ci,
                                                    int Cj, int S, int P, void* stream) {
  if (P == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_slots<__nv_bfloat16, float>(ids, blocks, pcol, prow, rows,
                                                             cols, W, N, Ci, Cj, S, P, stream));
}
