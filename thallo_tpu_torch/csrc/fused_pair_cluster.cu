// The bf16 fused cross pair as thread-block clusters: the counterparts of
// scripts/tpu_fused_variants.py's make_v2 (one [Cj, S] cols accumulator
// carried across the grid) and make_v3 (per-program cols partials summed
// outside the kernel).  The contract is that of csrc/fused_pair.cu
// (thallo_tpu_torch/ops/fusedpair.py) for the pair it is specialised for,
// (Ci, Cj) = (3, 9), blocks read as bf16 and every other value, and all
// arithmetic, in f32 (the scripts' bf16 rounding of pcol and z fed the
// TPU's matrix unit and is not carried over):
//
//   rows[ci, n]  = sum_{cj,w} B[w,ci,cj,n] * pcol[cj, ids[w,n]]
//   cols[cj, s]  = sum_{ci,w} B[w,ci,cj,n] * prow[ci, n]   over ids[w,n] == s
//
// The body is the bf16 persistent kernel's (fused_pair.cu): a fixed grid
// of blocks strides over tiles of kElems neighbouring elements a thread
// (kElems = 2 reads one __nv_bfloat162 a block row, N even only), each
// slot's loads and products by pair_slot (fused_pair_slot.cuh), equal ids
// of a warp merged by add_cols (block_accum.cuh) into the block's [9, S]
// f32 accumulator in dynamic shared memory.  What differs is the sum
// across blocks.  The grid is launched as clusters of C blocks
// (cudaLaunchKernelEx, cudaLaunchAttributeClusterDimension), and at the
// end of the block loop:
//
//   1. cluster.sync(); block r of the cluster sums the r-th 1/C share of
//      the accumulator over the C blocks' shared memory (distributed
//      shared memory, cluster.map_shared_rank, one float4 a load; the
//      accumulator is zero-padded to whole float4s), peers in rank order;
//      the v2 atomics leave a warp as 128-byte lines (a shuffle turns the
//      lanes' float4s into 4 rounds of 32 neighbouring floats: atomics
//      16 bytes apart cost the flush 2-5x, H100);
//   2. the cluster's reduced accumulator leaves the cluster (kFlush):
//        kAtomics (v2)  one global atomicAdd per nonzero entry into cols
//                       [9, S], which the caller zeroes: G/C x 9S atomics
//                       instead of the G x 9S of a per-block flush
//        kSlabs   (v3)  plain float4 stores into the cluster's own slab of
//                       [G/C, n_pad]; the caller sums the slabs
//        kNone          nothing leaves (a measurement: the body and the
//                       in-cluster sum alone; `out` is null at run time,
//                       so the sums stay live but are never stored)
//   3. cluster.sync() again before any block exits: a block's shared
//      memory must outlive its peers' reads.
//
// The bound is the block read, W*27*N*2 bytes; the cols side costs W*N*9
// shared additions (f32 atomicAdd on shared memory, a compare-and-swap
// loop on sm_90a) and the flush.  A block with no tile (more blocks than
// tiles) contributes zeros.  The kernel allocates nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "block_accum.cuh"      // add_cols
#include "fused_pair_slot.cuh"  // pair_slot

namespace cg = cooperative_groups;

namespace {

constexpr int kCi = 3;
constexpr int kCj = 9;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 112 * 1024;  // ops/fusedpair.py PERSISTENT_MAX_SMEM
constexpr int kMaxCluster = 16;       // above 8 only where the card grants it
constexpr int kPortableCluster = 8;
enum Flush { kNone = 0, kAtomics = 1, kSlabs = 2 };  // ops/fusedpair.py _FLUSH_*

// at most kMaxThreads / kElems threads a block, and registers for kElems
// such blocks on an SM (64 a thread): at 86-90 registers, as the compiler
// may choose unbounded, a 512-thread block holds an SM alone (C = 2,
// nothing flushed: 0.0599 ms against 0.0470 at the uniform 1M shape, H100)
template <int kElems, int kFlush>
__global__ void __launch_bounds__(kMaxThreads / kElems, kElems)
    fused_pair_cluster_kernel(const int* __restrict__ ids,
                              const __nv_bfloat16* __restrict__ blocks,
                              const float* __restrict__ pcol, const float* __restrict__ prow,
                              float* __restrict__ rows, float* __restrict__ out, int W, int N,
                              int S, int merge_min) {
  extern __shared__ float4 acc4[];  // [n4]: the [9, S] accumulator, zero-padded
  float* acc_cols = reinterpret_cast<float*>(acc4);
  const int n_acc = kCj * S;
  const int n4 = (n_acc + 3) / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const size_t Nz = static_cast<size_t>(N);
  const int lane = threadIdx.x & 31;

  // the trip counts of both loops are the same for every lane of a warp,
  // so all 32 lanes reach add_cols's warp primitives together
  const int per_tile = static_cast<int>(blockDim.x) * kElems;
  const int n_tiles = (N + per_tile - 1) / per_tile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile * blockDim.x + threadIdx.x) * kElems;
    const bool live = n0 < N;  // kElems = 2 only for an even N: both or neither
    float pr[kElems][kCi];
    float acc[kElems][kCi];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
        pr[e][ci] = live ? __ldg(prow + ci * Nz + n0 + e) : 0.f;
        acc[e][ci] = 0.f;
      }
    }
    for (int w = 0; w < W; ++w) {
      float z[kElems][kCj];
      int id[kElems];
      bool ok[kElems];
      pair_slot<__nv_bfloat16, kCi, kCj, kElems, true>(ids, blocks, pcol, S, Nz, w, n0, live,
                                                       pr, acc, z, id, ok);
#pragma unroll
      for (int e = 0; e < kElems; ++e) add_cols<kCj>(acc_cols, S, id[e], ok[e], z[e], lane,
                                                     merge_min);
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
#pragma unroll
        for (int ci = 0; ci < kCi; ++ci) rows[ci * Nz + n0 + e] = acc[e][ci];
      }
    }
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's shared additions done and visible to the cluster
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int lo = static_cast<int>(static_cast<long long>(n4) * r / C);
  const int hi = static_cast<int>(static_cast<long long>(n4) * (r + 1) / C);
  float4* slab = reinterpret_cast<float4*>(out) + static_cast<size_t>(blockIdx.x / C) * n4;
  // warp-uniform rounds over the share: lane l sums float4 unit base + l
  for (int base = lo + (threadIdx.x & ~31); base < hi; base += blockDim.x) {
    const int i = base + lane;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < hi) {
#pragma unroll 4
      for (int q = 0; q < C; ++q) {  // its own share read as plain shared memory
        const float4 v = q == r ? acc4[i] : *cluster.map_shared_rank(acc4 + i, q);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    if (kFlush == kAtomics) {
      // the warp's 128 values leave as 4 rounds of 32 neighbouring floats
      // (one 128-byte line an instruction): in round k lane l adds value
      // 32k + l, component l % 4 of lane 8k + l / 4's float4
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int src = 8 * k + (lane >> 2);
        const float x = __shfl_sync(kFull, s.x, src);
        const float y = __shfl_sync(kFull, s.y, src);
        const float zz = __shfl_sync(kFull, s.z, src);
        const float ww = __shfl_sync(kFull, s.w, src);
        const int c = lane & 3;
        const float v = c == 0 ? x : c == 1 ? y : c == 2 ? zz : ww;
        const int idx = 4 * base + 32 * k + lane;
        if (idx < 4 * hi && idx < n_acc && v != 0.f) atomicAdd(out + idx, v);
      }
    } else if (i < hi && (kFlush == kSlabs || out != nullptr)) {
      slab[i] = s;
    }
  }
  cluster.sync();  // no block exits while a peer may still read its shared memory
}

using Kernel = void (*)(const int*, const __nv_bfloat16*, const float*, const float*, float*,
                        float*, int, int, int, int);

Kernel pick(int elems, int mode) {
  static const Kernel table[2][3] = {
      {fused_pair_cluster_kernel<1, kNone>, fused_pair_cluster_kernel<1, kAtomics>,
       fused_pair_cluster_kernel<1, kSlabs>},
      {fused_pair_cluster_kernel<2, kNone>, fused_pair_cluster_kernel<2, kAtomics>,
       fused_pair_cluster_kernel<2, kSlabs>}};
  return table[elems - 1][mode];
}

size_t smem_bytes(int S) { return static_cast<size_t>((kCj * S + 3) / 4) * sizeof(float4); }

bool config_ok(int S, int threads, int cluster, int elems, int mode) {
  return S >= 1 && static_cast<size_t>(kCj) * S * sizeof(float) <= kMaxSmem &&
         (elems == 1 || elems == 2) && threads >= 32 && threads % 32 == 0 &&
         threads <= kMaxThreads / elems && cluster >= 1 && cluster <= kMaxCluster && mode >= 0 &&
         mode <= kSlabs;
}

// The function attributes a launch of this shape needs: the opt-in dynamic
// shared memory, and clusters above the portable 8 blocks.
cudaError_t prepare(Kernel kernel, int S, int cluster) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(S)));
  if (err == cudaSuccess && cluster > kPortableCluster) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

cudaLaunchConfig_t config(int grid, int threads, int S, cudaStream_t stream,
                          cudaLaunchAttribute* attr, int cluster) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes(S);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The most clusters of `cluster` blocks of `threads` threads (and the
// [9, S] accumulator) that the card holds at once, for the instantiation
// (elems, mode), into *max_clusters (0 where none fits).
extern "C" int thallo_fused_pair_cluster_occupancy(int S, int threads, int cluster, int elems,
                                                   int mode, int* max_clusters) {
  if (max_clusters == nullptr || !config_ok(S, threads, cluster, elems, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *max_clusters = 0;
  const Kernel kernel = pick(elems, mode);
  cudaError_t err = prepare(kernel, S, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(cluster, threads, S, nullptr, &attr, cluster);
  err = cudaOccupancyMaxActiveClusters(max_clusters, reinterpret_cast<const void*>(kernel), &cfg);
  return static_cast<int>(err);
}

// mode: 0 kNone (out null), 1 kAtomics (out: cols [9, S], zeroed by the
// caller), 2 kSlabs (out: [grid / cluster, n_pad] slabs, n_pad = 9S
// rounded up to a multiple of 4); grid: a multiple of cluster; elems: 1,
// or 2 for an even N.
extern "C" int thallo_fused_pair_cluster(const void* ids, const void* blocks, const void* pcol,
                                         const void* prow, void* rows, void* out, int W, int N,
                                         int Ci, int Cj, int S, int threads, int grid,
                                         int cluster, int merge_min, int elems, int mode,
                                         void* stream) {
  if (Ci != kCi || Cj != kCj || W < 0 || N < 0 || merge_min < 2 ||
      !config_ok(S, threads, cluster, elems, mode) || (elems == 2 && N % 2 != 0) ||
      grid < cluster || grid % cluster != 0 || (mode != kNone && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(elems, mode);
  cudaError_t err = prepare(kernel, S, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(grid, threads, S, static_cast<cudaStream_t>(stream), &attr, cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int*>(ids),
                           static_cast<const __nv_bfloat16*>(blocks),
                           static_cast<const float*>(pcol), static_cast<const float*>(prow),
                           static_cast<float*>(rows), static_cast<float*>(out), W, N, S,
                           merge_min);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
