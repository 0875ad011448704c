// The rows side of the fused cross pair on bf16 blocks, alone (replaces
// the Pallas kernel of scripts/tpu_fused_variants.py::make_v1, whose body
// `_common` computes both sides and stores only the rows):
//
//   rows[ci, n] = sum_{w, cj} B[w, ci, cj, n] * pcol[cj, ids[w, n]]
//
// for the BA point-camera pair (Ci = 3, Cj = 9), blocks w-major
// [W, 27, N] bf16 with N innermost; entries whose id lies outside [0, S)
// contribute nothing.  The bound is the block read, W*27*N*2 bytes (54 MB
// at W 4, N 250 000), plus the ids (4*W*N) and the rows (12*N).
//
// Without a cols side the kernel needs no shared accumulator.
// fused_pair_rows_kernel<kElems>: kElems neighbouring elements a thread,
// 2 (one __nv_bfloat162 a block row, one int2 of ids a slot, one float2 of
// rows a channel; N even, so every plane starts 4-byte aligned) or 1.
// pcol is read through the read-only cache, the block rows by __ldcs
// (streamed past the caches that hold ids and pcol).  The grid is `grid`
// blocks of `threads` threads: one tile of threads*kElems elements a block
// where grid covers the tiles, else the blocks stride over them (the
// persistent form).  Every value is widened to f32 on load; all arithmetic
// is f32.  The kernel allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCi = 3;
constexpr int kCj = 9;
constexpr int kF = kCi * kCj;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(__ldcs(p));
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 f = __bfloat1622float2(__ldcs(reinterpret_cast<const __nv_bfloat162*>(p)));
  v[0] = f.x;
  v[1] = f.y;
}

__device__ __forceinline__ void load_ids(const int* p, int (&id)[1]) { id[0] = __ldg(p); }

__device__ __forceinline__ void load_ids(const int* p, int (&id)[2]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  id[0] = v.x;
  id[1] = v.y;
}

__device__ __forceinline__ void store_rows(float* p, const float (&v)[1]) { p[0] = v[0]; }

__device__ __forceinline__ void store_rows(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int kElems>
__global__ void __launch_bounds__(kMaxThreads)
    fused_pair_rows_kernel(const int* __restrict__ ids, const __nv_bfloat16* __restrict__ blocks,
                           const float* __restrict__ pcol, float* __restrict__ rows, int W,
                           int N, int S, int n_tiles) {
  const size_t Nz = static_cast<size_t>(N);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile * blockDim.x + threadIdx.x) * kElems;
    if (n0 >= N) continue;  // N % kElems == 0: all kElems elements or none
    float acc[kCi][kElems];
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[ci][e] = 0.f;
    }
    for (int w = 0; w < W; ++w) {
      int id[kElems];
      load_ids(ids + static_cast<size_t>(w) * Nz + n0, id);
      bool ok[kElems];
      bool any = false;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        ok[e] = static_cast<unsigned>(id[e]) < static_cast<unsigned>(S);
        any = any || ok[e];
      }
      if (!any) continue;  // no block read for a slot without a valid entry
      float pc[kCj][kElems];
#pragma unroll
      for (int cj = 0; cj < kCj; ++cj) {
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const float v = __ldg(pcol + static_cast<size_t>(cj) * S + (ok[e] ? id[e] : 0));
          pc[cj][e] = ok[e] ? v : 0.f;
        }
      }
      // the 27 block rows in plane order, all loads in flight together
      const __nv_bfloat16* b = blocks + static_cast<size_t>(w) * kF * Nz + n0;
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
        for (int cj = 0; cj < kCj; ++cj) {
          float v[kElems];
          load_row(b + static_cast<size_t>(ci * kCj + cj) * Nz, v);
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[ci][e] = fmaf(v[e], pc[cj][e], acc[ci][e]);
        }
      }
    }
#pragma unroll
    for (int ci = 0; ci < kCi; ++ci) store_rows(rows + ci * Nz + n0, acc[ci]);
  }
}

template <int kElems>
cudaError_t launch(const void* ids, const void* blocks, const void* pcol, void* rows, int W,
                   int N, int S, int threads, int grid, cudaStream_t stream) {
  const int per_tile = threads * kElems;
  const int n_tiles = (N + per_tile - 1) / per_tile;
  fused_pair_rows_kernel<kElems><<<grid < n_tiles ? grid : n_tiles, threads, 0, stream>>>(
      static_cast<const int*>(ids), static_cast<const __nv_bfloat16*>(blocks),
      static_cast<const float*>(pcol), static_cast<float*>(rows), W, N, S, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// rows [3, N] f32 of the 3 x 9 pair on bf16 blocks [W, 27, N].  elems: 1
// or 2 (N even); threads: a multiple of 32 up to 1024; grid: blocks to
// launch at most (fewer when the elements make fewer tiles).
extern "C" int thallo_fused_pair_rows(const void* ids, const void* blocks, const void* pcol,
                                      void* rows, int W, int N, int Ci, int Cj, int S,
                                      int threads, int grid, int elems, void* stream) {
  const bool elems_ok = (elems == 1) || (elems == 2 && N % 2 == 0);
  if (Ci != kCi || Cj != kCj || S < 1 || W < 0 || grid < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || !elems_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      elems == 2 ? launch<2>(ids, blocks, pcol, rows, W, N, S, threads, grid, s)
                 : launch<1>(ids, blocks, pcol, rows, W, N, S, threads, grid, s);
  return static_cast<int>(err);
}
