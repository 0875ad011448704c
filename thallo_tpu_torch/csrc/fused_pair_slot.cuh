// pair_slot: one degree slot w of the fused cross pair for the kElems
// neighbouring elements a thread owns, shared by the persistent kernels of
// fused_pair.cu and fused_pair_wloop.cu.  Block values are read at their
// stored type T and streamed past the caches that hold pcol and ids
// (__ldcs): float, or __nv_bfloat16 through the intrinsics only, one
// value or two neighbouring ones as one __nv_bfloat162 (4 bytes a lane, a
// 128-byte warp load).  Everything else, and all arithmetic, is f32.
// Internal linkage: each source that includes it compiles its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ void load_block(const float* p, float (&v)[1]) { v[0] = __ldcs(p); }

__device__ __forceinline__ void load_block(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(__ldcs(p));
}

// p even-aligned: the caller gives kElems = 2 only where N is even
__device__ __forceinline__ void load_block(const __nv_bfloat16* p, float (&v)[2]) {
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

// Elements n0 .. n0 + kElems - 1 (live: all of them lie below N) at slot
// w of the w-major blocks [W, kCi*kCj, N]: each element's id, whether it
// lies in [0, S) (ok), its rows added to acc and its z vector (zero where
// not ok; padded / out-of-range entries contribute nothing).
template <typename T, int kCi, int kCj, int kElems, bool kCols>
__device__ __forceinline__ void pair_slot(const int* __restrict__ ids,
                                          const T* __restrict__ blocks,
                                          const float* __restrict__ pcol, int S, size_t Nz,
                                          int w, int n0, bool live,
                                          const float (&pr)[kElems][kCi],
                                          float (&acc)[kElems][kCi], float (&z)[kElems][kCj],
                                          int (&id)[kElems], bool (&ok)[kElems]) {
  constexpr int kF = kCi * kCj;
  if (live) {
    load_ids(ids + static_cast<size_t>(w) * Nz + n0, id);
  } else {
#pragma unroll
    for (int e = 0; e < kElems; ++e) id[e] = -1;
  }
  bool any = false;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    ok[e] = static_cast<unsigned>(id[e]) < static_cast<unsigned>(S);
    any = any || ok[e];
#pragma unroll
    for (int cj = 0; cj < kCj; ++cj) z[e][cj] = 0.f;
  }
  if (!any) return;  // no block read for a slot without a valid entry
  float pc[kElems][kCj];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
#pragma unroll
    for (int cj = 0; cj < kCj; ++cj) {
      pc[e][cj] = ok[e] ? __ldg(pcol + static_cast<size_t>(cj) * S + id[e]) : 0.f;
    }
  }
  const T* b = blocks + static_cast<size_t>(w) * kF * Nz + n0;
#pragma unroll
  for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
    for (int cj = 0; cj < kCj; ++cj) {
      float v[kElems];
      load_block(b + static_cast<size_t>(ci * kCj + cj) * Nz, v);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float bv = ok[e] ? v[e] : 0.f;
        acc[e][ci] = fmaf(bv, pc[e][cj], acc[e][ci]);
        if (kCols) z[e][cj] = fmaf(bv, pr[e][ci], z[e][cj]);
      }
    }
  }
}

}  // namespace
