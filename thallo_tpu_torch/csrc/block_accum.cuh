// add_cols: the warp merge shared by the kernels that sum by id into a
// per-block shared accumulator (fused_pair.cu, fused_pair_wloop.cu,
// oh_aggregate.cu).  Where some id has merge_min lanes of a warp, the
// lanes of each id sum their z vectors by shuffles first, so a hot id
// costs the warp one shared addition per channel instead of up to 32
// serialised ones.  Templated on the value type V: float, or double for
// the f64 instantiations (__shfl_sync and atomicAdd take both on sm_90).
// fma_v is a fused multiply-add at V's precision, for the kernels
// templated on V.  Internal linkage: each source that includes it
// compiles its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fma_v(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_v(double a, double b, double c) { return fma(a, b, c); }

// One element's z vector into the block's accumulator.  Every lane of the
// warp calls this together (ok = false on a lane with nothing to add).
template <int kCj, typename V>
__device__ __forceinline__ void add_cols(V* __restrict__ acc_cols, int S, int id, bool ok,
                                         V (&z)[kCj], int lane, int merge_min) {
  // lanes with nothing to add get keys of their own
  const unsigned peers = __match_any_sync(kFull, ok ? id : -1 - lane);
  if (__any_sync(kFull, __popc(peers) >= merge_min)) {
    // sum each group of equal ids into its first lane: in every round the
    // lanes of even rank within their group take in the next lane's sum,
    // and the lanes of odd rank drop out (a tree over ranks, whatever
    // lanes the group occupies)
    const unsigned below = peers & ((1u << lane) - 1u);
    int rank = __popc(below);
    unsigned higher = peers & (0xfffffffeu << lane);
    while (__any_sync(kFull, higher != 0u)) {
      const int next = __ffs(higher);  // 1 + the next lane of the group, or 0
      const int src = next ? next - 1 : lane;
#pragma unroll
      for (int cj = 0; cj < kCj; ++cj) {
        const V t = __shfl_sync(kFull, z[cj], src);
        if (next) z[cj] += t;
      }
      higher &= ~__ballot_sync(kFull, rank & 1);
      rank >>= 1;
    }
    ok = ok && below == 0u;
  }
  if (ok) {
#pragma unroll
    for (int cj = 0; cj < kCj; ++cj) atomicAdd(acc_cols + cj * S + id, z[cj]);
  }
}

}  // namespace
