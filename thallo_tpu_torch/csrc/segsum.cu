// Destination-tiled segment sum from a host plan (replaces the Pallas
// kernel of thallo_tpu/ops/segsum.py::pallas_segment_sum).  See
// thallo_tpu_torch/ops/segsum.py for the contract:
//   out[t*TN + rel[t,e], c] += data[gather_idx[t,e], c] * mask[t,e]
// over the lanes (t, e) with gather_idx < M and mask != 0; padded lanes
// (gather_idx == M, mask 0) are skipped, so they add exactly nothing.
//
// Grid (T, ceil(TE / chunk)): block (t, k) takes lanes [k*chunk, ...) of
// tile t, so a plan with few long tiles still fills the card.  A warp
// reads 32 neighbouring lanes; a tile's lanes are sorted by destination,
// so runs of equal destination are common (a small image's tile holds
// ~1000 lanes per destination).  A warp with long runs first sums each
// run with shuffles (a segmented reduction over runs of equal rel; a run is
// contiguous by construction, and lanes of one value of rel that are not
// contiguous form separate runs, so any plan sums right), and the run's
// first lane adds the sum into a [TN, C] accumulator in shared memory; a
// warp of short runs adds lane by lane (kDirectRuns).
// The block then adds each nonzero entry whose segment lies below
// num_segments into out with one global atomic.  data is read through
// its element strides (sm, sc): a transposed channel-major buffer needs
// no copy.  The caller zeroes out; the kernel allocates nothing.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // a multiple of 32: see the warp shuffles
constexpr unsigned kFull = 0xffffffffu;
// a warp with at least this many runs (runs of ~4 lanes or fewer, e.g. a
// point image seen 4 times) adds lane by lane: its shared-atomic
// conflicts cost less than the shuffles (H100: 0.027 against 0.054 ms on
// the BA-1M points plan)
constexpr int kDirectRuns = 8;
constexpr int kMaxSmem = 96 * 1024;  // ops/_cuda.py MAX_DYNAMIC_SMEM

__global__ void segment_sum_kernel(const float* __restrict__ data, long long sm,
                                   long long sc, const int* __restrict__ gather_idx,
                                   const int* __restrict__ rel,
                                   const float* __restrict__ mask,
                                   float* __restrict__ out, int M, int C, int TE, int TN,
                                   int num_segments, int chunk) {
  extern __shared__ float acc[];
  const int t = blockIdx.x;
  const int n_acc = TN * C;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const size_t base = static_cast<size_t>(t) * TE;
  const int e0 = blockIdx.y * chunk;
  const int e1 = min(e0 + chunk, TE);
  const int lane = threadIdx.x & 31;
  // whole warps step together (blockDim is a multiple of 32), so every
  // lane takes part in the shuffles; lanes past e1 or skipped carry k = -1
  for (int eb = e0; eb < e1; eb += blockDim.x) {
    const int e = eb + threadIdx.x;
    int k = -1, g = 0;
    float m = 0.f;
    if (e < e1) {
      g = __ldg(gather_idx + base + e);
      m = __ldg(mask + base + e);
      const int kk = __ldg(rel + base + e);
      if (g >= 0 && g < M && m != 0.f && kk >= 0 && kk < TN) k = kk;
    }
    const int prev = __shfl_up_sync(kFull, k, 1);
    const bool head = lane == 0 || prev != k;
    const unsigned heads = __ballot_sync(kFull, head);
    const float* row = data + static_cast<long long>(g) * sm;
    if (__popc(heads) >= kDirectRuns) {  // warp-uniform: short runs
      if (k >= 0) {
        for (int c = 0; c < C; ++c) atomicAdd(acc + k * C + c, __ldg(row + c * sc) * m);
      }
      continue;
    }
    const int run = __popc(heads & ((2u << lane) - 1u));
    unsigned same = 0;  // bit j: lane + 2^j lies in this lane's run
    for (int j = 0; j < 5; ++j) {
      const int d = 1 << j;
      const int other = __shfl_down_sync(kFull, run, d);
      if (lane + d < 32 && other == run) same |= 1u << j;
    }
    for (int c = 0; c < C; ++c) {
      float v = k >= 0 ? __ldg(row + c * sc) * m : 0.f;
      for (int j = 0; j < 5; ++j) {
        const float o = __shfl_down_sync(kFull, v, 1 << j);
        if (same & (1u << j)) v += o;
      }
      if (head && k >= 0) atomicAdd(acc + k * C + c, v);
    }
  }
  __syncthreads();

  const size_t out0 = static_cast<size_t>(t) * TN * C;
  const int valid = min(n_acc, (num_segments - t * TN) * C);
  for (int i = threadIdx.x; i < valid; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(out + out0 + i, v);
  }
}

}  // namespace

extern "C" int thallo_segment_sum(const void* data, long long sm, long long sc,
                                  const void* gather_idx, const void* rel, const void* mask,
                                  void* out, int M, int C, int T, int TE, int TN,
                                  int num_segments, int chunk, void* stream) {
  if (T > 0 && TE > 0 && C > 0 && chunk > 0) {
    const size_t smem = static_cast<size_t>(TN) * C * sizeof(float);
    const int splits = (TE + chunk - 1) / chunk;
    if (smem > kMaxSmem || splits > 65535) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    segment_sum_kernel<<<dim3(T, splits), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(data), sm, sc, static_cast<const int*>(gather_idx),
        static_cast<const int*>(rel), static_cast<const float*>(mask),
        static_cast<float*>(out), M, C, TE, TN, num_segments, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
