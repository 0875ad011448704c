// Launch-floor probe: o = x + 1 over an [8, L] f32 array (replaces the
// Pallas kernel of scripts/tpu_loop_floor.py, `trivial_kernel` in its one-
// tile and 64-tile forms).  Block b owns columns [b*L/tiles, (b+1)*L/tiles)
// of all 8 rows, the TPU form's (8, L/tiles) tile; its threads walk the
// tile with neighbouring threads on neighbouring columns.  The kernel moves
// 2 * 8 * L * 4 bytes (64 KB for [8, 1024]): what it measures is the cost
// of a launch.  The kernel allocates nothing.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void add_one_kernel(const float* __restrict__ x, float* __restrict__ o, int L,
                               int tile) {
  const size_t col0 = static_cast<size_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < kRows * tile; i += kThreads) {
    const size_t at = static_cast<size_t>(i / tile) * L + col0 + i % tile;
    o[at] = x[at] + 1.f;
  }
}

}  // namespace

extern "C" int thallo_loop_floor_add_one(const void* x, void* o, int L, int tiles,
                                         void* stream) {
  if (tiles < 1 || L % tiles != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L > 0) {
    add_one_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(o), L, L / tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
