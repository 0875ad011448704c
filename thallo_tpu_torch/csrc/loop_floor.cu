// Launch-floor probe: o = x + 1 over an [8, L] f32 array (replaces the
// Pallas kernel of scripts/tpu_loop_floor.py, `trivial_kernel` in its one-
// tile and 64-tile forms).  The kernel moves 2 * 8 * L * 4 bytes (64 KB
// for [8, 1024]): what it measures is the cost of a launch, so what it
// must not add is latency of its own.  The array is read as one flat run
// of 8 * L floats, a multiple of 4 whatever L is, so each thread loads
// and stores one float4 (16 bytes, neighbouring threads on neighbouring
// addresses) and there is no tail; the grid is ceil(2 * L / kThreads)
// blocks, and no thread divides by a runtime value.  (Its first body gave
// each TPU tile one block of 256 threads that walked the tile in a loop,
// a runtime / and % per element, each load waiting on the one before.)
// The wrapper checks that x and o are 16-byte aligned; the kernel
// allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void add_one_kernel(const float4* __restrict__ x, float4* __restrict__ o, int n4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    float4 v = __ldg(x + i);
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    o[i] = v;
  }
}

}  // namespace

// x, o: [8, L] f32, contiguous, 16-byte aligned
extern "C" int thallo_loop_floor_add_one(const void* x, void* o, int L, void* stream) {
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = kRows * L / 4;
  if (n4 > 0) {
    add_one_kernel<<<(n4 + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const float4*>(x),
                                                          static_cast<float4*>(o), n4);
  }
  return static_cast<int>(cudaGetLastError());
}
