// Segment sum of channel-major parts by a per-row id into a small image
// (replaces the Pallas kernel of thallo_tpu/ops/ohsetup.py::
// oh_setup_aggregate).  See thallo_tpu_torch/ops/ohsetup.py for the
// contract: out[f, ids[r]] += parts[f, r] for ids[r] in [0, N).
//
// Grid (blocks_x, channel chunks).  Block (bx, by) owns the rows
// [bx*rows, (bx+1)*rows) and the channels [by*f_chunk, ...): it zeroes an
// [f_chunk, N] accumulator in shared memory, adds its rows into it with
// shared-memory atomics (threads read parts[f, r] with r innermost:
// coalesced), and then adds each nonzero accumulator entry into out with
// one global atomic.  A row's values therefore meet other rows of the
// same id in shared memory first; the global atomics number about
// blocks_x * F * N instead of F * R.  The caller zeroes out; the kernel
// allocates nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 96 * 1024;  // ops/_cuda.py MAX_DYNAMIC_SMEM

__global__ void oh_aggregate_kernel(const float* __restrict__ parts,
                                    const int* __restrict__ ids,
                                    float* __restrict__ out, int F, int R, int N,
                                    int f_chunk, int rows) {
  extern __shared__ float acc[];
  const int f0 = blockIdx.y * f_chunk;
  const int fc = min(f_chunk, F - f0);
  const int n_acc = fc * N;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, R);
  const size_t Rz = static_cast<size_t>(R);
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int id = __ldg(ids + r);
    if (id < 0 || id >= N) continue;
    const float* p = parts + static_cast<size_t>(f0) * Rz + r;
    for (int f = 0; f < fc; ++f) atomicAdd(acc + f * N + id, __ldg(p + f * Rz));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(out + static_cast<size_t>(f0) * N + i, v);
  }
}

}  // namespace

extern "C" int thallo_oh_setup_aggregate(const void* parts, const void* ids, void* out,
                                         int F, int R, int N, void* stream) {
  if (R > 0 && F > 0 && N > 0) {
    if (static_cast<size_t>(N) * sizeof(float) > kMaxSmem) return cudaErrorInvalidValue;
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int f_chunk = std::max(1, std::min(F, kMaxSmem / static_cast<int>(N * sizeof(float))));
    const int n_fchunks = (F + f_chunk - 1) / f_chunk;
    const size_t smem = static_cast<size_t>(f_chunk) * N * sizeof(float);
    // about two blocks per SM over all channel chunks; rows a multiple of
    // the block size
    int blocks_x = std::max(1, std::min((R + kThreads - 1) / kThreads,
                                        (2 * sms + n_fchunks - 1) / n_fchunks));
    int rows = (R + blocks_x - 1) / blocks_x;
    rows = (rows + kThreads - 1) / kThreads * kThreads;
    blocks_x = (R + rows - 1) / rows;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(oh_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    oh_aggregate_kernel<<<dim3(blocks_x, n_fchunks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(parts), static_cast<const int*>(ids),
        static_cast<float*>(out), F, R, N, f_chunk, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
