// One-hot-row-mode setup products (replaces the Pallas kernel of
// thallo_tpu/ops/ohsetup.py::oh_setup_products).  See
// thallo_tpu_torch/ops/ohsetup.py for the contract.
//
// One thread per observation r.  For each recipe entry the thread forms
// the entry's slab values from rT[:, r] and Jall[:, r] (rows are [*, R]
// with R innermost: coalesced across the warp; the repeated reads of
// the thread's rc + K inputs hit L1) and adds each value into
// out[f, ids[r]] with a global atomic.  Observations whose id lies
// outside [0, N) drop.  The caller zeroes out; the kernel allocates
// nothing.
//
// recipe: n_entries rows of 6 int32 (kind, offa, Ca, offb, Cb, f0):
//   kind 0 jtr   out[f0+ch]       += sum_c J[offa + c*Ca + ch] * r[c]
//   kind 1 d2    out[f0+ch]       += sum_c J[offa + c*Ca + ch]^2
//   kind 2 pair  out[f0 + a*Cb+b] += sum_c J[offa + c*Ca + a] * J[offb + c*Cb + b]
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__global__ void oh_setup_products_kernel(const float* __restrict__ rT,
                                         const float* __restrict__ J,
                                         const int* __restrict__ ids,
                                         const int* __restrict__ recipe,
                                         float* __restrict__ out,
                                         int n_entries, int rc, int R, int N) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int id = ids[r];
  if (id < 0 || id >= N) return;
  const size_t Rz = static_cast<size_t>(R);
  const size_t Nz = static_cast<size_t>(N);
  const float* Jr = J + r;
  const float* rr = rT + r;

  for (int e = 0; e < n_entries; ++e) {
    const int kind = __ldg(recipe + 6 * e + 0);
    const int offa = __ldg(recipe + 6 * e + 1);
    const int Ca = __ldg(recipe + 6 * e + 2);
    const int offb = __ldg(recipe + 6 * e + 3);
    const int Cb = __ldg(recipe + 6 * e + 4);
    const int f0 = __ldg(recipe + 6 * e + 5);
    if (kind == 0 || kind == 1) {
      for (int ch = 0; ch < Ca; ++ch) {
        float s = 0.f;
        for (int c = 0; c < rc; ++c) {
          const float j = __ldg(Jr + static_cast<size_t>(offa + c * Ca + ch) * Rz);
          s = fmaf(j, kind == 0 ? __ldg(rr + c * Rz) : j, s);
        }
        atomicAdd(out + static_cast<size_t>(f0 + ch) * Nz + id, s);
      }
    } else {
      for (int a = 0; a < Ca; ++a) {
        for (int b = 0; b < Cb; ++b) {
          float s = 0.f;
          for (int c = 0; c < rc; ++c) {
            s = fmaf(__ldg(Jr + static_cast<size_t>(offa + c * Ca + a) * Rz),
                     __ldg(Jr + static_cast<size_t>(offb + c * Cb + b) * Rz), s);
          }
          atomicAdd(out + static_cast<size_t>(f0 + a * Cb + b) * Nz + id, s);
        }
      }
    }
  }
}

}  // namespace

extern "C" int thallo_oh_setup_products(const void* rT, const void* Jall,
                                        const void* ids, const void* recipe,
                                        void* out, int n_entries, int rc, int R,
                                        int N, void* stream) {
  if (R > 0) {
    constexpr int kThreads = 256;
    const int grid = (R + kThreads - 1) / kThreads;
    oh_setup_products_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rT), static_cast<const float*>(Jall),
        static_cast<const int*>(ids), static_cast<const int*>(recipe),
        static_cast<float*>(out), n_entries, rc, R, N);
  }
  return static_cast<int>(cudaGetLastError());
}
