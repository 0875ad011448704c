// Full-repeat level setup (replaces the Pallas kernel of
// thallo_tpu/ops/fullrepeat.py::fullrepeat_setup).  See
// thallo_tpu_torch/ops/fullrepeat.py for the contract.
//
// One thread per element n; its observations are n*W + w, w < W.  The
// thread sums the aggregated slabs over w and c and writes agg[f, n], and
// writes each per-w cross value to cross[f0 + w*Ca*Cb + a*Cb + b, n].  No
// value is shared between threads: no atomics, deterministic sums.  Rows
// are [*, N_t*W] inputs and [*, N_t] outputs, N innermost.
//
// recipe: n_entries rows of 6 int32 (kind, offa, Ca, offb, Cb, f0):
//   kind 0 jtr    agg[f0+ch]          = sum_w sum_c J[offa + c*Ca + ch] * r[c]
//   kind 1 d2     agg[f0+ch]          = sum_w sum_c J[offa + c*Ca + ch]^2
//   kind 2 diag   agg[f0 + a*Cb+b]    = sum_w sum_c Ja[c, a] * Jb[c, b]
//   kind 3 cross  cross[f0 + w*Ca*Cb + a*Cb + b] = sum_c Ja_w[c, a] * Jb_w[c, b]
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__global__ void fullrepeat_kernel(const float* __restrict__ rT,
                                  const float* __restrict__ J,
                                  const int* __restrict__ recipe,
                                  float* __restrict__ agg,
                                  float* __restrict__ cross,
                                  int n_entries, int rc, int W, int N_t) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N_t) return;
  const size_t RW = static_cast<size_t>(N_t) * W;
  const size_t Nz = static_cast<size_t>(N_t);
  const float* Jn = J + static_cast<size_t>(n) * W;
  const float* rn = rT + static_cast<size_t>(n) * W;

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
        for (int w = 0; w < W; ++w) {
          for (int c = 0; c < rc; ++c) {
            const float j = __ldg(Jn + static_cast<size_t>(offa + c * Ca + ch) * RW + w);
            s = fmaf(j, kind == 0 ? __ldg(rn + c * RW + w) : j, s);
          }
        }
        agg[static_cast<size_t>(f0 + ch) * Nz + n] = s;
      }
    } else if (kind == 2) {
      for (int a = 0; a < Ca; ++a) {
        for (int b = 0; b < Cb; ++b) {
          float s = 0.f;
          for (int w = 0; w < W; ++w) {
            for (int c = 0; c < rc; ++c) {
              s = fmaf(__ldg(Jn + static_cast<size_t>(offa + c * Ca + a) * RW + w),
                       __ldg(Jn + static_cast<size_t>(offb + c * Cb + b) * RW + w), s);
            }
          }
          agg[static_cast<size_t>(f0 + a * Cb + b) * Nz + n] = s;
        }
      }
    } else {
      const int Fc = Ca * Cb;
      for (int w = 0; w < W; ++w) {
        for (int a = 0; a < Ca; ++a) {
          for (int b = 0; b < Cb; ++b) {
            float s = 0.f;
            for (int c = 0; c < rc; ++c) {
              s = fmaf(__ldg(Jn + static_cast<size_t>(offa + c * Ca + a) * RW + w),
                       __ldg(Jn + static_cast<size_t>(offb + c * Cb + b) * RW + w), s);
            }
            cross[static_cast<size_t>(f0 + w * Fc + a * Cb + b) * Nz + n] = s;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int thallo_fullrepeat_setup(const void* rT, const void* Jall,
                                       const void* recipe, void* agg, void* cross,
                                       int n_entries, int rc, int W, int N_t,
                                       void* stream) {
  if (N_t > 0) {
    constexpr int kThreads = 256;
    const int grid = (N_t + kThreads - 1) / kThreads;
    fullrepeat_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rT), static_cast<const float*>(Jall),
        static_cast<const int*>(recipe), static_cast<float*>(agg),
        static_cast<float*>(cross), n_entries, rc, W, N_t);
  }
  return static_cast<int>(cudaGetLastError());
}
