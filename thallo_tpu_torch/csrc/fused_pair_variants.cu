// The fused cross pair with bf16 block storage, in four forms of its cols
// output: mode 0 is the first bf16 body of the pair (fused_pair_bf16_atomics:
// the bf16 shapes the persistent kernels of fused_pair.cu and
// fused_pair_wloop.cu do not take, and the first port of
// scripts/tpu_fused_pair_micro.py's `fused_pair_kernel`, whose pair now runs
// the bf16 persistent kernel); modes 1-3 replace the Pallas kernels of
// scripts/tpu_fused_variants.py, make_v1/v2/v3.
// The contract is that of csrc/fused_pair.cu (thallo_tpu_torch/ops/
// fusedpair.py), with blocks read as bf16 and every other value, and all
// arithmetic, in f32 (the JAX scripts' bf16 rounding of pcol and z fed the
// TPU's matrix unit and is not carried over):
//
//   kMode 0 (atomics)   both outputs; cols by one global atomic per value
//   kMode 1 (v1)        rows only
//   kMode 2 (v2)        cols summed in a shared [Cj, S] accumulator per
//                       block, then one global atomic per nonzero entry
//   kMode 3 (v3)        cols summed in the same accumulator, then written
//                       whole as the block's partial slab [G, Cj, S]; the
//                       caller sums the G slabs
//
// One thread per element n loops over the W degree slots, as in
// fused_pair.cu.  Modes 0 and 1 launch one thread per element; modes 2
// and 3 launch G blocks (about two per SM) that stride over the elements,
// so each block's accumulator sees many elements.  The bound is the block
// read, W*Ci*Cj*N*2 bytes.  The caller zeroes cols (modes 0, 2); the
// kernel allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxCi = 8;   // ops/fusedpair.py MAX_CI
constexpr int kMaxCj = 16;  // ops/fusedpair.py MAX_CJ
constexpr int kThreads = 256;
constexpr int kMaxSmem = 96 * 1024;  // ops/_cuda.py MAX_DYNAMIC_SMEM

template <int kMode>
__global__ void fused_pair_bf16_kernel(const int* __restrict__ ids,
                                       const __nv_bfloat16* __restrict__ blocks,
                                       const float* __restrict__ pcol,
                                       const float* __restrict__ prow,
                                       float* __restrict__ rows,
                                       float* __restrict__ cols,
                                       int W, int N, int Ci, int Cj, int S) {
  constexpr bool kShared = kMode >= 2;
  extern __shared__ float acc_cols[];  // [Cj, S] (modes 2, 3)
  const int n_acc = Cj * S;
  if (kShared) {
    for (int i = threadIdx.x; i < n_acc; i += kThreads) acc_cols[i] = 0.f;
    __syncthreads();
  }
  const size_t Nz = static_cast<size_t>(N);
  const size_t F = static_cast<size_t>(Ci) * Cj;
  for (int n = blockIdx.x * kThreads + threadIdx.x; n < N; n += gridDim.x * kThreads) {
    float pr[kMaxCi];
    float acc[kMaxCi];
#pragma unroll
    for (int ci = 0; ci < kMaxCi; ++ci) {
      pr[ci] = ci < Ci ? __ldg(prow + ci * Nz + n) : 0.f;
      acc[ci] = 0.f;
    }
    for (int w = 0; w < W; ++w) {
      const int id = __ldg(ids + static_cast<size_t>(w) * Nz + n);
      if (id < 0 || id >= S) continue;  // padded / out-of-range: dropped
      const __nv_bfloat16* b = blocks + static_cast<size_t>(w) * F * Nz + n;
      float pc[kMaxCj];
      float z[kMaxCj];
#pragma unroll
      for (int cj = 0; cj < kMaxCj; ++cj) {
        pc[cj] = cj < Cj ? __ldg(pcol + static_cast<size_t>(cj) * S + id) : 0.f;
        z[cj] = 0.f;
      }
#pragma unroll
      for (int ci = 0; ci < kMaxCi; ++ci) {
        if (ci < Ci) {
#pragma unroll
          for (int cj = 0; cj < kMaxCj; ++cj) {
            if (cj < Cj) {
              const float bv = __bfloat162float(b[static_cast<size_t>(ci * Cj + cj) * Nz]);
              acc[ci] = fmaf(bv, pc[cj], acc[ci]);
              if (kMode != 1) z[cj] = fmaf(bv, pr[ci], z[cj]);
            }
          }
        }
      }
      if (kMode == 0) {
#pragma unroll
        for (int cj = 0; cj < kMaxCj; ++cj) {
          if (cj < Cj) atomicAdd(cols + static_cast<size_t>(cj) * S + id, z[cj]);
        }
      } else if (kShared) {
#pragma unroll
        for (int cj = 0; cj < kMaxCj; ++cj) {
          if (cj < Cj) atomicAdd(acc_cols + cj * S + id, z[cj]);
        }
      }
    }
#pragma unroll
    for (int ci = 0; ci < kMaxCi; ++ci) {
      if (ci < Ci) rows[ci * Nz + n] = acc[ci];
    }
  }
  if (kShared) {
    __syncthreads();
    float* slab = kMode == 3 ? cols + static_cast<size_t>(blockIdx.x) * n_acc : cols;
    for (int i = threadIdx.x; i < n_acc; i += kThreads) {
      const float v = acc_cols[i];
      if (kMode == 3) {
        slab[i] = v;
      } else if (v != 0.f) {
        atomicAdd(slab + i, v);
      }
    }
  }
}

template <int kMode>
cudaError_t launch(const void* ids, const void* blocks, const void* pcol, const void* prow,
                   void* rows, void* cols, int W, int N, int Ci, int Cj, int S, int grid,
                   cudaStream_t stream) {
  const size_t smem = kMode >= 2 ? static_cast<size_t>(Cj) * S * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fused_pair_bf16_kernel<kMode>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  fused_pair_bf16_kernel<kMode><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const __nv_bfloat16*>(blocks),
      static_cast<const float*>(pcol), static_cast<const float*>(prow),
      static_cast<float*>(rows), static_cast<float*>(cols), W, N, Ci, Cj, S);
  return cudaGetLastError();
}

}  // namespace

// grid: blocks to launch (the caller sizes the [grid, Cj, S] partials of
// mode 3); 0 = one thread per element
extern "C" int thallo_fused_pair_bf16(const void* ids, const void* blocks, const void* pcol,
                                      const void* prow, void* rows, void* cols, int W, int N,
                                      int Ci, int Cj, int S, int mode, int grid,
                                      void* stream) {
  if (Ci < 1 || Ci > kMaxCi || Cj < 1 || Cj > kMaxCj || S < 1 || mode < 0 || mode > 3 ||
      grid < 0 || (mode >= 2 && static_cast<size_t>(Cj) * S * sizeof(float) > kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (grid == 0) grid = (N + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case 0: err = launch<0>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S, grid, s); break;
    case 1: err = launch<1>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S, grid, s); break;
    case 2: err = launch<2>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S, grid, s); break;
    default: err = launch<3>(ids, blocks, pcol, prow, rows, cols, W, N, Ci, Cj, S, grid, s); break;
  }
  return static_cast<int>(err);
}
