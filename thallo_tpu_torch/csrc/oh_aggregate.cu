// Segment sum of channel-major parts by a per-row id into a small image
// (replaces the Pallas kernel of thallo_tpu/ops/ohsetup.py::
// oh_setup_aggregate).  See thallo_tpu_torch/ops/ohsetup.py for the
// contract: out[f, ids[r]] += parts[f, r] for ids[r] in [0, N).  The bound
// is the read of parts and ids, (F + 1) * R * 4 bytes.
//
// oh_aggregate_smem_kernel  (thallo_oh_setup_aggregate_smem)
//   Grid (blocks_x, channel chunks); ops/ohsetup.py aggregate_plan sizes
//   the chunks (rows: the chunk's channels rounded up to kBatch) so that a
//   block's [rows, N] f32 accumulator fits its shared memory.  A fixed
//   grid strides over quads of 4 consecutive rows, a thread per quad: one
//   16-byte load of its 4 ids and one of each channel's 4 values (where R
//   is not a multiple of 4, 4-byte loads, masked at the ragged edge).
//   Then, for each of the quad's 4 rows, the warp's lanes with equal ids
//   sum their kBatch channel values by shuffles first (add_cols,
//   block_accum.cuh: only where some id has merge_min lanes), so a hot id
//   (the skewed scene's camera with half the rows) costs a shared
//   addition per channel and warp, not up to 32 serialised ones.  The
//   accumulator is zeroed and flushed once per block, one global atomic
//   per nonzero entry into a zeroed out.  (Measured on the H100 and not
//   kept, ops/ohsetup.py has the numbers: a flush into per-block slabs
//   summed by a second kernel; the next quad's loads issued before the
//   current quad's additions.)
//
// oh_aggregate_kernel  (thallo_oh_setup_aggregate_atomics, the first body)
//   Block (bx, by) owns the rows [bx*rows, (bx+1)*rows) and the channels
//   [by*f_chunk, ...): it zeroes an [f_chunk, N] accumulator in shared
//   memory, adds its rows into it with one shared atomic per row and
//   channel (4-byte loads, no merging), and then adds each nonzero entry
//   into out with one global atomic.  N up to kMaxSmem / 4.  The caller
//   zeroes out.
//
// f64 (the solver's double_precision): the shared-memory kernel is
// templated on the value type V of parts, the accumulator and out
// (thallo_oh_setup_aggregate_smem_f64: V = double; a quad's 4 values of a
// channel are two 16-byte double2 loads; ops/ohsetup.py plans the
// accumulator rows at 8 bytes a value).  The first body stays f32.
//
// The kernels allocate nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "block_accum.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 96 * 1024;  // ops/_cuda.py MAX_DYNAMIC_SMEM
constexpr int kBatch = 9;            // ops/ohsetup.py AGG_BATCH: channels per add_cols
constexpr int kMaxAggThreads = 1024;

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

// A whole quad's 4 values of one channel row, streamed: one float4, or
// two double2 (row 16-byte aligned).
__device__ __forceinline__ void load4(const float* row, int q, float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(row) + q);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* row, int q, double (&v)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(row) + 2 * q);
  const double2 b = __ldcs(reinterpret_cast<const double2*>(row) + 2 * q + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// The 4 ids and the nb (<= kBatch) channel values of quad q (rows 4q ..
// 4q + 3) from channel rows pf; kVec: R % 4 == 0, so every channel row is
// 16-byte aligned and every quad whole.  Past the rows: id -1, values 0.
template <bool kVec, typename V>
__device__ __forceinline__ void load_quad(const V* __restrict__ pf,
                                          const int* __restrict__ ids, size_t Rz, int R,
                                          int n_quads, int q, int nb, int (&id)[4],
                                          V (&v)[kBatch][4]) {
  const bool in = q < n_quads;
  if (kVec && in) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(ids) + q);
    id[0] = t.x;
    id[1] = t.y;
    id[2] = t.z;
    id[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) id[k] = in && 4 * q + k < R ? __ldcs(ids + 4 * q + k) : -1;
  }
#pragma unroll
  for (int cj = 0; cj < kBatch; ++cj) {
    const V* row = pf + static_cast<size_t>(cj) * Rz;
    const bool have = in && cj < nb;
    if (kVec && have) {
      load4(row, q, v[cj]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[cj][k] = have && 4 * q + k < R ? __ldcs(row + 4 * q + k) : V(0);
      }
    }
  }
}

// A quad's 4 rows into the accumulator, row by row, each through the warp
// merge.  Every lane of the warp calls this together.
template <typename V>
__device__ __forceinline__ void add_quad(V* acc, int N, const int (&id)[4],
                                         const V (&v)[kBatch][4], int lane, int merge_min) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    V z[kBatch];
#pragma unroll
    for (int cj = 0; cj < kBatch; ++cj) z[cj] = v[cj][k];
    add_cols<kBatch>(acc, N, id[k], static_cast<unsigned>(id[k]) < static_cast<unsigned>(N), z,
                     lane, merge_min);
  }
}

// f64: at most half the threads, so that a thread's kBatch x 4 doubles
// stay in registers (128 a thread; at 64, 520 bytes spilled)
template <bool kVec, typename V>
__global__ void __launch_bounds__(kMaxAggThreads * sizeof(float) / sizeof(V))
    oh_aggregate_smem_kernel(const V* __restrict__ parts, const int* __restrict__ ids,
                             V* __restrict__ out, int F, int R, int N, int chunk, int acc_rows,
                             int merge_min) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* acc = reinterpret_cast<V*>(smem_raw);  // [acc_rows, N]
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * chunk;
  const int fc = min(chunk, F - f0);
  const size_t n_acc = static_cast<size_t>(acc_rows) * N;
  for (size_t i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = V(0);
  __syncthreads();

  const size_t Rz = static_cast<size_t>(R);
  const int n_quads = (R + 3) / 4;
  // the loop runs warp by warp (base is the same on every lane): add_cols
  // needs all 32 lanes
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n_quads;
       base += gridDim.x * blockDim.x) {
    for (int fb = 0; fb < fc; fb += kBatch) {
      int id[4];
      V v[kBatch][4];
      load_quad<kVec>(parts + static_cast<size_t>(f0 + fb) * Rz, ids, Rz, R, n_quads,
                      base + lane, min(kBatch, fc - fb), id, v);
      add_quad(acc + static_cast<size_t>(fb) * N, N, id, v, lane, merge_min);
    }
  }
  __syncthreads();

  V* dst = out + static_cast<size_t>(f0) * N;
  for (size_t i = threadIdx.x; i < static_cast<size_t>(fc) * N; i += blockDim.x) {
    const V a = acc[i];
    if (a != V(0)) atomicAdd(dst + i, a);
  }
}

template <bool kVec, typename V>
cudaError_t launch_smem(const V* parts, const int* ids, V* out, int F, int R, int N, int chunk,
                        int acc_rows, int merge_min, int threads, int grid, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(acc_rows) * N * sizeof(V);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(oh_aggregate_smem_kernel<kVec, V>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 blocks(grid, (F + chunk - 1) / chunk);
  oh_aggregate_smem_kernel<kVec, V><<<blocks, threads, smem, stream>>>(
      parts, ids, out, F, R, N, chunk, acc_rows, merge_min);
  return cudaGetLastError();
}

template <typename V>
int aggregate_smem(const void* parts, const void* ids, void* out, int F, int R, int N, int chunk,
                   int acc_rows, int merge_min, int threads, int grid, void* stream) {
  if (F < 1 || R < 0 || N < 1 || chunk < 1 || acc_rows < chunk || acc_rows % kBatch != 0 ||
      threads < 32 || threads > static_cast<int>(kMaxAggThreads * sizeof(float) / sizeof(V)) ||
      threads % 32 != 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* p = static_cast<const V*>(parts);
  const auto* id = static_cast<const int*>(ids);
  auto* o = static_cast<V*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      R % 4 == 0
          ? launch_smem<true>(p, id, o, F, R, N, chunk, acc_rows, merge_min, threads, grid, s)
          : launch_smem<false>(p, id, o, F, R, N, chunk, acc_rows, merge_min, threads, grid, s);
  return static_cast<int>(err);
}

}  // namespace

// The shared-memory kernel.  chunk channels per grid row y (grid y =
// ceil(F / chunk)), acc_rows >= chunk rounded up to kBatch, grid blocks
// per chunk, threads a multiple of 32 up to 1024, merge_min 2..33 (33:
// never merge).  out must be zeroed: it takes one global atomic per
// nonzero accumulator entry and block.
extern "C" int thallo_oh_setup_aggregate_smem(const void* parts, const void* ids, void* out,
                                              int F, int R, int N, int chunk, int acc_rows,
                                              int merge_min, int threads, int grid,
                                              void* stream) {
  return aggregate_smem<float>(parts, ids, out, F, R, N, chunk, acc_rows, merge_min, threads,
                               grid, stream);
}

// The same in f64: parts and out double.
extern "C" int thallo_oh_setup_aggregate_smem_f64(const void* parts, const void* ids, void* out,
                                                  int F, int R, int N, int chunk, int acc_rows,
                                                  int merge_min, int threads, int grid,
                                                  void* stream) {
  return aggregate_smem<double>(parts, ids, out, F, R, N, chunk, acc_rows, merge_min, threads,
                                grid, stream);
}

extern "C" int thallo_oh_setup_aggregate_atomics(const void* parts, const void* ids, void* out,
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
