// One-hot-row-mode setup products (replaces the Pallas kernel of
// thallo_tpu/ops/ohsetup.py::oh_setup_products, body `_products_kernel`).
// See thallo_tpu_torch/ops/ohsetup.py for the contract and the channel
// plans.  The kernels read rT [rc, R] and J [K, R] (R innermost) and drop
// observations whose id lies outside [0, N).  The bound is the input read,
// (rc + K + 1) * R * itemsize bytes; what costs beyond it is the sum by
// id: F*R additions (99 M at BA-1M) onto F*N addresses (101 k), half of
// them onto one camera's 99 addresses on the degree-skewed scene.  Every
// product is a channel sum_c X[a0 + c*sa] * X[b0 + c*sb] over the stacked
// inputs X = [rT; J] (a symmetric pair block keeps only a <= b: 63
// channels instead of 99 for BA's camera slot).
//
// oh_products_range_kernel<V>  (thallo_oh_setup_products_ranges[_f64]; the
//   f32 and f64 routes)
//   Grid y = camera range x chunk of up to 64 channels: a block owns the
//   [span, stride] accumulator of one range of cameras (stride odd; BA 1M:
//   4 ranges of 256 in f64, 2 of 512 in f32) for all the chunk's channels.
//   A fixed grid of blocks per range strides over tiles of 32
//   observations, a warp per tile.  Lane = observation: the lanes whose
//   id lies in the block's range copy their rc + K inputs into the warp's
//   [rc + K, 33] stage and are grouped by id (__match_any_sync).  Then
//   lane = channel pair (channels j and j + 32): one sum per distinct id,
//   in registers over the id's observations, added once into the
//   accumulator, each shared atomic instruction's 32 lanes on 32
//   neighbouring addresses; two ids at a time, their first members'
//   products issued together.  Each observation is walked by one block
//   with every lane busy.  What it replaced (oh_products_persistent_kernel,
//   below) walked every tile once per chunk of channels, 4 times in f64 at
//   BA 1M, half its lanes idle; the time left is the shared additions
//   themselves (63 M, each a compare-and-swap loop, ATOMS.CAST.SPIN[.64],
//   at about one lane a clock per SM: ~0.23 ms in f64).  Measured on the
//   H100 and not kept (scripts/torch_redesign_sweep.py --only oh_f64):
//   designs without shared atomics, where a warp owns channels (lane =
//   observation) or cameras (lane = channel) of a block's staged
//   256-observation tiles: slower (PERF.md, Findings).  The
//   accumulator is zeroed once per block and flushed once, with plain
//   stores, into its range's columns of a [G, channels, N] slab;
//   slab_sum_kernel sums the slabs in a fixed order into out and the
//   mirror rows.
//
// oh_products_persistent_kernel<V>  (thallo_oh_setup_products_persistent
//   [_f64]: the route before the range kernel, kept for measurement)
//   A fixed grid of blocks per chunk of at most 32 channels (grid y)
//   strides over tiles of 32 observations, a warp per tile, staged and
//   grouped as above; lane = channel: for each distinct id of the tile
//   the lanes sum their channel and add once into the block's [N, stride]
//   accumulator, flushed into a slab as above.  (Measured on the H100 and
//   not kept, ops/ohsetup.py has their numbers: a flush by one global
//   atomic per nonzero entry, and the chunks spread over a thread block
//   cluster's shared memory, so that each tile is staged once.)
//
// oh_setup_products_kernel<V>  (thallo_oh_setup_products[_f64], the first
//   body)
//   One thread per observation forms each slab value from its rc + K
//   inputs and adds it into out[f, id] with a global atomic (native for
//   doubles on sm_90).  Any N: it takes the shapes without a range plan.
//
// recipe (first body): n_entries rows of 6 int32 (kind, offa, Ca, offb, Cb, f0):
//   kind 0 jtr   out[f0+ch]       += sum_c J[offa + c*Ca + ch] * r[c]
//   kind 1 d2    out[f0+ch]       += sum_c J[offa + c*Ca + ch]^2
//   kind 2 pair  out[f0 + a*Cb+b] += sum_c J[offa + c*Ca + a] * J[offb + c*Cb + b]
//
// Every kernel is templated on the value type V of every operand, stage
// and accumulator: float, or double under the solver's double_precision
// (shared memory per value doubles, so the plans take fewer threads and
// smaller ranges or chunks for it).
//
// The first body's caller zeroes out; the kernels allocate nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "block_accum.cuh"  // kFull, fma_v

namespace {

template <typename V>
__global__ void oh_setup_products_kernel(const V* __restrict__ rT, const V* __restrict__ J,
                                         const int* __restrict__ ids,
                                         const int* __restrict__ recipe, V* __restrict__ out,
                                         int n_entries, int rc, int R, int N) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int id = ids[r];
  if (id < 0 || id >= N) return;
  const size_t Rz = static_cast<size_t>(R);
  const size_t Nz = static_cast<size_t>(N);
  const V* Jr = J + r;
  const V* rr = rT + r;

  for (int e = 0; e < n_entries; ++e) {
    const int kind = __ldg(recipe + 6 * e + 0);
    const int offa = __ldg(recipe + 6 * e + 1);
    const int Ca = __ldg(recipe + 6 * e + 2);
    const int offb = __ldg(recipe + 6 * e + 3);
    const int Cb = __ldg(recipe + 6 * e + 4);
    const int f0 = __ldg(recipe + 6 * e + 5);
    if (kind == 0 || kind == 1) {
      for (int ch = 0; ch < Ca; ++ch) {
        V s = V(0);
        for (int c = 0; c < rc; ++c) {
          const V j = __ldg(Jr + static_cast<size_t>(offa + c * Ca + ch) * Rz);
          s = fma_v(j, kind == 0 ? __ldg(rr + c * Rz) : j, s);
        }
        atomicAdd(out + static_cast<size_t>(f0 + ch) * Nz + id, s);
      }
    } else {
      for (int a = 0; a < Ca; ++a) {
        for (int b = 0; b < Cb; ++b) {
          V s = V(0);
          for (int c = 0; c < rc; ++c) {
            s = fma_v(__ldg(Jr + static_cast<size_t>(offa + c * Ca + a) * Rz),
                      __ldg(Jr + static_cast<size_t>(offb + c * Cb + b) * Rz), s);
          }
          atomicAdd(out + static_cast<size_t>(f0 + a * Cb + b) * Nz + id, s);
        }
      }
    }
  }
}

constexpr int kMaxThreads = 1024;
constexpr int kStageLd = 33;  // a warp's stage row: 32 observations + 1 (no bank conflicts)

// The minimum of 1 block per SM lets ptxas use up to 64 registers: without
// it the template's instances were compiled to 32 and ran 14% slower (f32
// at BA-1M: 0.2352 ms against 0.2025 with it; the non-template kernel it
// replaces had 59: scripts/torch_kernels_ab.py, H100)
template <typename V>
__global__ void __launch_bounds__(kMaxThreads, 1)
    oh_products_persistent_kernel(const V* __restrict__ rT, const V* __restrict__ J,
                                  const int4* __restrict__ chan, const int* __restrict__ ids,
                                  V* __restrict__ slab, int n_ch, int chunk, int stride,
                                  int rc, int K, int R, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* smem = reinterpret_cast<V*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int ch0 = blockIdx.y * chunk;
  const int cc = min(chunk, n_ch - ch0);
  const int RK = rc + K;
  V* acc = smem;                                                // [N, stride]
  V* st = smem + static_cast<size_t>(N) * stride + warp * RK * kStageLd;  // [RK, 33]
  const size_t n_acc = static_cast<size_t>(N) * stride;
  for (size_t i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = V(0);
  __syncthreads();

  // lane j forms channel ch0 + j: the stage offsets of its two operands
  int a = 0, sa = 0, b = 0, sb = 0;
  if (lane < cc) {
    const int4 e = chan[ch0 + lane];
    a = e.x * kStageLd;
    sa = e.y * kStageLd;
    b = e.z * kStageLd;
    sb = e.w * kStageLd;
  }
  const size_t Rz = static_cast<size_t>(R);
  const int n_tiles = (R + 31) / 32;
  // leaders, members, o and gid are the same for every lane of the warp
  for (int tile = blockIdx.x * warps + warp; tile < n_tiles; tile += gridDim.x * warps) {
    // lane = observation: stage its rc + K inputs, group equal ids
    const int r = tile * 32 + lane;
    const int id = r < R ? __ldg(ids + r) : -1;
    const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(N);
    if (ok) {
      for (int k = 0; k < rc; ++k) st[k * kStageLd + lane] = rT[k * Rz + r];
      for (int k = 0; k < K; ++k) st[(rc + k) * kStageLd + lane] = J[k * Rz + r];
    }
    const unsigned peers = __match_any_sync(kFull, ok ? id : -1 - lane);
    unsigned leaders = __ballot_sync(kFull, ok && (peers & ((1u << lane) - 1u)) == 0u);
    __syncwarp();
    // lane = channel: one sum per distinct id of the tile, one shared
    // atomic per (id, channel), conflict-free (stride is odd)
    while (leaders != 0u) {
      const int o = __ffs(leaders) - 1;
      leaders &= leaders - 1u;
      unsigned members = __shfl_sync(kFull, peers, o);
      const int gid = __shfl_sync(kFull, id, o);
      V v = V(0);
      while (members != 0u) {
        const int m = __ffs(members) - 1;
        members &= members - 1u;
        for (int c = 0; c < rc; ++c) v = fma_v(st[a + c * sa + m], st[b + c * sb + m], v);
      }
      if (lane < cc) atomicAdd(acc + static_cast<size_t>(gid) * stride + lane, v);
    }
    __syncwarp();
  }

  __syncthreads();
  // the accumulator by (channel, n), n fastest: conflict-free reads
  for (size_t i = threadIdx.x; i < static_cast<size_t>(cc) * N; i += blockDim.x) {
    const int j = static_cast<int>(i / N);
    const size_t n = i - static_cast<size_t>(j) * N;
    slab[(static_cast<size_t>(blockIdx.x) * n_ch + ch0) * N + i] = acc[n * stride + j];
  }
}

// The range kernel (oh_products_range_kernel; see the note at the top).
// Grid y = camera range x channel chunk of up to 64; lane j forms channels
// ch0 + j and ch0 + 32 + j of the chunk.
constexpr int kRangeChunk = 64;

template <typename V>
__global__ void __launch_bounds__(kMaxThreads * sizeof(float) / sizeof(V), 1)
    oh_products_range_kernel(const V* __restrict__ rT, const V* __restrict__ J,
                             const int4* __restrict__ chan, const int* __restrict__ ids,
                             V* __restrict__ slab, int n_ch, int n_chunks, int stride, int span,
                             int rc, int K, int R, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* smem = reinterpret_cast<V*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int q = blockIdx.y / n_chunks;
  const int ch0 = (blockIdx.y - q * n_chunks) * kRangeChunk;
  const int cc = min(kRangeChunk, n_ch - ch0);
  const int lo = q * span;            // the block's cameras: [lo, lo + nb)
  const int nb = max(0, min(span, N - lo));
  const int RK = rc + K;
  V* acc = smem;                                                            // [span, stride]
  V* st = smem + static_cast<size_t>(span) * stride + warp * RK * kStageLd;  // [RK, 33]
  const size_t n_acc = static_cast<size_t>(span) * stride;
  for (size_t i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = V(0);
  __syncthreads();

  // the stage offsets of the lane's two channels (0 where it has none)
  int a0 = 0, sa0 = 0, b0 = 0, sb0 = 0, a1 = 0, sa1 = 0, b1 = 0, sb1 = 0;
  if (lane < cc) {
    const int4 e = chan[ch0 + lane];
    a0 = e.x * kStageLd;
    sa0 = e.y * kStageLd;
    b0 = e.z * kStageLd;
    sb0 = e.w * kStageLd;
  }
  if (lane + 32 < cc) {
    const int4 e = chan[ch0 + 32 + lane];
    a1 = e.x * kStageLd;
    sa1 = e.y * kStageLd;
    b1 = e.z * kStageLd;
    sb1 = e.w * kStageLd;
  }
  const size_t Rz = static_cast<size_t>(R);
  const int n_tiles = (R + 31) / 32;
  // leaders, members, o and gid are the same for every lane of the warp
  for (int tile = blockIdx.x * warps + warp; tile < n_tiles; tile += gridDim.x * warps) {
    // lane = observation: stage the inputs of an observation of the
    // block's range, group equal ids
    const int r = tile * 32 + lane;
    const int id = r < R ? __ldg(ids + r) : -1;
    const bool ok = static_cast<unsigned>(id - lo) < static_cast<unsigned>(nb);
    if (ok) {
      for (int k = 0; k < rc; ++k) st[k * kStageLd + lane] = rT[k * Rz + r];
      for (int k = 0; k < K; ++k) st[(rc + k) * kStageLd + lane] = J[k * Rz + r];
    }
    const unsigned peers = __match_any_sync(kFull, ok ? id : -1 - lane);
    unsigned leaders = __ballot_sync(kFull, ok && (peers & ((1u << lane) - 1u)) == 0u);
    __syncwarp();
    // lane = channel pair: one sum per distinct id, two shared atomics a
    // lane, each instruction's 32 on 32 neighbouring addresses; two ids at
    // a time, their first members' products issued together
    while (leaders != 0u) {
      const int o = __ffs(leaders) - 1;
      leaders &= leaders - 1u;
      const bool two = leaders != 0u;
      const int p = two ? __ffs(leaders) - 1 : o;
      if (two) leaders &= leaders - 1u;
      unsigned mem_o = __shfl_sync(kFull, peers, o);
      unsigned mem_p = __shfl_sync(kFull, peers, p);
      const int gid_o = __shfl_sync(kFull, id, o) - lo;
      const int gid_p = __shfl_sync(kFull, id, p) - lo;
      mem_o &= mem_o - 1u;  // o and p are their groups' first members
      mem_p = two ? mem_p & (mem_p - 1u) : 0u;
      V v0 = V(0), v1 = V(0), u0 = V(0), u1 = V(0);
      for (int c = 0; c < rc; ++c) {
        v0 = fma_v(st[a0 + c * sa0 + o], st[b0 + c * sb0 + o], v0);
        v1 = fma_v(st[a1 + c * sa1 + o], st[b1 + c * sb1 + o], v1);
        u0 = fma_v(st[a0 + c * sa0 + p], st[b0 + c * sb0 + p], u0);
        u1 = fma_v(st[a1 + c * sa1 + p], st[b1 + c * sb1 + p], u1);
      }
      while ((mem_o | mem_p) != 0u) {  // the groups' other members (a hot id)
        if (mem_o != 0u) {
          const int m = __ffs(mem_o) - 1;
          mem_o &= mem_o - 1u;
          for (int c = 0; c < rc; ++c) {
            v0 = fma_v(st[a0 + c * sa0 + m], st[b0 + c * sb0 + m], v0);
            v1 = fma_v(st[a1 + c * sa1 + m], st[b1 + c * sb1 + m], v1);
          }
        }
        if (mem_p != 0u) {
          const int m = __ffs(mem_p) - 1;
          mem_p &= mem_p - 1u;
          for (int c = 0; c < rc; ++c) {
            u0 = fma_v(st[a0 + c * sa0 + m], st[b0 + c * sb0 + m], u0);
            u1 = fma_v(st[a1 + c * sa1 + m], st[b1 + c * sb1 + m], u1);
          }
        }
      }
      V* row = acc + static_cast<size_t>(gid_o) * stride;
      if (lane < cc) atomicAdd(row + lane, v0);
      if (lane + 32 < cc) atomicAdd(row + 32 + lane, v1);
      if (two) {
        row = acc + static_cast<size_t>(gid_p) * stride;
        if (lane < cc) atomicAdd(row + lane, u0);
        if (lane + 32 < cc) atomicAdd(row + 32 + lane, u1);
      }
    }
    __syncwarp();
  }

  __syncthreads();
  // the block's cameras of its slab row (n fastest: conflict-free, the
  // stride odd)
  for (size_t i = threadIdx.x; i < static_cast<size_t>(cc) * nb; i += blockDim.x) {
    const int j = static_cast<int>(i / nb);
    const size_t n = i - static_cast<size_t>(j) * nb;
    slab[(static_cast<size_t>(blockIdx.x) * n_ch + ch0 + j) * N + lo + n] =
        acc[n * stride + j];
  }
}

constexpr int kSlabCols = 32;   // columns per block of slab_sum_kernel
constexpr int kSlabSlices = 8;  // partials each column's sum is split over

// out[dest[r][0]][n] (and out[dest[r][1]][n] where that mirror row is not
// -1) = sum_g part[g][r][n] for part [G, rows, N], g ascending within each
// of kSlabSlices slices and the slices in order: the same bits every run.
template <typename V>
__global__ void __launch_bounds__(kSlabCols * kSlabSlices)
    slab_sum_kernel(const V* __restrict__ part, int G, int rows, int N,
                    const int* __restrict__ dest, V* __restrict__ out) {
  __shared__ V red[kSlabSlices][kSlabCols + 1];
  const size_t M = static_cast<size_t>(rows) * N;
  const size_t m = static_cast<size_t>(blockIdx.x) * kSlabCols + threadIdx.x;
  V s = V(0);
  if (m < M) {
    for (int g = threadIdx.y; g < G; g += kSlabSlices) s += __ldcs(part + g * M + m);
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || m >= M) return;
  V t = red[0][threadIdx.x];
#pragma unroll
  for (int k = 1; k < kSlabSlices; ++k) t += red[k][threadIdx.x];
  const int r = static_cast<int>(m / N);
  const size_t n = m - static_cast<size_t>(r) * N;
  out[static_cast<size_t>(__ldg(dest + 2 * r)) * N + n] = t;
  const int mirror = __ldg(dest + 2 * r + 1);
  if (mirror >= 0) out[static_cast<size_t>(mirror) * N + n] = t;
}

template <typename V>
cudaError_t launch_slab_sum(const V* part, int G, int rows, int N, const int* dest, V* out,
                            cudaStream_t stream) {
  const size_t M = static_cast<size_t>(rows) * N;
  if (M == 0) return cudaGetLastError();
  const unsigned grid = static_cast<unsigned>((M + kSlabCols - 1) / kSlabCols);
  slab_sum_kernel<V><<<grid, dim3(kSlabCols, kSlabSlices), 0, stream>>>(part, G, rows, N, dest,
                                                                         out);
  return cudaGetLastError();
}

template <typename V>
int launch_products(const void* rT, const void* Jall, const void* ids, const void* chan,
                    const void* dest, void* out, void* slab, int n_ch, int chunk, int stride,
                    int rc, int K, int R, int N, int threads, int grid, void* stream) {
  if (n_ch < 1 || chunk < 1 || chunk > 32 || stride < chunk || stride % 2 == 0 || rc < 1 ||
      K < 1 || R < 0 || N < 1 || grid < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || slab == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(N) * stride +
                       static_cast<size_t>(threads / 32) * (rc + K) * kStageLd) * sizeof(V);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(oh_products_persistent_kernel<V>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto s = static_cast<cudaStream_t>(stream);
  oh_products_persistent_kernel<V><<<dim3(grid, (n_ch + chunk - 1) / chunk), threads, smem, s>>>(
      static_cast<const V*>(rT), static_cast<const V*>(Jall), static_cast<const int4*>(chan),
      static_cast<const int*>(ids), static_cast<V*>(slab), n_ch, chunk, stride, rc, K, R, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_slab_sum(static_cast<const V*>(slab), grid, n_ch, N,
                                          static_cast<const int*>(dest), static_cast<V*>(out),
                                          s));
}

template <typename V>
int launch_products_ranges(const void* rT, const void* Jall, const void* ids, const void* chan,
                           const void* dest, void* out, void* slab, int n_ch, int stride,
                           int span, int rc, int K, int R, int N, int threads, int grid,
                           void* stream) {
  const int n_chunks = (n_ch + kRangeChunk - 1) / kRangeChunk;
  const int n_ranges = span >= 1 ? (N + span - 1) / span : 0;
  if (n_ch < 1 || span < 1 || stride < std::min(n_ch, kRangeChunk) || stride % 2 == 0 ||
      rc < 1 || K < 1 || R < 0 || N < 1 || grid < 1 || threads < 32 ||
      threads > static_cast<int>(kMaxThreads * sizeof(float) / sizeof(V)) ||
      threads % 32 != 0 || slab == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(span) * stride +
                       static_cast<size_t>(threads / 32) * (rc + K) * kStageLd) * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(oh_products_range_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  oh_products_range_kernel<V><<<dim3(grid, n_ranges * n_chunks), threads, smem, s>>>(
      static_cast<const V*>(rT), static_cast<const V*>(Jall), static_cast<const int4*>(chan),
      static_cast<const int*>(ids), static_cast<V*>(slab), n_ch, n_chunks, stride, span, rc, K,
      R, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_slab_sum(static_cast<const V*>(slab), grid, n_ch, N,
                                          static_cast<const int*>(dest), static_cast<V*>(out),
                                          s));
}

template <typename V>
int launch_products_first(const void* rT, const void* Jall, const void* ids, const void* recipe,
                          void* out, int n_entries, int rc, int R, int N, void* stream) {
  if (R > 0) {
    constexpr int kThreads = 256;
    const int grid = (R + kThreads - 1) / kThreads;
    oh_setup_products_kernel<V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(rT), static_cast<const V*>(Jall), static_cast<const int*>(ids),
        static_cast<const int*>(recipe), static_cast<V*>(out), n_entries, rc, R, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shared-memory kernel.  chan [n_ch, 4] int32 (a0, sa, b0, sb: rows of
// the stacked [rT; J]), dest [n_ch, 2] int32 (output row, mirror row or
// -1); chunk <= 32 channels per block (grid y = ceil(n_ch / chunk)), an
// odd stride >= chunk for the [N, stride] accumulator; grid: blocks per
// chunk (a slab has one row per block); threads: a multiple of 32; slab
// [grid, n_ch, N] scratch.  out [F, N] is written whole by
// slab_sum_kernel.
extern "C" int thallo_oh_setup_products_persistent(const void* rT, const void* Jall,
                                                   const void* ids, const void* chan,
                                                   const void* dest, void* out, void* slab,
                                                   int n_ch, int chunk, int stride, int rc, int K,
                                                   int R, int N, int threads, int grid,
                                                   void* stream) {
  return launch_products<float>(rT, Jall, ids, chan, dest, out, slab, n_ch, chunk, stride, rc,
                                K, R, N, threads, grid, stream);
}

// The same in f64: rT, Jall, slab and out double.
extern "C" int thallo_oh_setup_products_persistent_f64(const void* rT, const void* Jall,
                                                       const void* ids, const void* chan,
                                                       const void* dest, void* out, void* slab,
                                                       int n_ch, int chunk, int stride, int rc,
                                                       int K, int R, int N, int threads, int grid,
                                                       void* stream) {
  return launch_products<double>(rT, Jall, ids, chan, dest, out, slab, n_ch, chunk, stride, rc,
                                 K, R, N, threads, grid, stream);
}

// The range kernel.  chan, dest and slab as above (slab [grid,
// n_ch, N]: a block writes its range's columns of its row); span cameras a
// range (grid y = ceil(N / span) x ceil(n_ch / 64)), an odd stride >=
// min(n_ch, 64) for the [span, stride] accumulator; threads: a multiple of
// 32 (at most 1024, 512 in f64); grid: blocks per range and chunk.  out
// [F, N] is written whole by slab_sum_kernel.
extern "C" int thallo_oh_setup_products_ranges(const void* rT, const void* Jall, const void* ids,
                                               const void* chan, const void* dest, void* out,
                                               void* slab, int n_ch, int stride, int span, int rc,
                                               int K, int R, int N, int threads, int grid,
                                               void* stream) {
  return launch_products_ranges<float>(rT, Jall, ids, chan, dest, out, slab, n_ch, stride, span,
                                       rc, K, R, N, threads, grid, stream);
}

// The same in f64: rT, Jall, slab and out double.
extern "C" int thallo_oh_setup_products_ranges_f64(const void* rT, const void* Jall,
                                                   const void* ids, const void* chan,
                                                   const void* dest, void* out, void* slab,
                                                   int n_ch, int stride, int span, int rc, int K,
                                                   int R, int N, int threads, int grid,
                                                   void* stream) {
  return launch_products_ranges<double>(rT, Jall, ids, chan, dest, out, slab, n_ch, stride,
                                        span, rc, K, R, N, threads, grid, stream);
}

extern "C" int thallo_oh_setup_products(const void* rT, const void* Jall,
                                        const void* ids, const void* recipe,
                                        void* out, int n_entries, int rc, int R,
                                        int N, void* stream) {
  return launch_products_first<float>(rT, Jall, ids, recipe, out, n_entries, rc, R, N, stream);
}

// The first body in f64 (rT, Jall and out double; out zeroed by the
// caller): global atomicAdd on doubles is native on sm_90.
extern "C" int thallo_oh_setup_products_f64(const void* rT, const void* Jall, const void* ids,
                                            const void* recipe, void* out, int n_entries, int rc,
                                            int R, int N, void* stream) {
  return launch_products_first<double>(rT, Jall, ids, recipe, out, n_entries, rc, R, N, stream);
}
