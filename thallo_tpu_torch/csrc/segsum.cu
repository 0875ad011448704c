// Segment sum over runs sorted by destination (replaces the Pallas kernel
// of thallo_tpu/ops/segsum.py::pallas_segment_sum).  See
// thallo_tpu_torch/ops/segsum.py for the contract and the plan:
//   out[s, c] = sum over e in [start[s], start[s+1]) of data[order[e], c]
//
// The TPU kernel contracts a one-hot of each destination tile on the
// matrix unit.  On this card the sum is bound by bytes (4 per lane of
// `order`, the gathered rows once, `out` once), and the plan's lanes are
// sorted by destination, so each output row is the sum of one contiguous
// run: no atomic, no shared accumulator, no zeroed output, and a fixed
// order of additions (the same bits from run to run).  Two kernels, one
// signature; the plan picks per level:
//
//   run_sum_thread  one thread per (run, channel) walks its run.  For
//                   short runs (a point's few observations): neighbouring
//                   threads write neighbouring outputs, and with sorted
//                   ids `order` is nearly the identity, so the gather is
//                   nearly sequential.
//   run_sum_warp    one warp per (run, channel chunk): lane l takes lanes
//                   l, l+32, ... of the run, kCh channel sums in
//                   registers, then an xor-shuffle tree.  For long runs
//                   (a camera's ~1000 observations); kCh divides C, so no
//                   channel is guarded (9, 4, 3 or 1).
//
// A plan with runs too long for one warp cuts them into pieces: level 1
// sums each piece into scratch [P, C] (runs = pieces), level 2 sums each
// segment's pieces (runs = segments over scratch, order = identity) by
// the same kernels.  An empty run writes 0.  data is read through its
// element strides (sm, sc); the unit row stride of a transposed
// channel-major buffer is a specialisation (no 64-bit multiply per
// gather).
//
// Long runs over channel-major data (sm = 1: the solver's [C, M] buffers)
// are the one case where the sorted gather wastes the card: a run's rows
// lie ~M/S apart, so each 4-byte value costs a 32-byte sector (1M x 9
// values: 288 MB through L2 for 36 MB used).  thallo_segment_sum_staged
// reads such data in row order instead: block (k, channel chunk) copies
// rows [k*T, (k+1)*T) of its channels into shared memory with coalesced
// loads, and its threads then sum, per (segment, channel), the chunk's
// rows of that segment from shared memory, through the chunk-local sorted
// order the plan keeps (`local`, CSR `cell_start` over (chunk, segment)
// cells; both staged in shared memory too, so the sums chase no pointer
// through L2).  The per-chunk sums land in scratch [S, K, C] and the warp
// kernel sums each segment's K rows of it.  Still no atomic and a fixed
// order of additions.
//
// The caller allocates out and scratch; nothing is zeroed.
//
// f64 (the solver's double_precision): every kernel is templated on the
// value type V of data, the sums, out and scratch (the *_f64 exports: V =
// double).  The staged tile holds doubles then, and the aligned copy
// loads 16 bytes a thread as double2.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // a multiple of 32: one warp per run below
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStagedThreads = 512;
// the staged kernel's shared memory: kCh channels of STAGED_ROWS rows, the
// cell offsets of STAGED_MAX_SEGMENTS segments and the lanes (ops/segsum.py)
constexpr int kMaxSmem = 200 * 1024;

// 16 bytes of V: one vector load
template <typename V>
struct Vec16;
template <>
struct Vec16<float> {
  using T = float4;
  static constexpr int kN = 4;
};
template <>
struct Vec16<double> {
  using T = double2;
  static constexpr int kN = 2;
};

template <typename V, bool kUnit>
__global__ void __launch_bounds__(kThreads)
    run_sum_thread_kernel(const V* __restrict__ data, long long sm, long long sc,
                          const int* __restrict__ order, const int* __restrict__ start,
                          V* __restrict__ out, int n_runs, int C) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_runs * C) return;
  const int r = i / C;
  const int c = i - r * C;
  const int a = __ldg(start + r);
  const int b = __ldg(start + r + 1);
  const V* col = data + c * sc;
  V acc = 0;
#pragma unroll 4
  for (int e = a; e < b; ++e) {
    const long long g = order ? __ldg(order + e) : e;
    acc += __ldg(col + (kUnit ? g : g * sm));
  }
  out[i] = acc;
}

template <typename V, int kCh, bool kUnit>
__global__ void __launch_bounds__(kThreads)
    run_sum_warp_kernel(const V* __restrict__ data, long long sm, long long sc,
                        const int* __restrict__ order, const int* __restrict__ start,
                        V* __restrict__ out, int n_runs, int C) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_runs) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * kCh;
  const int a = __ldg(start + r);
  const int b = __ldg(start + r + 1);
  const V* col = data + c0 * sc;
  V acc[kCh];
#pragma unroll
  for (int k = 0; k < kCh; ++k) acc[k] = 0;
#pragma unroll 2
  for (int e = a + lane; e < b; e += 32) {
    const long long g = order ? __ldg(order + e) : e;
    const V* row = col + (kUnit ? g : g * sm);
#pragma unroll
    for (int k = 0; k < kCh; ++k) acc[k] += __ldg(row + k * sc);
  }
  V mine = 0;
#pragma unroll
  for (int k = 0; k < kCh; ++k) {
    V v = acc[k];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    if (lane == k) mine = v;
  }
  if (lane < kCh) out[static_cast<size_t>(r) * C + c0 + lane] = mine;
}

// Block (k, channel chunk): rows [k*T, k*T + T) of kCh channels of
// channel-major data (row stride 1, channel stride sc), the chunk's cell
// offsets and its lanes' local rows into shared memory, all by coalesced
// loads; then partial[s, k, c] = the sum of the chunk's rows of segment s,
// from shared memory alone.
template <typename V, int kCh>
__global__ void __launch_bounds__(kStagedThreads)
    staged_sum_kernel(const V* __restrict__ data, long long sc,
                      const int* __restrict__ local, const int* __restrict__ cell_start,
                      V* __restrict__ partial, int M, int C, int S, int K, int T) {
  using Vec = typename Vec16<V>::T;
  constexpr int kN = Vec16<V>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* tile = reinterpret_cast<V*>(smem_raw);  // [kCh, T + 4]: rows of 16-byte multiples,
                                             // the stride spreads a row's channels over the banks
  const int stride = T + 4;
  int* cells = reinterpret_cast<int*>(tile + kCh * stride);  // [S + 1], from 0
  int* rows = cells + S + 1;                                 // [<= T]
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * kCh;
  const int r0 = k * T;
  const int n_rows = min(T, M - r0);
  // each thread first starts its loads of all kCh channels, then stores
  // them: kCh loads in flight per thread, of 16 bytes where a full chunk
  // is aligned (one value otherwise: the last chunk, an odd channel stride)
  const V* src = data + c0 * sc + r0;
  if (n_rows == T && T % kN == 0 && sc % kN == 0 &&
      reinterpret_cast<size_t>(src) % sizeof(Vec) == 0) {
    for (int j = kN * threadIdx.x; j < T; j += kN * kStagedThreads) {
      Vec v[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        v[c] = __ldg(reinterpret_cast<const Vec*>(src + c * sc + j));
      }
#pragma unroll
      for (int c = 0; c < kCh; ++c) *reinterpret_cast<Vec*>(tile + c * stride + j) = v[c];
    }
  } else {
    for (int j = threadIdx.x; j < n_rows; j += kStagedThreads) {
      V v[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) v[c] = __ldg(src + c * sc + j);
#pragma unroll
      for (int c = 0; c < kCh; ++c) tile[c * stride + j] = v[c];
    }
  }
  const int* chunk_cells = cell_start + static_cast<size_t>(k) * S;
  const int first = __ldg(chunk_cells);
  const int n_lanes = __ldg(chunk_cells + S) - first;  // <= T: a row has one lane
  for (int j = threadIdx.x; j <= S; j += kStagedThreads) {
    cells[j] = __ldg(chunk_cells + j) - first;
  }
  for (int j = threadIdx.x; j < n_lanes; j += kStagedThreads) {
    rows[j] = __ldg(local + first + j);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * kCh; i += kStagedThreads) {
    const int s = i / kCh;
    const int c = i - s * kCh;
    const V* col = tile + c * stride;
    V acc = 0;
    for (int e = cells[s]; e < cells[s + 1]; ++e) acc += col[rows[e]];
    partial[(static_cast<size_t>(s) * K + k) * C + c0 + c] = acc;
  }
}

template <typename V, int kCh>
cudaError_t launch_staged(const V* data, long long sc, const int* local, const int* cell_start,
                          V* partial, int M, int C, int S, int K, int T, cudaStream_t stream) {
  // the tile's rows of V, then the cell offsets and the lanes (4 bytes each)
  const size_t smem =
      static_cast<size_t>(kCh) * (T + 4) * sizeof(V) + (static_cast<size_t>(S) + 1 + T) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(staged_sum_kernel<V, kCh>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  staged_sum_kernel<V, kCh><<<dim3(K, C / kCh), kStagedThreads, smem, stream>>>(
      data, sc, local, cell_start, partial, M, C, S, K, T);
  return cudaGetLastError();
}

template <typename V, int kCh, bool kUnit>
void launch_warp(const V* data, long long sm, long long sc, const int* order, const int* start,
                 V* out, int n_runs, int C, cudaStream_t stream) {
  const dim3 grid((n_runs + kWarps - 1) / kWarps, C / kCh);
  run_sum_warp_kernel<V, kCh, kUnit><<<grid, kThreads, 0, stream>>>(data, sm, sc, order, start,
                                                                    out, n_runs, C);
}

// one level: out[r, :] = sum of the rows order[start[r] .. start[r+1])
template <typename V, bool kUnit>
void launch_level(int mode, const V* data, long long sm, long long sc, const int* order,
                  const int* start, V* out, int n_runs, int C, cudaStream_t stream) {
  if (mode == 0) {
    const int grid = (n_runs * C + kThreads - 1) / kThreads;
    run_sum_thread_kernel<V, kUnit><<<grid, kThreads, 0, stream>>>(data, sm, sc, order, start,
                                                                   out, n_runs, C);
  } else if (C % 9 == 0) {
    launch_warp<V, 9, kUnit>(data, sm, sc, order, start, out, n_runs, C, stream);
  } else if (C % 4 == 0) {
    launch_warp<V, 4, kUnit>(data, sm, sc, order, start, out, n_runs, C, stream);
  } else if (C % 3 == 0) {
    launch_warp<V, 3, kUnit>(data, sm, sc, order, start, out, n_runs, C, stream);
  } else {
    launch_warp<V, 1, kUnit>(data, sm, sc, order, start, out, n_runs, C, stream);
  }
}

// P == 0: one level over the S segments (start = seg_start).  P > 0: the
// P pieces (piece_start) into scratch [P, C], then the segments' pieces
// (seg_piece) from scratch into out.  mode1/mode2: 0 = thread, 1 = warp.
template <typename V>
int segment_sum(const void* data, long long sm, long long sc, const void* order,
                const void* seg_start, const void* piece_start, const void* seg_piece,
                void* scratch, void* out, int C, int S, int P, int mode1, int mode2,
                void* stream) {
  if (mode1 < 0 || mode1 > 1 || mode2 < 0 || mode2 > 1 || C < 0 || S < 0 || P < 0 ||
      C > 65535 || (P > 0 && !(piece_start && seg_piece && scratch))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S > 0 && C > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto d = static_cast<const V*>(data);
    auto ord = static_cast<const int*>(order);
    V* first_out = static_cast<V*>(P > 0 ? scratch : out);
    const int* first_start = static_cast<const int*>(P > 0 ? piece_start : seg_start);
    const int first_runs = P > 0 ? P : S;
    if (sm == 1) {
      launch_level<V, true>(mode1, d, sm, sc, ord, first_start, first_out, first_runs, C, s);
    } else {
      launch_level<V, false>(mode1, d, sm, sc, ord, first_start, first_out, first_runs, C, s);
    }
    if (P > 0) {
      launch_level<V, false>(mode2, static_cast<const V*>(scratch), C, 1, nullptr,
                             static_cast<const int*>(seg_piece), static_cast<V*>(out), S, C,
                             s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Channel-major data (row stride 1, channel stride sc) of M rows through
// shared memory: K chunks of T rows, `local` the chunk-local row of each
// lane sorted by (chunk, segment), cell_start [K*S + 1] its CSR offsets;
// scratch [S, K, C]; seg_chunks [S + 1] = s*K, the runs of level 2.
template <typename V>
int segment_sum_staged(const void* data, long long sc, const void* local,
                       const void* cell_start, const void* seg_chunks, void* scratch, void* out,
                       int M, int C, int S, int K, int T, void* stream) {
  if (M < 1 || C < 1 || C > 65535 || S < 1 || K < 1 || T < 32 ||
      static_cast<long long>(K - 1) * T >= M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const V*>(data);
  auto loc = static_cast<const int*>(local);
  auto cells = static_cast<const int*>(cell_start);
  auto part = static_cast<V*>(scratch);
  cudaError_t err;
  if (C % 9 == 0) {
    err = launch_staged<V, 9>(d, sc, loc, cells, part, M, C, S, K, T, s);
  } else if (C % 4 == 0) {
    err = launch_staged<V, 4>(d, sc, loc, cells, part, M, C, S, K, T, s);
  } else if (C % 3 == 0) {
    err = launch_staged<V, 3>(d, sc, loc, cells, part, M, C, S, K, T, s);
  } else {
    err = launch_staged<V, 1>(d, sc, loc, cells, part, M, C, S, K, T, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_level<V, false>(1, part, C, 1, nullptr, static_cast<const int*>(seg_chunks),
                         static_cast<V*>(out), S, C, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P == 0: one level over the S segments (start = seg_start).  P > 0: the
// P pieces (piece_start) into scratch [P, C], then the segments' pieces
// (seg_piece) from scratch into out.  mode1/mode2: 0 = thread, 1 = warp.
extern "C" int thallo_segment_sum(const void* data, long long sm, long long sc,
                                  const void* order, const void* seg_start,
                                  const void* piece_start, const void* seg_piece,
                                  void* scratch, void* out, int C, int S, int P, int mode1,
                                  int mode2, void* stream) {
  return segment_sum<float>(data, sm, sc, order, seg_start, piece_start, seg_piece, scratch,
                            out, C, S, P, mode1, mode2, stream);
}

// The same in f64: data, scratch and out double.
extern "C" int thallo_segment_sum_f64(const void* data, long long sm, long long sc,
                                      const void* order, const void* seg_start,
                                      const void* piece_start, const void* seg_piece,
                                      void* scratch, void* out, int C, int S, int P, int mode1,
                                      int mode2, void* stream) {
  return segment_sum<double>(data, sm, sc, order, seg_start, piece_start, seg_piece, scratch,
                             out, C, S, P, mode1, mode2, stream);
}

// Channel-major data through shared memory (segment_sum_staged above).
extern "C" int thallo_segment_sum_staged(const void* data, long long sc, const void* local,
                                         const void* cell_start, const void* seg_chunks,
                                         void* scratch, void* out, int M, int C, int S, int K,
                                         int T, void* stream) {
  return segment_sum_staged<float>(data, sc, local, cell_start, seg_chunks, scratch, out, M, C,
                                   S, K, T, stream);
}

// The same in f64: data, scratch and out double.
extern "C" int thallo_segment_sum_staged_f64(const void* data, long long sc, const void* local,
                                             const void* cell_start, const void* seg_chunks,
                                             void* scratch, void* out, int M, int C, int S,
                                             int K, int T, void* stream) {
  return segment_sum_staged<double>(data, sc, local, cell_start, seg_chunks, scratch, out, M,
                                    C, S, K, T, stream);
}
