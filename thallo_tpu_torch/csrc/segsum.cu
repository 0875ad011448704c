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
// thallo_segment_sum_staged is the first staged body: one block per chunk,
// the whole tile loaded before any sum (no copy overlaps a sum), and a
// scratch row per (segment, chunk).  At [1M, 9] -> 1024 in f64 that
// scratch (~489 chunks: 36 MB written and read again) is as large as the
// data, and a 2048-row tile of doubles (148 KB) leaves one block an SM
// that waits for its tile.  thallo_segment_sum_ring is the redesign for
// this card:
//
//   staged_ring_kernel<V, kCh, kSegs>  a persistent grid of G blocks of
//     kRingThreads, block g owning the contiguous chunks
//     [block_chunk[g], block_chunk[g + 1]).  Each chunk (its kCh channel
//     rows, its S + 1 cell offsets and its lanes) is copied by cp.async
//     into a ring of kStages buffers (3 in f32, 2 in f64), so the copy of
//     the next chunks runs while the block sums this one.  Thread t owns
//     segments t, t + kRingThreads, ... (kSegs of them) and keeps their
//     kCh sums in registers across the block's whole chunk range: one
//     scratch row per (segment, block), [S, G, C] (G ~ one block an SM)
//     instead of [S, K, C].  Each sum adds its lanes in (chunk, lane)
//     order, from 0, and the warp kernel sums each segment's G rows:
//     a fixed order, the same bits from run to run.
//
// The fixed-order plans (lower.fixed_order_plan: the small-image scatters,
// at most a few hundred thousand values into at most 1024 segments) take
// run_sum_staged_order_kernel<V, kCh, kTree>, one launch whatever their
// runs.  The thread kernel walks a run as a chain of dependent loads
// (order[e], then data[order[e]]), on one thread per (run, channel): at
// [2, 6 400] -> 256 that is 512 threads, two blocks of a 132-SM card, and
// a plan with runs beyond 32 lanes took two levels (two launches).  Here
// block b owns the runs [block_run[b], block_run[b + 1]) and so the
// contiguous sorted lanes [block_lane[b], block_lane[b + 1]) (the plan
// cuts about ORDER_LANES lanes a block, a run wholly in the block where
// it starts).  All its threads first copy the lanes' `order` entries and
// then the gathered values of its kCh channels into shared memory, every
// load issued before any sum (coalesced on `order`), in tiles of at most
// `tile` lanes; after a __syncthreads:
//   kTree false (in order)  thread t adds run block_run[b] + t from 0 in
//                           ascending lane (= data row) order: the
//                           additions and the order of the CPU's
//                           index_add_, so the same bits as the CPU
//   kTree true (sorted runs) the block's warps are split evenly over its
//                           runs (at most kWarps); a run's 32 x wpr
//                           threads stride over it, an xor-shuffle tree a
//                           warp, then its warps' sums in warp order
// Either order is fixed: the same bits from run to run.  A run longer than
// a tile carries its sums in registers from tile to tile, in order.
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
// the ring kernel: threads a block (one block an SM: its ring takes most
// of the SM's shared memory), segments a thread at most, and the SM's
// shared memory a block may take
constexpr int kRingThreads = 512;
constexpr int kRingMaxSegs = 4;
constexpr int kRingMaxSmem = 227 * 1024;

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

constexpr int kOrderThreads = 256;  // ops/segsum.py ORDER_THREADS
constexpr int kOrderWarps = kOrderThreads / 32;
constexpr int kOrderUnroll = 4;  // lanes a thread stages at once
constexpr int kOrderMaxTile = kOrderThreads * kOrderUnroll;  // ops/segsum.py ORDER_TILE

// Block (b, channel chunk) of a fixed-order plan (the comment above): the
// runs [block_run[b], block_run[b + 1]) (at most kOrderThreads in order,
// kOrderWarps as a tree), out[r, c0 .. c0 + kCh) for each.
template <typename V, int kCh, bool kTree>
__global__ void __launch_bounds__(kOrderThreads)
    run_sum_staged_order_kernel(const V* __restrict__ data, long long sm, long long sc,
                                const int* __restrict__ order, const int* __restrict__ start,
                                const int* __restrict__ block_run,
                                const int* __restrict__ block_lane, V* __restrict__ out, int C,
                                int tile) {
  extern __shared__ __align__(16) unsigned char order_smem[];
  V* vals = reinterpret_cast<V*>(order_smem);  // [kCh][tile]
  V* warp_sums = vals + kCh * tile;            // [kOrderWarps][kCh] (kTree)
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kCh;
  const int r0 = __ldg(block_run + b);
  const int n_runs = __ldg(block_run + b + 1) - r0;
  const int l0 = __ldg(block_lane + b);
  const int l1 = __ldg(block_lane + b + 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the run this thread adds, and its place among the run's threads
  const int wpr = kTree ? kOrderWarps / max(n_runs, 1) : 1;  // warps a run
  const int mine = kTree ? warp / wpr : tid;
  const int slot = kTree ? (warp - mine * wpr) * 32 + lane : 0;
  const int stride = kTree ? 32 * wpr : 1;
  const bool active = mine < n_runs;
  int a = 0, e_end = 0;
  if (active) {
    a = __ldg(start + r0 + mine);
    e_end = __ldg(start + r0 + mine + 1);
  }
  V acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = V(0);
  const V* col = data + c0 * sc;
  int e = a + slot;  // the next lane this thread adds
  for (int tb = l0; tb < l1; tb += tile) {
    const int n = min(tile, l1 - tb);
    if (tb != l0) __syncthreads();  // the last tile's sums are done
    int g[kOrderUnroll];
#pragma unroll
    for (int u = 0; u < kOrderUnroll; ++u) {
      const int j = u * kOrderThreads + tid;
      g[u] = j < n ? __ldg(order + tb + j) : 0;
    }
    V v[kOrderUnroll][kCh];
#pragma unroll
    for (int u = 0; u < kOrderUnroll; ++u) {
      const bool live = u * kOrderThreads + tid < n;
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        v[u][c] = live ? __ldg(col + g[u] * sm + c * sc) : V(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kOrderUnroll; ++u) {
      const int j = u * kOrderThreads + tid;
      if (j < n) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) vals[c * tile + j] = v[u][c];
      }
    }
    __syncthreads();
    const int stop = min(e_end, tb + n);
    for (; e < stop; e += stride) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) acc[c] += vals[c * tile + (e - tb)];
    }
  }
  if (!kTree) {
    if (active) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) out[static_cast<size_t>(r0 + mine) * C + c0 + c] = acc[c];
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc[c] += __shfl_xor_sync(kFull, acc[c], d);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) warp_sums[warp * kCh + c] = acc[c];
  }
  __syncthreads();
  // thread (run, channel) adds its run's warps in warp order
  if (tid < n_runs * kCh) {
    const int r = tid / kCh;
    const int c = tid - r * kCh;
    V sum = 0;
    for (int q = 0; q < wpr; ++q) sum += warp_sums[(r * wpr + q) * kCh + c];
    out[static_cast<size_t>(r0 + r) * C + c0 + c] = sum;
  }
}

template <typename V, int kCh, bool kTree>
void launch_staged_order(const V* data, long long sm, long long sc, const int* order,
                         const int* start, const int* block_run, const int* block_lane, V* out,
                         int C, int G, int tile, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kCh) * tile + static_cast<size_t>(kOrderWarps) * kCh) * sizeof(V);
  run_sum_staged_order_kernel<V, kCh, kTree>
      <<<dim3(G, C / kCh), kOrderThreads, smem, stream>>>(data, sm, sc, order, start, block_run,
                                                          block_lane, out, C, tile);
}

template <typename V, bool kTree>
void launch_staged_order_ch(const V* data, long long sm, long long sc, const int* order,
                            const int* start, const int* block_run, const int* block_lane,
                            V* out, int C, int G, int tile, cudaStream_t stream) {
  if (C % 4 == 0) {
    launch_staged_order<V, 4, kTree>(data, sm, sc, order, start, block_run, block_lane, out, C,
                                     G, tile, stream);
  } else if (C % 3 == 0) {
    launch_staged_order<V, 3, kTree>(data, sm, sc, order, start, block_run, block_lane, out, C,
                                     G, tile, stream);
  } else if (C % 2 == 0) {
    launch_staged_order<V, 2, kTree>(data, sm, sc, order, start, block_run, block_lane, out, C,
                                     G, tile, stream);
  } else {
    launch_staged_order<V, 1, kTree>(data, sm, sc, order, start, block_run, block_lane, out, C,
                                     G, tile, stream);
  }
}

// The fixed-order form: G blocks (block_run, block_lane [G + 1]), lanes
// staged `tile` at a time (1 .. kOrderMaxTile), tree: sorted runs (else
// in order, one thread a run).
template <typename V>
int segment_sum_staged_order(const void* data, long long sm, long long sc, const void* order,
                             const void* seg_start, const void* block_run,
                             const void* block_lane, void* out, int C, int G, int tile,
                             int tree, void* stream) {
  if (C < 1 || C > 65535 || G < 0 || tile < 1 || tile > kOrderMaxTile || tree < 0 ||
      tree > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto d = static_cast<const V*>(data);
    auto ord = static_cast<const int*>(order);
    auto st = static_cast<const int*>(seg_start);
    auto br = static_cast<const int*>(block_run);
    auto bl = static_cast<const int*>(block_lane);
    auto o = static_cast<V*>(out);
    if (tree) {
      launch_staged_order_ch<V, true>(d, sm, sc, ord, st, br, bl, o, C, G, tile, s);
    } else {
      launch_staged_order_ch<V, false>(d, sm, sc, ord, st, br, bl, o, C, G, tile, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
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

// ring stages: three in f32, two in f64 (a stage of 1024 rows of 9
// channels is 37 KB of floats, 74 KB of doubles)
template <typename V>
struct RingStages {
  static constexpr int kN = sizeof(V) == 8 ? 2 : 3;
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage n ints from src (4-byte aligned) into dst (16-byte aligned, room
// for n + 3): 16-byte copies where src is 16-byte aligned, 4-byte ones at
// the ends; src[0] lands at dst[int_shift(src)].
__device__ __forceinline__ int int_shift(const int* src) {
  return static_cast<int>(reinterpret_cast<size_t>(src) >> 2 & 3);
}

template <int kBlock>
__device__ __forceinline__ void stage_ints(int* dst, const int* src, int n) {
  const int shift = int_shift(src);
  const int head = min(n, (4 - shift) & 3);
  const int n_vec = (n - head) >> 2;
  const int tail = head + 4 * n_vec;
  for (int j = threadIdx.x; j < n_vec; j += kBlock) {
    cp_async(dst + shift + head + 4 * j, src + head + 4 * j, 16);
  }
  const int t = threadIdx.x;
  if (t < head) cp_async(dst + shift + t, src + t, 4);
  if (t < n - tail) cp_async(dst + shift + tail + t, src + tail + t, 4);
}

// shared memory of the ring kernel: kStages x (kCh tile rows of T + 4
// values, cell_room(S) cell offsets, T + 4 lanes: room for the staging
// shifts, in 16-byte multiples),
// then the first lane of each chunk of the block's range and the end
// (span + 1 offsets); the tiles' room also holds the block's [S, kCh]
// sums at the end
template <typename V, int kCh>
__host__ __device__ __forceinline__ size_t ring_tiles(int S, int T) {
  constexpr int kStages = RingStages<V>::kN;
  const size_t tiles = static_cast<size_t>(kStages) * kCh * (T + 4) * sizeof(V);
  const size_t sums = static_cast<size_t>(S) * kCh * sizeof(V);
  return (tiles > sums ? tiles : sums + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int cell_room(int S) { return (S + 7) & ~3; }

template <typename V, int kCh>
size_t ring_smem(int S, int T, int span) {
  constexpr int kStages = RingStages<V>::kN;
  return ring_tiles<V, kCh>(S, T) +
         (static_cast<size_t>(kStages) * (cell_room(S) + T + 4) + span + 1) * 4;
}

// Block (g, channel chunk): chunks [block_chunk[g], block_chunk[g + 1]) of
// T rows of kCh channels of channel-major data (row stride 1, channel
// stride sc) through the ring; partial[g, s, c] = the sum of the block's
// rows of segment s, added in (chunk, lane) order, stored through shared
// memory as one contiguous [S, kCh] slab (the block's scattered stores of
// a [S, G, C] layout cost more than the rest of the kernel).  vec:
// 16-byte copies (data and sc 16-byte aligned, T a multiple of 16 bytes
// of V).
template <typename V, int kCh, int kSegs>
__global__ void __launch_bounds__(kRingThreads, 1)
    staged_ring_kernel(const V* __restrict__ data, long long sc,
                       const int* __restrict__ local, const int* __restrict__ cell_start,
                       const int* __restrict__ block_chunk, V* __restrict__ partial, int M,
                       int C, int S, int T, bool vec) {
  constexpr int kStages = RingStages<V>::kN;
  constexpr int kN = Vec16<V>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = T + 4;  // a tile row: 16-byte multiples, its channels spread over banks
  const int cells_room = cell_room(S), lane_room = T + 4;
  V* tiles = reinterpret_cast<V*>(smem_raw);  // [kStages][kCh][stride]; at the end [S][kCh]
  int* cells = reinterpret_cast<int*>(smem_raw + ring_tiles<V, kCh>(S, T));  // [kStages][cells_room]
  int* lanes = cells + kStages * cells_room;                                  // [kStages][lane_room]
  int* bounds = lanes + kStages * lane_room;                                  // [n + 1]
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kCh;
  const int k0 = __ldg(block_chunk + g);
  const int n = __ldg(block_chunk + g + 1) - k0;
  for (int j = threadIdx.x; j <= n; j += kRingThreads) {
    bounds[j] = __ldg(cell_start + static_cast<size_t>(k0 + j) * S);
  }
  __syncthreads();

  // the copies of chunk k0 + i into stage i % kStages, each thread its share
  auto issue = [&](int i) {
    const int st = i % kStages;
    const int r0 = (k0 + i) * T;
    const int n_rows = min(T, M - r0);
    V* tile = tiles + st * kCh * stride;
    const V* src = data + c0 * sc + r0;
    if (vec && n_rows == T) {
      const int per = T / kN;
      for (int j = threadIdx.x; j < kCh * per; j += kRingThreads) {
        const int c = j / per;
        const int r = (j - c * per) * kN;
        cp_async(tile + c * stride + r, src + c * sc + r, 16);
      }
    } else {
      for (int j = threadIdx.x; j < kCh * n_rows; j += kRingThreads) {
        const int c = j / n_rows;
        const int r = j - c * n_rows;
        cp_async(tile + c * stride + r, src + c * sc + r, static_cast<int>(sizeof(V)));
      }
    }
    stage_ints<kRingThreads>(cells + st * cells_room, cell_start + static_cast<size_t>(k0 + i) * S,
                             S + 1);
    stage_ints<kRingThreads>(lanes + st * lane_room, local + bounds[i], bounds[i + 1] - bounds[i]);
  };

  V acc[kSegs][kCh];
#pragma unroll
  for (int q = 0; q < kSegs; ++q) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[q][c] = V(0);
  }
  // one commit group per chunk (empty past the range), so that waiting
  // for all but the newest kStages - 1 groups waits for chunk i
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) issue(i + kStages - 1);  // into the stage chunk i - 1 freed
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = i % kStages;
    const V* tile = tiles + st * kCh * stride;
    const int first = bounds[i];
    const int* cl = cells + st * cells_room + int_shift(cell_start + static_cast<size_t>(k0 + i) * S);
    const int* ln = lanes + st * lane_room + int_shift(local + first);
#pragma unroll
    for (int q = 0; q < kSegs; ++q) {
      const int s = threadIdx.x + q * kRingThreads;
      if (s < S) {
        const int b = cl[s + 1] - first;
        for (int e = cl[s] - first; e < b; ++e) {
          const int r = ln[e];
#pragma unroll
          for (int c = 0; c < kCh; ++c) acc[q][c] += tile[c * stride + r];
        }
      }
    }
    __syncthreads();  // stage st is refilled at the next iteration
  }
  V* sums = tiles;  // every stage is free now
#pragma unroll
  for (int q = 0; q < kSegs; ++q) {
    const int s = threadIdx.x + q * kRingThreads;
    if (s < S) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) sums[s * kCh + c] = acc[q][c];
    }
  }
  __syncthreads();
  V* out = partial + static_cast<size_t>(g) * S * C + c0;
  for (int j = threadIdx.x; j < S * kCh; j += kRingThreads) {
    const int s = j / kCh;
    out[static_cast<size_t>(s) * C + j - s * kCh] = sums[j];
  }
}

// Level 2 of the ring form: out[s, c] = the sum over g of partial[g, s, c]
// ([G, S, C]).  Block (32 segments, channel chunk): lane l of every warp
// owns segment s0 + l, so a warp reads the 32 segments' kCh values of one
// row g as one contiguous run; warp w adds the rows of its slice of G in
// order, and the kWarps slices are added in warp order through shared
// memory (a fixed order).
template <typename V, int kCh>
__global__ void __launch_bounds__(kThreads)
    block_rows_kernel(const V* __restrict__ partial, V* __restrict__ out, int G, int S, int C) {
  __shared__ V part[kWarps][kCh][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  const int c0 = blockIdx.y * kCh;
  const int g0 = w * G / kWarps, g1 = (w + 1) * G / kWarps;
  V acc[kCh];
#pragma unroll
  for (int k = 0; k < kCh; ++k) acc[k] = 0;
  if (s < S) {
#pragma unroll 4
    for (int g = g0; g < g1; ++g) {
      const V* row = partial + (static_cast<size_t>(g) * S + s) * C + c0;
#pragma unroll
      for (int k = 0; k < kCh; ++k) acc[k] += __ldg(row + k);
    }
  }
#pragma unroll
  for (int k = 0; k < kCh; ++k) part[w][k][lane] = acc[k];
  __syncthreads();
  for (int j = threadIdx.x; j < 32 * kCh; j += kThreads) {
    const int k = j >> 5, l = j & 31;
    V v = part[0][k][l];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) v += part[q][k][l];
    if (blockIdx.x * 32 + l < S) out[static_cast<size_t>(blockIdx.x * 32 + l) * C + c0 + k] = v;
  }
}

template <typename V, int kCh, int kSegs>
cudaError_t launch_ring_segs(const V* data, long long sc, const int* local,
                             const int* cell_start, const int* block_chunk, V* partial, V* out,
                             int M, int C, int S, int G, int T, int span, cudaStream_t stream) {
  const size_t smem = ring_smem<V, kCh>(S, T, span);
  if (smem > kRingMaxSmem) return cudaErrorInvalidValue;
  auto kernel = staged_ring_kernel<V, kCh, kSegs>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  constexpr int kN = Vec16<V>::kN;
  const bool vec = T % kN == 0 && sc % kN == 0 && reinterpret_cast<size_t>(data) % 16 == 0;
  kernel<<<dim3(G, C / kCh), kRingThreads, smem, stream>>>(data, sc, local, cell_start,
                                                           block_chunk, partial, M, C, S, T,
                                                           vec);
  block_rows_kernel<V, kCh><<<dim3((S + 31) / 32, C / kCh), kThreads, 0, stream>>>(partial, out,
                                                                                G, S, C);
  return cudaGetLastError();
}

template <typename V, int kCh>
cudaError_t launch_ring(const V* data, long long sc, const int* local, const int* cell_start,
                        const int* block_chunk, V* partial, V* out, int M, int C, int S, int G,
                        int T, int span, cudaStream_t stream) {
  if (S <= 2 * kRingThreads) {
    return launch_ring_segs<V, kCh, 2>(data, sc, local, cell_start, block_chunk, partial, out,
                                       M, C, S, G, T, span, stream);
  }
  return launch_ring_segs<V, kCh, kRingMaxSegs>(data, sc, local, cell_start, block_chunk,
                                                partial, out, M, C, S, G, T, span, stream);
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

// The ring form: G blocks over K chunks of T rows (block_chunk [G + 1],
// each block's range contiguous, span = the most chunks a block owns),
// `local` and cell_start as for segment_sum_staged; scratch [G, S, C].
template <typename V>
int segment_sum_ring(const void* data, long long sc, const void* local, const void* cell_start,
                     const void* block_chunk, void* scratch, void* out, int M, int C, int S,
                     int K, int G, int T, int span, void* stream) {
  if (M < 1 || C < 1 || C > 65535 || S < 1 || S > kRingMaxSegs * kRingThreads || K < 1 ||
      G < 1 || G > K || T < 32 || T % 4 != 0 || span < 1 ||
      static_cast<long long>(K - 1) * T >= M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const V*>(data);
  auto loc = static_cast<const int*>(local);
  auto cells = static_cast<const int*>(cell_start);
  auto blocks = static_cast<const int*>(block_chunk);
  auto part = static_cast<V*>(scratch);
  auto o = static_cast<V*>(out);
  cudaError_t err;
  if (C % 9 == 0) {
    err = launch_ring<V, 9>(d, sc, loc, cells, blocks, part, o, M, C, S, G, T, span, s);
  } else if (C % 4 == 0) {
    err = launch_ring<V, 4>(d, sc, loc, cells, blocks, part, o, M, C, S, G, T, span, s);
  } else if (C % 3 == 0) {
    err = launch_ring<V, 3>(d, sc, loc, cells, blocks, part, o, M, C, S, G, T, span, s);
  } else {
    err = launch_ring<V, 1>(d, sc, loc, cells, blocks, part, o, M, C, S, G, T, span, s);
  }
  return static_cast<int>(err);
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

// The fixed-order plans in one launch (segment_sum_staged_order above):
// f32, and f64.
extern "C" int thallo_segment_sum_staged_order(const void* data, long long sm, long long sc,
                                               const void* order, const void* seg_start,
                                               const void* block_run, const void* block_lane,
                                               void* out, int C, int G, int tile, int tree,
                                               void* stream) {
  return segment_sum_staged_order<float>(data, sm, sc, order, seg_start, block_run, block_lane,
                                         out, C, G, tile, tree, stream);
}

extern "C" int thallo_segment_sum_staged_order_f64(const void* data, long long sm, long long sc,
                                                   const void* order, const void* seg_start,
                                                   const void* block_run,
                                                   const void* block_lane, void* out, int C,
                                                   int G, int tile, int tree, void* stream) {
  return segment_sum_staged_order<double>(data, sm, sc, order, seg_start, block_run,
                                          block_lane, out, C, G, tile, tree, stream);
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

// The ring body (segment_sum_ring above): f32 and f64.
extern "C" int thallo_segment_sum_ring(const void* data, long long sc, const void* local,
                                       const void* cell_start, const void* block_chunk,
                                       void* scratch, void* out, int M, int C, int S, int K,
                                       int G, int T, int span, void* stream) {
  return segment_sum_ring<float>(data, sc, local, cell_start, block_chunk, scratch, out, M, C,
                                 S, K, G, T, span, stream);
}

extern "C" int thallo_segment_sum_ring_f64(const void* data, long long sc, const void* local,
                                           const void* cell_start, const void* block_chunk,
                                           void* scratch, void* out, int M, int C, int S, int K,
                                           int G, int T, int span, void* stream) {
  return segment_sum_ring<double>(data, sc, local, cell_start, block_chunk, scratch, out, M, C,
                                  S, K, G, T, span, stream);
}
