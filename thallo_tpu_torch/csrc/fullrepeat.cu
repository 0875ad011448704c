// Full-repeat level setup (replaces the Pallas kernel of
// thallo_tpu/ops/fullrepeat.py::fullrepeat_setup).  See
// thallo_tpu_torch/ops/fullrepeat.py for the contract.  Inputs are
// rT [rc, N_t*W] and J [Kall, N_t*W], observation n*W + w of element n;
// outputs agg [F_agg, N_t] and cross [rows, N_t], N innermost.  The bound
// is memory: every input byte read once and every output written once.
//
// fullrepeat_tile_kernel  (thallo_fullrepeat_setup_tiles)
//   Persistent blocks stride over tiles of T elements.  A block copies a
//   tile's [rc + Kall, T*W] window of X = [rT; J] into shared memory with
//   cp.async (16-byte copies where N_t*W is a multiple of 4, else 4-byte
//   ones: every input byte read once, coalesced) and, with two stages,
//   starts the next tile's copy before it works on the current one.  The
//   plan (ops/fullrepeat.py fullrepeat_plan) lists channels, each a
//   product sum_c X[a0 + c*sa] * X[b0 + c*sb], grouped by first operand;
//   a thread takes an (element, group) item, with the 32 lanes of a warp
//   on 32 consecutive elements of one group: it reads the group's first
//   operand (rc x W values) into registers once, then per channel the
//   second operand from shared memory, and writes the channel's agg row
//   (summed over w; and the mirror row of a symmetric pair) or its W
//   cross rows at its element: coalesced stores, no atomics.  The window
//   stays in observation order: a lane reads its element's W observations
//   of a row as one vector (float4 / float2 for W = 4, 8 / 2: each warp
//   load takes the minimum of shared-memory wavefronts).
//
// fullrepeat_wide_kernel  (thallo_fullrepeat_setup_wide)
//   Every shape the tile plan refuses (W > 8, rc > 8, Kall > 128; W = 1):
//   ops/fullrepeat.py fullrepeat_wide_plan.  The tile kernel's register
//   form does not carry over: its xa[kMaxRc][W] operand grows with W and
//   rc.  Here W is a runtime loop and nothing of it lives in registers.
//   Persistent blocks walk over units (tile of T elements, chunk of Wc
//   observations); a unit's [rc + Kall, T, Wc] window of X = [rT; J] is
//   staged in shared memory with cp.async, the next unit's copy in flight
//   while the block computes on the current one (two stages where they
//   fit).  Items are (channel, element), elements fastest: a warp takes 32
//   consecutive elements of one channel, loops over w and c with both
//   operands read from shared memory, and stores a cross channel's W rows
//   (row + w*step, coalesced over elements) or sums an agg channel over w
//   in a register and stores it once (and its mirror row for a symmetric
//   diag pair).  No atomics: the sums are deterministic.  Where one
//   element's whole window does not fit at T = 32 (the f64 BA recipe
//   past W = 16 with two stages), the window is staged in w-chunks and
//   the agg partials wait in shared memory (part[item]) until the last
//   chunk; an item stays with one thread across chunks, so no barrier
//   guards them.
//   The window is staged at an element pitch: lane n reads its
//   observations at n * pitch.  At pitch W the copies are the tile
//   kernel's 16-byte cp.async of whole rows, and where W is even a lane
//   reads two observations a load (float2 / double2): at W = 10 every warp
//   read is conflict-free.  Where pitch W would put lanes on one bank (W =
//   8, 16, 24, ...: ops/fullrepeat.py read_conflict, more than
//   WIDE_MAX_CONFLICT times the least wavefronts) the window is staged at
//   the next odd pitch, one scalar cp.async a value, and read a value a
//   load, conflict-free.  scripts/torch_redesign_sweep.py --only fullrepeat
//   --sweep times both at W = 10 (H100): pitch 10 with pair reads 0.083-
//   0.087 ms in f32 and 0.156-0.170 in f64, pitch 11 0.128-0.154 and
//   0.159-0.198.  rc = 2 (BA) is a template constant, other rc a runtime
//   loop.
//   chans [n_chans, 8] int32 (a0, sa, b0, sb, row, step, 0, 0): the
//   channel's product sum_c X[a0 + c*sa] * X[b0 + c*sb]; step 0 agg row
//   `row`, step < 0 agg row `row` and its mirror -1 - step, step > 0 cross
//   rows row + w*step.
//
// fullrepeat_thread_kernel  (thallo_fullrepeat_setup_thread, the first body)
//   One thread per element n walks its W observations, sums the
//   aggregated slabs over w and c and writes agg[f, n], and writes each
//   per-w cross value to cross[f0 + w*Ca*Cb + a*Cb + b, n], reloading
//   every operand from global memory.  Any W, rc, Kall.  On no route since
//   the wide kernel: kept as the kernel it replaced, for measurement.
//   recipe: n_entries rows of 6 int32 (kind, offa, Ca, offb, Cb, f0):
//     kind 0 jtr    agg[f0+ch]          = sum_w sum_c J[offa + c*Ca + ch] * r[c]
//     kind 1 d2     agg[f0+ch]          = sum_w sum_c J[offa + c*Ca + ch]^2
//     kind 2 diag   agg[f0 + a*Cb+b]    = sum_w sum_c Ja[c, a] * Jb[c, b]
//     kind 3 cross  cross[f0 + w*Ca*Cb + a*Cb + b] = sum_c Ja_w[c, a] * Jb_w[c, b]
//
// f64 (the solver's double_precision): the three kernels are templated on
// the value type V of the inputs, the stage and the outputs
// (thallo_fullrepeat_setup_tiles_f64, thallo_fullrepeat_setup_wide_f64,
// thallo_fullrepeat_setup_thread_f64: V = double; the wide kernel takes
// every f64 shape the tile plan does not, e.g. a point seen by 10
// cameras).  A 16-byte cp.async then carries 2 values (every row 16-byte
// aligned where N_t*W is even, else 8-byte copies), a lane reads an
// element's W observations as double2 vectors where W is even, and
// ops/fullrepeat.py plans the windows at 8 bytes a value.
//
// The kernels write every agg and cross row at every element.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_accum.cuh"  // fma_v

namespace {

constexpr int kMaxRc = 8;             // ops/fullrepeat.py MAX_RC
constexpr int kMaxTileThreads = 512;  // ops/fullrepeat.py FULLREPEAT_THREADS
constexpr int kMaxWideThreads = 1024;  // ops/fullrepeat.py MAX_WIDE_THREADS

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// one value: 4 bytes for a float, 8 for a double
__device__ __forceinline__ void cp_async1(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async1(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the W observations of one element on one window row (p 16-byte aligned
// for W % 4 == 0, 8-byte aligned for W == 2)
template <int W>
__device__ __forceinline__ void load_obs(const double* p, double (&v)[W]) {
  if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const double2 q = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = p[w];
  }
}

template <int W>
__device__ __forceinline__ void load_obs(const float* p, float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else if constexpr (W == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = p[w];
  }
}

// Copies tile `tile`'s window of X = [rT; J] into st [RK, T*W] (rows past
// the level's last observation are left as they were).  kQ values make
// 16 bytes.
template <typename V>
__device__ __forceinline__ void stage_tile(V* st, const V* __restrict__ rT,
                                           const V* __restrict__ J, int rc, int RK, size_t RW,
                                           int TW, int tile) {
  constexpr int kQ = 16 / sizeof(V);
  const size_t o0 = static_cast<size_t>(tile) * TW;
  const int cnt = static_cast<int>(RW - o0 < static_cast<size_t>(TW) ? RW - o0 : TW);
  if (RW % kQ == 0) {  // every row and tile starts 16-byte aligned; cnt % kQ == 0
    const int q_row = TW / kQ;
    for (int i = threadIdx.x; i < RK * q_row; i += blockDim.x) {
      const int k = i / q_row;
      const int q = i - k * q_row;
      if (kQ * q < cnt) {
        const V* src = (k < rc ? rT + k * RW : J + (k - rc) * RW) + o0 + kQ * q;
        cp_async16(st + k * TW + kQ * q, src);
      }
    }
  } else {
    for (int i = threadIdx.x; i < RK * TW; i += blockDim.x) {
      const int k = i / TW;
      const int o = i - k * TW;
      if (o < cnt) cp_async1(st + i, (k < rc ? rT + k * RW : J + (k - rc) * RW) + o0 + o);
    }
  }
}

template <typename V, int W>
__global__ void __launch_bounds__(kMaxTileThreads)
    fullrepeat_tile_kernel(const V* __restrict__ rT, const V* __restrict__ J,
                           const int4* __restrict__ groups_g, const int4* __restrict__ chans_g,
                           V* __restrict__ agg, V* __restrict__ cross, int n_groups,
                           int n_chans, int rc, int Kall, int N_t, int T, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* smem = reinterpret_cast<V*>(smem_raw);
  const int RK = rc + Kall;
  const int TW = T * W;
  const size_t stage_values = static_cast<size_t>(RK) * TW;
  int4* groups = reinterpret_cast<int4*>(smem + stages * stage_values);
  int4* chans = groups + n_groups;
  for (int i = threadIdx.x; i < n_groups; i += blockDim.x) groups[i] = groups_g[i];
  for (int i = threadIdx.x; i < n_chans; i += blockDim.x) chans[i] = chans_g[i];

  const size_t RW = static_cast<size_t>(N_t) * W;
  const size_t Nz = static_cast<size_t>(N_t);
  const int n_tiles = (N_t + T - 1) / T;
  int tile = blockIdx.x;
  if (tile < n_tiles) stage_tile(smem, rT, J, rc, RK, RW, TW, tile);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const V* cur = smem + (stages == 2 ? (it & 1) : 0) * stage_values;
    if (stages == 2) {
      if (next < n_tiles) stage_tile(smem + ((it + 1) & 1) * stage_values, rT, J, rc, RK, RW,
                                     TW, next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // items (group g, element n), n fastest: a warp is 32 elements of one
    // group (T % 32 == 0)
    for (int item = threadIdx.x; item < n_groups * T; item += blockDim.x) {
      const int g = item / T;
      const int n = item - g * T;
      const int e = tile * T + n;
      const int4 gr = groups[g];
      V xa[kMaxRc][W];
#pragma unroll
      for (int c = 0; c < kMaxRc; ++c) {
        if (c < rc) load_obs<W>(cur + (gr.x + c * gr.y) * TW + n * W, xa[c]);
      }
      for (int j = gr.z; j < gr.w; ++j) {
        const int4 ch = chans[j];
        V s[W];
#pragma unroll
        for (int w = 0; w < W; ++w) s[w] = V(0);
#pragma unroll
        for (int c = 0; c < kMaxRc; ++c) {
          if (c < rc) {
            V xb[W];
            load_obs<W>(cur + (ch.x + c * ch.y) * TW + n * W, xb);
#pragma unroll
            for (int w = 0; w < W; ++w) s[w] = fma_v(xa[c][w], xb[w], s[w]);
          }
        }
        if (e >= N_t) continue;
        if (ch.w > 0) {
#pragma unroll
          for (int w = 0; w < W; ++w) cross[static_cast<size_t>(ch.z + w * ch.w) * Nz + e] = s[w];
        } else {
          V t = V(0);
#pragma unroll
          for (int w = 0; w < W; ++w) t += s[w];
          agg[static_cast<size_t>(ch.z) * Nz + e] = t;
          if (ch.w < 0) agg[static_cast<size_t>(-1 - ch.w) * Nz + e] = t;
        }
      }
    }
    __syncthreads();
    if (stages == 1 && next < n_tiles) {
      stage_tile(smem, rT, J, rc, RK, RW, TW, next);
      cp_async_commit();
    }
  }
}

template <typename V, int W>
cudaError_t launch_tiles(const V* rT, const V* J, const int4* groups, const int4* chans, V* agg,
                         V* cross, int n_groups, int n_chans, int rc, int Kall, int N_t, int T,
                         int stages, int threads, int grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fullrepeat_tile_kernel<V, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fullrepeat_tile_kernel<V, W><<<grid, threads, smem, stream>>>(
      rT, J, groups, chans, agg, cross, n_groups, n_chans, rc, Kall, N_t, T, stages);
  return cudaGetLastError();
}

// Copies chunk (tile, w0 .. w0 + wc) of X = [rT; J] into st [RK, T, pitch]
// one value a cp.async: st[(k*T + n)*pitch + wl] = X[k, (tile*T + n)*W +
// w0 + wl]; a warp copies consecutive observations (coalesced where wc is
// W).  Elements past N_t are left as they were.
template <typename V>
__device__ __forceinline__ void stage_chunk(V* st, const V* __restrict__ rT,
                                            const V* __restrict__ J, int rc, int RK, size_t RW,
                                            int W, int T, int pitch, int N_t, int tile, int w0,
                                            int wc) {
  const int per_row = T * wc;
  const int n_left = N_t - tile * T;
  const size_t e0 = static_cast<size_t>(tile) * T;
  const int dk = blockDim.x / per_row;
  const int dr = blockDim.x - dk * per_row;
  int k = threadIdx.x / per_row;
  int r = threadIdx.x - k * per_row;
  while (k < RK) {
    const int n = r / wc;
    const int wl = r - n * wc;
    if (n < n_left) {
      const V* src = (k < rc ? rT + k * RW : J + (k - rc) * RW) + (e0 + n) * W + w0 + wl;
      cp_async1(st + (k * T + n) * pitch + wl, src);
    }
    k += dk;
    r += dr;
    if (r >= per_row) {
      r -= per_row;
      ++k;
    }
  }
}

// the pair (p[0], p[1]) of a window row, p 8-byte (float) or 16-byte
// (double) aligned
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ double2 load_pair(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// Stages unit u of this block (tile blockIdx.x + (u / n_chunks) *
// gridDim.x, chunk u % n_chunks) into st.
template <typename V>
__device__ __forceinline__ void stage_unit(V* st, const V* __restrict__ rT,
                                           const V* __restrict__ J, int rc, int RK, size_t RW,
                                           int W, int T, int Wc, int pitch, int N_t,
                                           int n_chunks, bool rows16, int u) {
  const int tile = blockIdx.x + (u / n_chunks) * gridDim.x;
  const int w0 = (u % n_chunks) * Wc;
  if (rows16) {
    stage_tile(st, rT, J, rc, RK, RW, T * W, tile);
  } else {
    stage_chunk(st, rT, J, rc, RK, RW, W, T, pitch, N_t, tile, w0, min(Wc, W - w0));
  }
}

// kRc: rc as a constant (2: BA's residual channels), or 0: rc at run time
template <typename V, int kRc>
__global__ void __launch_bounds__(kMaxWideThreads)
    fullrepeat_wide_kernel(const V* __restrict__ rT, const V* __restrict__ J,
                           const int4* __restrict__ chans_g, V* __restrict__ agg,
                           V* __restrict__ cross, int n_chans, int rc_arg, int Kall, int W,
                           int N_t, int T, int Wc, int pitch, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* smem = reinterpret_cast<V*>(smem_raw);
  const int rc = kRc > 0 ? kRc : rc_arg;
  const int RK = rc + Kall;
  const int TP = T * pitch;  // values of one window row
  const size_t stage_values = static_cast<size_t>(RK) * TP;
  int4* chans = reinterpret_cast<int4*>(smem + stages * stage_values);  // 2 int4 a channel
  V* part = reinterpret_cast<V*>(chans + 2 * n_chans);  // [n_chans * T] agg partials
  for (int i = threadIdx.x; i < 2 * n_chans; i += blockDim.x) chans[i] = chans_g[i];

  const size_t RW = static_cast<size_t>(N_t) * W;
  const size_t Nz = static_cast<size_t>(N_t);
  const int n_tiles = (N_t + T - 1) / T;
  const int n_chunks = (W + Wc - 1) / Wc;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_units = my_tiles * n_chunks;
  constexpr int kQ = 16 / sizeof(V);
  // one chunk at pitch W: the tile kernel's 16-byte copies of whole rows
  const bool rows16 = n_chunks == 1 && pitch == W && RW % kQ == 0;
  if (n_units > 0) {
    stage_unit(smem, rT, J, rc, RK, RW, W, T, Wc, pitch, N_t, n_chunks, rows16, 0);
  }
  cp_async_commit();
  const int items = n_chans * T;
  for (int u = 0; u < n_units; ++u) {
    const V* cur = smem + (stages == 2 ? (u & 1) : 0) * stage_values;
    if (stages == 2) {
      if (u + 1 < n_units) {
        stage_unit(smem + ((u + 1) & 1) * stage_values, rT, J, rc, RK, RW, W, T, Wc, pitch,
                   N_t, n_chunks, rows16, u + 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int tile = blockIdx.x + (u / n_chunks) * gridDim.x;
    const int chunk = u % n_chunks;
    const int w0 = chunk * Wc;
    const int wc = min(Wc, W - w0);
    // an even pitch and chunk: a lane reads two observations a load
    const bool pairs = pitch % 2 == 0 && wc % 2 == 0;
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int j = item / T;
      const int n = item - j * T;
      const int e = tile * T + n;
      const int4 ab = chans[2 * j];       // a0, sa, b0, sb
      const int4 out = chans[2 * j + 1];  // row, step
      const V* xa = cur + ab.x * TP + n * pitch;
      const V* xb = cur + ab.z * TP + n * pitch;
      const int da = ab.y * TP;
      const int db = ab.w * TP;
      // a cross channel's row at w0, and the step to the next w's row
      const bool store = out.y > 0 && e < N_t;
      const size_t dw = store ? static_cast<size_t>(out.y) * Nz : 0;
      V* dst = store ? cross + (out.x + static_cast<size_t>(w0) * out.y) * Nz + e : nullptr;
      V acc = V(0);
      if (pairs) {
#pragma unroll 2
        for (int w = 0; w < wc; w += 2) {
          V s0 = V(0), s1 = V(0);
#pragma unroll 4
          for (int c = 0; c < rc; ++c) {
            const auto a = load_pair(xa + c * da + w);
            const auto b = load_pair(xb + c * db + w);
            s0 = fma_v(a.x, b.x, s0);
            s1 = fma_v(a.y, b.y, s1);
          }
          if (store) {
            dst[w * dw] = s0;
            dst[(w + 1) * dw] = s1;
          }
          acc += s0 + s1;
        }
      } else {
#pragma unroll 2
        for (int w = 0; w < wc; ++w) {
          V s = V(0);
#pragma unroll 4
          for (int c = 0; c < rc; ++c) s = fma_v(xa[c * da + w], xb[c * db + w], s);
          if (store) dst[w * dw] = s;
          acc += s;
        }
      }
      if (out.y > 0) continue;
      if (n_chunks > 1) {
        if (chunk > 0) acc += part[item];
        if (chunk + 1 < n_chunks) {
          part[item] = acc;
          continue;
        }
      }
      if (e < N_t) {
        agg[static_cast<size_t>(out.x) * Nz + e] = acc;
        if (out.y < 0) agg[static_cast<size_t>(-1 - out.y) * Nz + e] = acc;
      }
    }
    __syncthreads();
    if (stages == 1 && u + 1 < n_units) {
      stage_unit(smem, rT, J, rc, RK, RW, W, T, Wc, pitch, N_t, n_chunks, rows16, u + 1);
      cp_async_commit();
    }
  }
}

template <typename V, int kRc>
cudaError_t launch_wide(const V* rT, const V* J, const int4* chans, V* agg, V* cross,
                        int n_chans, int rc, int Kall, int W, int N_t, int T, int Wc, int pitch,
                        int stages, int threads, int grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fullrepeat_wide_kernel<V, kRc>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fullrepeat_wide_kernel<V, kRc><<<grid, threads, smem, stream>>>(
      rT, J, chans, agg, cross, n_chans, rc, Kall, W, N_t, T, Wc, pitch, stages);
  return cudaGetLastError();
}

template <typename V>
int setup_wide(const void* rT, const void* Jall, const void* chans, void* agg, void* cross,
               int n_chans, int rc, int Kall, int W, int N_t, int T, int Wc, int pitch,
               int stages, int threads, int grid, void* stream) {
  if (W < 1 || rc < 1 || Kall < 0 || N_t < 0 || T < 32 || T % 32 != 0 || Wc < 1 || Wc > W ||
      pitch < Wc || (stages != 1 && stages != 2) || threads < 32 || threads > kMaxWideThreads ||
      threads % 32 != 0 || grid < 1 || n_chans < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N_t == 0 || n_chans == 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = (W + Wc - 1) / Wc;
  const size_t smem = static_cast<size_t>(stages) * (rc + Kall) * T * pitch * sizeof(V) +
                      static_cast<size_t>(n_chans) * 2 * sizeof(int4) +
                      (n_chunks > 1 ? static_cast<size_t>(n_chans) * T * sizeof(V) : 0);
  const auto* r = static_cast<const V*>(rT);
  const auto* j = static_cast<const V*>(Jall);
  const auto* c = static_cast<const int4*>(chans);
  auto* a = static_cast<V*>(agg);
  auto* x = static_cast<V*>(cross);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rc == 2 ? launch_wide<V, 2>(r, j, c, a, x, n_chans, rc, Kall, W, N_t, T, Wc, pitch, stages,
                                  threads, grid, smem, st)
              : launch_wide<V, 0>(r, j, c, a, x, n_chans, rc, Kall, W, N_t, T, Wc, pitch, stages,
                                  threads, grid, smem, st);
  return static_cast<int>(err);
}

template <typename V>
__global__ void fullrepeat_thread_kernel(const V* __restrict__ rT, const V* __restrict__ J,
                                         const int* __restrict__ recipe, V* __restrict__ agg,
                                         V* __restrict__ cross, int n_entries, int rc, int W,
                                         int N_t) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N_t) return;
  const size_t RW = static_cast<size_t>(N_t) * W;
  const size_t Nz = static_cast<size_t>(N_t);
  const V* Jn = J + static_cast<size_t>(n) * W;
  const V* rn = rT + static_cast<size_t>(n) * W;

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
        for (int w = 0; w < W; ++w) {
          for (int c = 0; c < rc; ++c) {
            const V j = __ldg(Jn + static_cast<size_t>(offa + c * Ca + ch) * RW + w);
            s = fma_v(j, kind == 0 ? __ldg(rn + c * RW + w) : j, s);
          }
        }
        agg[static_cast<size_t>(f0 + ch) * Nz + n] = s;
      }
    } else if (kind == 2) {
      for (int a = 0; a < Ca; ++a) {
        for (int b = 0; b < Cb; ++b) {
          V s = V(0);
          for (int w = 0; w < W; ++w) {
            for (int c = 0; c < rc; ++c) {
              s = fma_v(__ldg(Jn + static_cast<size_t>(offa + c * Ca + a) * RW + w),
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
            V s = V(0);
            for (int c = 0; c < rc; ++c) {
              s = fma_v(__ldg(Jn + static_cast<size_t>(offa + c * Ca + a) * RW + w),
                        __ldg(Jn + static_cast<size_t>(offb + c * Cb + b) * RW + w), s);
            }
            cross[static_cast<size_t>(f0 + w * Fc + a * Cb + b) * Nz + n] = s;
          }
        }
      }
    }
  }
}

template <typename V>
int setup_tiles(const void* rT, const void* Jall, const void* groups, const void* chans, void* agg,
                void* cross, int n_groups, int n_chans, int rc, int Kall, int W, int N_t, int T,
                int stages, int threads, int grid, void* stream) {
  if (W < 2 || W > 8 || rc < 1 || rc > kMaxRc || Kall < 0 || N_t < 0 || T < 32 || T % 32 != 0 ||
      (stages != 1 && stages != 2) || threads < 32 || threads > kMaxTileThreads ||
      threads % 32 != 0 || grid < 1 || n_groups < 0 || n_chans < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N_t == 0 || n_groups == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(stages) * (rc + Kall) * T * W * sizeof(V) +
                      static_cast<size_t>(n_groups + n_chans) * sizeof(int4);
  const auto* r = static_cast<const V*>(rT);
  const auto* j = static_cast<const V*>(Jall);
  const auto* g = static_cast<const int4*>(groups);
  const auto* c = static_cast<const int4*>(chans);
  auto* a = static_cast<V*>(agg);
  auto* x = static_cast<V*>(cross);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (W) {
#define THALLO_FR_CASE(w)                                                                        \
  case w:                                                                                        \
    err = launch_tiles<V, w>(r, j, g, c, a, x, n_groups, n_chans, rc, Kall, N_t, T, stages,    \
                             threads, grid, smem, s);                                            \
    break;
    THALLO_FR_CASE(2)
    THALLO_FR_CASE(3)
    THALLO_FR_CASE(4)
    THALLO_FR_CASE(5)
    THALLO_FR_CASE(6)
    THALLO_FR_CASE(7)
    THALLO_FR_CASE(8)
#undef THALLO_FR_CASE
  }
  return static_cast<int>(err);
}

template <typename V>
int setup_thread(const void* rT, const void* Jall, const void* recipe, void* agg, void* cross,
                 int n_entries, int rc, int W, int N_t, void* stream) {
  if (N_t > 0) {
    constexpr int kThreads = 256;
    const int grid = (N_t + kThreads - 1) / kThreads;
    fullrepeat_thread_kernel<V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(rT), static_cast<const V*>(Jall), static_cast<const int*>(recipe),
        static_cast<V*>(agg), static_cast<V*>(cross), n_entries, rc, W, N_t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile kernel.  groups [n_groups, 4] int32 (a0, sa, j0, j1), chans
// [n_chans, 4] int32 (b0, sb, row, step; see ops/fullrepeat.py
// FullrepeatPlan); 2 <= W <= 8, 1 <= rc <= 8, T a multiple of 32, stages 1
// or 2, threads a multiple of 32 up to 512, grid persistent blocks.  agg
// and cross are written at every row a channel names.
extern "C" int thallo_fullrepeat_setup_tiles(const void* rT, const void* Jall, const void* groups,
                                             const void* chans, void* agg, void* cross,
                                             int n_groups, int n_chans, int rc, int Kall, int W,
                                             int N_t, int T, int stages, int threads, int grid,
                                             void* stream) {
  return setup_tiles<float>(rT, Jall, groups, chans, agg, cross, n_groups, n_chans, rc, Kall, W,
                            N_t, T, stages, threads, grid, stream);
}

// The tile kernel in f64: rT, Jall, agg and cross double.
extern "C" int thallo_fullrepeat_setup_tiles_f64(const void* rT, const void* Jall,
                                                 const void* groups, const void* chans, void* agg,
                                                 void* cross, int n_groups, int n_chans, int rc,
                                                 int Kall, int W, int N_t, int T, int stages,
                                                 int threads, int grid, void* stream) {
  return setup_tiles<double>(rT, Jall, groups, chans, agg, cross, n_groups, n_chans, rc, Kall,
                             W, N_t, T, stages, threads, grid, stream);
}

// The wide kernel.  chans [n_chans, 8] int32 (a0, sa, b0, sb, row, step,
// 0, 0; ops/fullrepeat.py FullrepeatWidePlan); any W >= 1, rc >= 1; T a
// multiple of 32, Wc observations a chunk (ceil(W / Wc) chunks), pitch >=
// Wc, stages 1 or 2, threads a multiple of 32 up to 1024, grid persistent
// blocks.  agg and cross are written at every row a channel names.
extern "C" int thallo_fullrepeat_setup_wide(const void* rT, const void* Jall, const void* chans,
                                            void* agg, void* cross, int n_chans, int rc,
                                            int Kall, int W, int N_t, int T, int Wc, int pitch,
                                            int stages, int threads, int grid, void* stream) {
  return setup_wide<float>(rT, Jall, chans, agg, cross, n_chans, rc, Kall, W, N_t, T, Wc, pitch,
                           stages, threads, grid, stream);
}

// The wide kernel in f64: rT, Jall, agg and cross double.
extern "C" int thallo_fullrepeat_setup_wide_f64(const void* rT, const void* Jall,
                                                const void* chans, void* agg, void* cross,
                                                int n_chans, int rc, int Kall, int W, int N_t,
                                                int T, int Wc, int pitch, int stages,
                                                int threads, int grid, void* stream) {
  return setup_wide<double>(rT, Jall, chans, agg, cross, n_chans, rc, Kall, W, N_t, T, Wc, pitch,
                            stages, threads, grid, stream);
}

// The first body.  recipe [n_entries, 6] int32 (see above); any W, rc, Kall.
extern "C" int thallo_fullrepeat_setup_thread(const void* rT, const void* Jall,
                                              const void* recipe, void* agg, void* cross,
                                              int n_entries, int rc, int W, int N_t,
                                              void* stream) {
  return setup_thread<float>(rT, Jall, recipe, agg, cross, n_entries, rc, W, N_t, stream);
}

// The first body in f64: rT, Jall, agg and cross double.
extern "C" int thallo_fullrepeat_setup_thread_f64(const void* rT, const void* Jall,
                                                  const void* recipe, void* agg, void* cross,
                                                  int n_entries, int rc, int W, int N_t,
                                                  void* stream) {
  return setup_thread<double>(rT, Jall, recipe, agg, cross, n_entries, rc, W, N_t, stream);
}
