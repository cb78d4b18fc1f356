// LayerNorm over the last axis of a [rows, C] tensor, forward and backward,
// for sm_90a.
//
// Replaces the Pallas TPU kernels of `fused_layer_norm`
// (imageclassification_tpu/ops/pallas_layernorm.py): `_fwd_kernel` (:55) behind
// `_run_fwd` (pallas_call at :85), and `_bwd_kernel` (:66) behind `_run_bwd`
// (pallas_call at :108) with its per-block dgamma/dbeta partials summed
// afterwards (:136).
//
// Math (the Pallas kernels' and `layer_norm_ref`'s): fp32 statistics
//   mean = E[x], var = E[x^2] - E[x]^2 (not clamped), rstd = 1 / sqrt(var + eps)
//   y = (x - mean) * rstd * gamma + beta, in x's dtype;
//   backward, mean and rstd recomputed from x (nothing saved):
//   g' = dy * gamma, xhat = (x - mean) * rstd,
//   dx = rstd * (g' - mean(g') - xhat * mean(g' * xhat)),
//   dgamma = sum_rows dy * xhat, dbeta = sum_rows dy.
//
// What bounds it on an H100: bytes. The forward reads x and writes y (2
// passes of the tensor), the backward reads x and dy and writes dx (3); about
// 10 and 20 flops per element are far below the card's flop rate. The lever
// is bytes in flight, each byte read from device memory once. So:
//
// - Persistent CTAs of 256 threads (two an SM in the forward, one in the
//   backward, by ops/layernorm.py `ln_plan`) walk over tiles of whole rows.
//   A tile of rows is one contiguous range of bytes, loaded by one 1-d bulk
//   copy (cp.async.bulk, no tensor map; the backward's stage holds an x tile
//   and a dy tile). Thread 0 keeps a ring of 2-4 stages of about 16 KB a
//   tensor loading while the CTA computes one; the ragged last tile is a
//   shorter copy, a multiple of 16 bytes since C is a multiple of the vector.
// - A row is read from shared memory by a group of `lanes` threads, the
//   fewest (a power of two) that hold its C / V 16-byte vectors at up to 4
//   a lane: 4 lanes of 3 vectors at C = 96 bf16, 32 at 768, 256 at 4096
//   fp32. Each lane keeps its vectors in registers from the statistics to
//   the output. The row sums are segmented shuffles (and a named barrier
//   between the warps of a row wider than 32 lanes). y and dx go out as
//   16-byte stores.
// - dgamma/dbeta in registers: a thread owns the same columns for every row
//   of its CTA's walk and adds dy * xhat and dy there, in fp32. At the end the
//   CTA adds its row slots' sums in slot order through shared memory into one
//   partial row of [dgamma | dbeta], and vec::sum_partials adds the CTAs'
//   rows in a fixed order: the same result on every run, no atomics.
//
// Shapes the bulk path does not take: C not a multiple of the vector width
// (8 bf16, 4 fp32). Those run a warp-per-row pair of kernels with scalar
// loads (the backward's column sums in per-warp shared-memory slices, lane l
// on columns l, l + 32, ...). The choice is by shape, in the C entry points.

#include "hopper_common.cuh"
#include "vec_common.cuh"

namespace {

using vec::bf16;

constexpr int kThreads = 256;  // a CTA of the bulk path
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
constexpr int kMaxVecs = 4;  // 16-byte vectors a lane holds
// the dynamic shared memory a CTA may ask for: 227 KB, less the static part
constexpr int kSmemMax = 232448 - 1024;
constexpr int kRowWarps = 8;  // warps a CTA of the warp-per-row path

// The bulk path's plan: ops/layernorm.py `LnPlan`'s fields, in its order.
struct Plan {
  int lanes;        // threads a row: a power of two, 1 to 256
  int vecs;         // 16-byte vectors a lane, 1 to kMaxVecs
  int tile_rows;    // rows a tile: a multiple of kThreads / lanes
  int stages;       // 2 to kMaxStages
  int x_bytes;      // bytes of a stage's x tile (the backward's dy tile follows)
  int stage_bytes;  // bytes a stage
  int smem_bytes;   // dynamic shared memory of the launch
  int ctas;         // the grid
};

// a 16-byte vector of bf16 or fp32 to and from fp32
__device__ __forceinline__ void unpack(const uint4& r, float (&o)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&o)[4]) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&o)[8]) {
  return make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]), pack2(o[6], o[7]));
}

__device__ __forceinline__ uint4 pack(const float (&o)[4]) {
  return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]), __float_as_uint(o[2]),
                    __float_as_uint(o[3]));
}

// The sum of v over the `lanes` threads of a row (aligned groups of a
// power of two): shuffles inside a warp; above 32 lanes each warp's sum goes
// through red (two buffers, alternated by ph) and the row's warps meet at
// named barrier 1 + slot. Every thread of the CTA calls it the same number
// of times.
__device__ __forceinline__ float2 row_sum(float2 v, int lanes, int slot, float2 (*red)[kWarps],
                                          int& ph) {
  for (int o = (lanes < 32 ? lanes : 32) >> 1; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (lanes > 32) {
    const int nw = lanes >> 5, first = slot * nw;
    if ((threadIdx.x & 31) == 0) red[ph][threadIdx.x >> 5] = v;
    hopper::named_barrier_sync(1 + slot, lanes);
    v = red[ph][first];
    for (int i = 1; i < nw; ++i) {
      v.x += red[ph][first + i].x;
      v.y += red[ph][first + i].y;
    }
    ph ^= 1;
  }
  return v;
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 127) &
                                          ~static_cast<uintptr_t>(127));
}

// Thread 0's side of the ring: tile t (tile_rows of the `rows` rows) of each
// tensor src[i] into stage buffer dst (src[i]'s tile at i * x_bytes),
// completing on bar.
template <int kTensors>
__device__ __forceinline__ void issue_tile(unsigned char* dst, uint64_t* bar,
                                           const unsigned char* const (&src)[kTensors],
                                           int64_t t, int64_t rows, int64_t row_bytes,
                                           const Plan& plan) {
  const int64_t r0 = t * plan.tile_rows;
  const int64_t n = rows - r0 < plan.tile_rows ? rows - r0 : plan.tile_rows;
  const uint32_t bytes = (uint32_t)(n * row_bytes);
  hopper::mbar_arrive_expect_tx(bar, kTensors * bytes);
#pragma unroll
  for (int i = 0; i < kTensors; ++i) {
    hopper::bulk_load(dst + i * plan.x_bytes, src[i] + r0 * row_bytes, bytes, bar);
  }
}

// The walk shared by both kernels: CTA b takes tiles b, b + grid, ...; for
// each, body(its first row, its stage buffer, its rows) once the stage has
// landed. Thread 0 refills the stage of the previous tile, whose reads ended
// at the barrier closing that tile, with the tile stages - 1 ahead.
template <int kTensors, typename Body>
__device__ __forceinline__ void walk_tiles(unsigned char* ring, uint64_t* full,
                                           const unsigned char* const (&src)[kTensors],
                                           int64_t rows, int64_t row_bytes, const Plan& plan,
                                           Body body) {
  const int S = plan.stages;
  const int64_t tiles = (rows + plan.tile_rows - 1) / plan.tile_rows;
  const int64_t step = gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
    for (int s = 0; s < S - 1; ++s) {
      const int64_t t = blockIdx.x + s * step;
      if (t < tiles) {
        issue_tile<kTensors>(ring + s * plan.stage_bytes, &full[s], src, t, rows, row_bytes,
                             plan);
      }
    }
  }
  __syncthreads();
  int k = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += step, ++k) {
    const int st = k % S;
    if (threadIdx.x == 0) {
      const int64_t ahead = t + (S - 1) * step;
      if (ahead < tiles) {
        const int sa = (k + S - 1) % S;
        hopper::fence_proxy_async();
        issue_tile<kTensors>(ring + sa * plan.stage_bytes, &full[sa], src, ahead, rows,
                             row_bytes, plan);
      }
    }
    hopper::mbar_wait(&full[st], (k / S) & 1);
    const int64_t r0 = t * plan.tile_rows;
    body(r0, ring + st * plan.stage_bytes,
         (int)(rows - r0 < plan.tile_rows ? rows - r0 : plan.tile_rows));
    __syncthreads();  // every read of stage st is done before it is refilled
  }
}

// Grid plan.ctas, kThreads threads, plan.smem_bytes of dynamic shared
// memory. Thread (slot, lane) = (tid / lanes, tid % lanes) normalises rows
// slot, slot + kThreads / lanes, ... of each tile, holding vectors lane,
// lane + lanes, ... (kVecs at most) of the row.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads, 2)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y, int64_t rows, int C,
                      float eps, const Plan plan) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ unsigned char ln_smem_raw[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ float2 red[2][kWarps];
  unsigned char* const ring = align128(ln_smem_raw);
  const int lanes = plan.lanes, slots = kThreads / lanes;
  const int slot = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int nv = C / V;
  const int64_t row_bytes = (int64_t)C * sizeof(T);

  // the lane's columns are the same in every row: gamma and beta once
  float g[kVecs][V], b[kVecs][V];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = lane + k * lanes;
#pragma unroll
    for (int j = 0; j < V; ++j) g[k][j] = b[k][j] = 0.f;
    if (v < nv) {
      vec::load<float, V>(g[k], gamma + v * V);
      vec::load<float, V>(b[k], beta + v * V);
    }
  }
  int ph = 0;
  const unsigned char* const src[1] = {reinterpret_cast<const unsigned char*>(x)};
  walk_tiles<1>(ring, full, src, rows, row_bytes, plan,
                [&](int64_t r0, const unsigned char* tile, int n) {
    for (int base = 0; base < n; base += slots) {
      const int r = base + slot;
      const bool ok = r < n;
      const uint4* xr = reinterpret_cast<const uint4*>(tile + r * row_bytes);
      uint4 raw[kVecs];
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = lane + k * lanes;
        raw[k] = make_uint4(0, 0, 0, 0);
        if (ok && v < nv) {
          raw[k] = xr[v];
          float a[V];
          unpack(raw[k], a);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s.x += a[j];
            s.y += a[j] * a[j];
          }
        }
      }
      s = row_sum(s, lanes, slot, red, ph);
      const float mean = s.x / C;
      const float rstd = 1.f / sqrtf(s.y / C - mean * mean + eps);
      uint4* yr = reinterpret_cast<uint4*>(y + (r0 + r) * C);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = lane + k * lanes;
        if (ok && v < nv) {
          float a[V], o[V];
          unpack(raw[k], a);
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = (a[j] - mean) * rstd * g[k][j] + b[k][j];
          yr[v] = pack(o);
        }
      }
    }
  });
}

// As the forward; a stage holds the x tile and then the dy tile. part:
// [plan.ctas][2 * C] fp32, CTA b's partial row [dgamma | dbeta] at part[b].
// gamma stays in registers where it fits beside the column sums.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads, 2)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                      int64_t rows, int C, float eps, const Plan plan) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kGammaRegs = kVecs * V <= 16;
  extern __shared__ unsigned char ln_smem_raw[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ float2 red[2][kWarps];
  unsigned char* const ring = align128(ln_smem_raw);
  const int lanes = plan.lanes, slots = kThreads / lanes;
  const int slot = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int nv = C / V;
  const int64_t row_bytes = (int64_t)C * sizeof(T);
  const float inv_c = 1.f / C;

  float dg[kVecs][V], db[kVecs][V], greg[kGammaRegs ? kVecs : 1][V];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) dg[k][j] = db[k][j] = 0.f;
    const int v = lane + k * lanes;
    if constexpr (kGammaRegs) {
#pragma unroll
      for (int j = 0; j < V; ++j) greg[k][j] = 0.f;
      if (v < nv) vec::load<float, V>(greg[k], gamma + v * V);
    }
  }
  auto gamma_of = [&](int k, int v, float (&gm)[V]) {
    if constexpr (kGammaRegs) {
#pragma unroll
      for (int j = 0; j < V; ++j) gm[j] = greg[k][j];
    } else {
      vec::load<float, V>(gm, gamma + v * V);
    }
  };
  int ph = 0;
  const unsigned char* const src[2] = {reinterpret_cast<const unsigned char*>(x),
                                       reinterpret_cast<const unsigned char*>(dy)};
  walk_tiles<2>(ring, full, src, rows, row_bytes, plan,
                [&](int64_t r0, const unsigned char* tile, int n) {
    for (int base = 0; base < n; base += slots) {
      const int r = base + slot;
      const bool ok = r < n;
      const uint4* xr = reinterpret_cast<const uint4*>(tile + r * row_bytes);
      const uint4* dr = reinterpret_cast<const uint4*>(tile + plan.x_bytes + r * row_bytes);
      uint4 rx[kVecs], rd[kVecs];
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = lane + k * lanes;
        rx[k] = rd[k] = make_uint4(0, 0, 0, 0);
        if (ok && v < nv) {
          rx[k] = xr[v];
          rd[k] = dr[v];
          float a[V];
          unpack(rx[k], a);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s.x += a[j];
            s.y += a[j] * a[j];
          }
        }
      }
      s = row_sum(s, lanes, slot, red, ph);
      const float mean = s.x / C;
      const float rstd = 1.f / sqrtf(s.y / C - mean * mean + eps);
      float2 m = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = lane + k * lanes;
        if (ok && v < nv) {
          float a[V], d[V], gm[V];
          unpack(rx[k], a);
          unpack(rd[k], d);
          gamma_of(k, v, gm);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float gp = d[j] * gm[j];
            m.x += gp;
            m.y += gp * ((a[j] - mean) * rstd);
          }
        }
      }
      m = row_sum(m, lanes, slot, red, ph);
      const float m1 = m.x * inv_c, m2 = m.y * inv_c;
      uint4* dxr = reinterpret_cast<uint4*>(dx + (r0 + r) * C);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = lane + k * lanes;
        if (ok && v < nv) {
          float a[V], d[V], gm[V], o[V];
          unpack(rx[k], a);
          unpack(rd[k], d);
          gamma_of(k, v, gm);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xhat = (a[j] - mean) * rstd;
            o[j] = rstd * (d[j] * gm[j] - m1 - xhat * m2);
            dg[k][j] += d[j] * xhat;
            db[k][j] += d[j];
          }
          dxr[v] = pack(o);
        }
      }
    }
  });

  // the row slots own the same columns: add their sums in slot order. The
  // ring is free: every tile issued was waited for, and the walk ended at a
  // barrier.
  float* cols = reinterpret_cast<float*>(ring);  // [slots][2 * C]
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = lane + k * lanes;
    if (v < nv) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        cols[slot * 2 * C + v * V + j] = dg[k][j];
        cols[slot * 2 * C + C + v * V + j] = db[k][j];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    float t = 0.f;
    for (int p = 0; p < slots; ++p) t += cols[p * 2 * C + c];
    part[(int64_t)blockIdx.x * 2 * C + c] = t;
  }
}

// ---- the warp-per-row path: C not a multiple of the vector width ----------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and rstd of one row (every lane gets them)
template <typename T>
__device__ __forceinline__ void row_stats(const T* xr, int C, float eps, int lane, float& mean,
                                          float& rstd) {
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float a = vec::to_float(xr[c]);
    s += a;
    ss += a * a;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mean = s / C;
  rstd = 1.f / sqrtf(ss / C - mean * mean + eps);
}

// a warp a row, kRowWarps rows a CTA
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
layer_norm_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ y, int64_t rows,
                           int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowWarps + warp;
  if (row >= rows) return;
  const T* xr = x + row * C;
  float mean, rstd;
  row_stats<T>(xr, C, eps, lane, mean, rstd);
  for (int c = lane; c < C; c += 32) {
    y[row * C + c] = vec::from_float<T>((vec::to_float(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
  }
}

// G CTAs, each over a contiguous range of ceil(rows / G) rows, its warps on
// the range's rows in turn. Shared memory: [warps][2][C] fp32 (dgamma, dbeta;
// lane l on columns l, l + 32, ...: no bank conflicts). part: [G][2 * C].
template <typename T>
__global__ void layer_norm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                           const T* __restrict__ dy, T* __restrict__ dx,
                                           float* __restrict__ part, int64_t rows, int C,
                                           float eps) {
  extern __shared__ float smem[];
  const int G = gridDim.x, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sdg = smem + (size_t)warp * 2 * C;
  float* sdb = sdg + C;
  for (int c = lane; c < C; c += 32) sdg[c] = sdb[c] = 0.f;
  const int64_t per_cta = (rows + G - 1) / G;
  const int64_t r0 = (int64_t)blockIdx.x * per_cta;
  const int64_t r1 = min(rows, r0 + per_cta);
  const float inv_c = 1.f / C;
  for (int64_t row = r0 + warp; row < r1; row += warps) {
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    float mean, rstd;
    row_stats<T>(xr, C, eps, lane, mean, rstd);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gp = vec::to_float(dyr[c]) * gamma[c];
      m1 += gp;
      m2 += gp * ((vec::to_float(xr[c]) - mean) * rstd);
    }
    m1 = warp_sum(m1) * inv_c;
    m2 = warp_sum(m2) * inv_c;
    for (int c = lane; c < C; c += 32) {
      const float d = vec::to_float(dyr[c]);
      const float xhat = (vec::to_float(xr[c]) - mean) * rstd;
      dx[row * C + c] = vec::from_float<T>(rstd * (d * gamma[c] - m1 - xhat * m2));
      sdg[c] += d * xhat;
      sdb[c] += d;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int w = 0; w < warps; ++w) {
      g += smem[(size_t)w * 2 * C + c];
      b += smem[(size_t)w * 2 * C + C + c];
    }
    part[(int64_t)blockIdx.x * 2 * C + c] = g;
    part[(int64_t)blockIdx.x * 2 * C + C + c] = b;
  }
}

// ---- launches ----------------------------------------------------------------


// Whether the host's plan holds what the bulk kernels read and write: the
// vectors of a row over the lanes (vecs the fewest that do), whole row
// slots a tile, the ring (and the backward's column sums) in the launch's
// shared memory.
template <typename T>
bool plan_holds(const Plan& p, int C, int tensors) {
  constexpr int V = 16 / sizeof(T);
  const int nv = C / V;
  const bool lanes_ok = p.lanes >= 1 && p.lanes <= kThreads && (p.lanes & (p.lanes - 1)) == 0;
  if (!lanes_ok || p.vecs < 1 || p.vecs > kMaxVecs || (int64_t)p.vecs * p.lanes < nv ||
      (int64_t)(p.vecs - 1) * p.lanes >= nv) {
    return false;
  }
  const int slots = kThreads / p.lanes;
  const int64_t tile = (int64_t)p.tile_rows * C * sizeof(T);
  return p.tile_rows > 0 && p.tile_rows % slots == 0 && p.stages >= 2 &&
         p.stages <= kMaxStages && p.x_bytes % 128 == 0 && p.x_bytes >= tile &&
         p.stage_bytes % 128 == 0 && p.stage_bytes >= (int64_t)tensors * p.x_bytes &&
         p.smem_bytes >= (int64_t)p.stages * p.stage_bytes + 128 &&
         (tensors == 1 || p.smem_bytes >= (int64_t)slots * 2 * C * 4 + 128) &&
         p.smem_bytes <= kSmemMax && p.ctas >= 1;
}

template <typename T, int kVecs>
int launch_fwd_bulk(const void* x, const float* gamma, const float* beta, void* y, int64_t rows,
                    int C, float eps, const Plan& p, cudaStream_t stream) {
  static unsigned long long configured = 0;
  auto kernel = layer_norm_fwd_kernel<T, kVecs>;
  const int e = hopper::allow_smem(kernel, kSmemMax, configured);
  if (e != 0) return e;
  kernel<<<p.ctas, kThreads, p.smem_bytes, stream>>>(static_cast<const T*>(x), gamma, beta,
                                                     static_cast<T*>(y), rows, C, eps, p);
  return (int)cudaGetLastError();
}

template <typename T, int kVecs>
int launch_bwd_bulk(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                    int64_t rows, int C, float eps, const Plan& p, cudaStream_t stream) {
  static unsigned long long configured = 0;
  auto kernel = layer_norm_bwd_kernel<T, kVecs>;
  const int e = hopper::allow_smem(kernel, kSmemMax, configured);
  if (e != 0) return e;
  kernel<<<p.ctas, kThreads, p.smem_bytes, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), part,
      rows, C, eps, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const float* gamma, const float* beta, void* y, int64_t rows,
               int C, float eps, const Plan& p, cudaStream_t stream) {
  if (C % (16 / sizeof(T)) != 0) {
    const unsigned grid = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
    layer_norm_fwd_rows_kernel<T><<<grid, kRowWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), rows, C, eps);
    return (int)cudaGetLastError();
  }
  if (!plan_holds<T>(p, C, 1)) return (int)cudaErrorInvalidValue;
  switch (p.vecs) {
    case 1: return launch_fwd_bulk<T, 1>(x, gamma, beta, y, rows, C, eps, p, stream);
    case 2: return launch_fwd_bulk<T, 2>(x, gamma, beta, y, rows, C, eps, p, stream);
    case 3: return launch_fwd_bulk<T, 3>(x, gamma, beta, y, rows, C, eps, p, stream);
    default: return launch_fwd_bulk<T, 4>(x, gamma, beta, y, rows, C, eps, p, stream);
  }
}

template <typename T>
int launch_bwd(const void* x, const float* gamma, const void* dy, void* dx, float* part,
               void* dgb, int64_t rows, int C, float eps, int param_dtype, const Plan& p,
               cudaStream_t stream) {
  int e = 0;
  if (C % (16 / sizeof(T)) != 0) {
    // warp slices of 2 * C fp32 each: 8 warps up to C = 1024 (64 KB), 4
    // above (up to 128 KB at C = 4096)
    const int warps = C <= 1024 ? 8 : 4;
    const size_t smem = (size_t)warps * 2 * C * sizeof(float);
    static unsigned long long configured = 0;
    e = hopper::allow_smem(layer_norm_bwd_rows_kernel<T>, kSmemMax, configured);
    if (e != 0 || p.ctas < 1) return e != 0 ? e : (int)cudaErrorInvalidValue;
    layer_norm_bwd_rows_kernel<T><<<p.ctas, warps * 32, smem, stream>>>(
        static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), part,
        rows, C, eps);
    e = (int)cudaGetLastError();
  } else {
    if (!plan_holds<T>(p, C, 2)) return (int)cudaErrorInvalidValue;
    switch (p.vecs) {
      case 1: e = launch_bwd_bulk<T, 1>(x, gamma, dy, dx, part, rows, C, eps, p, stream); break;
      case 2: e = launch_bwd_bulk<T, 2>(x, gamma, dy, dx, part, rows, C, eps, p, stream); break;
      case 3: e = launch_bwd_bulk<T, 3>(x, gamma, dy, dx, part, rows, C, eps, p, stream); break;
      default: e = launch_bwd_bulk<T, 4>(x, gamma, dy, dx, part, rows, C, eps, p, stream);
    }
  }
  if (e != 0) return e;
  vec::sum_partials(part, dgb, param_dtype, p.ctas, 2 * (int64_t)C, stream);
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// What a call passes besides its tensors and stream, described once per
// shape by ops/layernorm.py `_launch_args` (its `_Launch` mirrors this layout
// field by field and is checked against layer_norm_launch_bytes at load).
struct Launch {
  long long rows;   // > 0
  int C;
  int dtype;        // x, y, dy, dx: 0 fp32, 1 bf16
  int param_dtype;  // dgamma, dbeta (the backward): 0 fp32, 1 bf16
  int device;       // the tensors' device, made current for the launches
  float eps;
  Plan plan;        // read for C a multiple of the vector width
};

size_t layer_norm_launch_bytes() { return sizeof(Launch); }

// y = LayerNorm(x) over l->rows of l->C. x, y: [rows, C] contiguous; gamma,
// beta: fp32 [C]. Returns a cudaError_t (0 on success; cudaErrorInvalidValue
// for a plan that does not hold the tiles).
int layer_norm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                   const Launch* l, void* stream) {
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l->dtype == vec::kBFloat16
      ? launch_fwd<bf16>(x, gamma, beta, y, l->rows, l->C, l->eps, l->plan, s)
      : launch_fwd<float>(x, gamma, beta, y, l->rows, l->C, l->eps, l->plan, s);
}

// dx (x's dtype) and dgb = [dgamma | dbeta] (l->param_dtype, [2, C]) of
// LayerNorm over l->rows of l->C, given x, gamma (fp32) and dy (x's dtype).
// part: fp32 scratch of [plan.ctas, 2 * C] for the CTAs' partial rows.
int layer_norm_bwd(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                   void* dgb, const Launch* l, void* stream) {
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l->dtype == vec::kBFloat16
      ? launch_bwd<bf16>(x, gamma, dy, dx, part, dgb, l->rows, l->C, l->eps, l->param_dtype,
                         l->plan, s)
      : launch_bwd<float>(x, gamma, dy, dx, part, dgb, l->rows, l->C, l->eps, l->param_dtype,
                          l->plan, s);
}

}  // extern "C"
