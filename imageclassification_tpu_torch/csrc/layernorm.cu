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
// 10 and 20 flops per element are far below the card's flop rate. So the
// design reads each row in 16-byte vectors by one warp (8 bf16 or 4 fp32 a
// lane, neighbouring lanes on neighbouring addresses), keeps the statistics
// in registers (warp shuffles, no shared memory in the forward), and reads
// the row again from L1/L2 for the later passes instead of holding up to
// 4096 values a row in registers. Any row count is taken (a warp per row, the
// tail masked); any C <= 4096, with a scalar path when C is not a multiple of
// the vector width.
//
// dgamma/dbeta without atomics: each warp of the backward sums its rows'
// dy * xhat and dy into its own slice of shared memory (each lane only its
// own columns), the CTA then adds its warps' slices in order into one fp32
// partial row per CTA, and a second kernel (vec::sum_partials) adds the
// partial rows in a fixed order. The result is the same on every run.

#include "vec_common.cuh"

namespace {

using vec::bf16;

constexpr int kFwdWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and rstd of one row (every lane gets them)
template <typename T, int V>
__device__ __forceinline__ void row_stats(const T* xr, int C, float eps, int lane, float& mean,
                                          float& rstd) {
  float s = 0.f, ss = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    float a[V];
    vec::load<T, V>(a, xr + c);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s += a[j];
      ss += a[j] * a[j];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mean = s / C;
  const float var = ss / C - mean * mean;
  rstd = 1.f / sqrtf(var + eps);
}

template <typename T, int V>
__global__ void __launch_bounds__(kFwdWarps * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y, int64_t rows, int C,
                      float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kFwdWarps + warp;
  if (row >= rows) return;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  float mean, rstd;
  row_stats<T, V>(xr, C, eps, lane, mean, rstd);
  for (int c = lane * V; c < C; c += 32 * V) {
    float a[V], g[V], b[V], o[V];
    vec::load<T, V>(a, xr + c);
    vec::load<float, V>(g, gamma + c);
    vec::load<float, V>(b, beta + c);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = (a[j] - mean) * rstd * g[j] + b[j];
    vec::store<T, V>(yr + c, o);
  }
}

// One CTA per contiguous range of ceil(rows / G) rows; its warps take the
// range's rows in turn. Shared memory: [warps][2][C] fp32 (dgamma, dbeta).
// part: [2][G][C] fp32, the CTA's dgamma row at part[blockIdx.x], its dbeta
// row at part[G + blockIdx.x].
template <typename T, int V>
__global__ void layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                      const T* __restrict__ dy, T* __restrict__ dx,
                                      float* __restrict__ part, int64_t rows, int C, int G,
                                      float eps) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sdg = smem + (size_t)warp * 2 * C;
  float* sdb = sdg + C;
  for (int c = lane * V; c < C; c += 32 * V) {
#pragma unroll
    for (int j = 0; j < V; ++j) sdg[c + j] = sdb[c + j] = 0.f;
  }
  const int64_t per_cta = (rows + G - 1) / G;
  const int64_t r0 = (int64_t)blockIdx.x * per_cta;
  const int64_t r1 = min(rows, r0 + per_cta);
  const float inv_c = 1.f / C;
  for (int64_t row = r0 + warp; row < r1; row += warps) {
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    float mean, rstd;
    row_stats<T, V>(xr, C, eps, lane, mean, rstd);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane * V; c < C; c += 32 * V) {
      float a[V], d[V], g[V];
      vec::load<T, V>(a, xr + c);
      vec::load<T, V>(d, dyr + c);
      vec::load<float, V>(g, gamma + c);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gp = d[j] * g[j];
        m1 += gp;
        m2 += gp * ((a[j] - mean) * rstd);
      }
    }
    m1 = warp_sum(m1) * inv_c;
    m2 = warp_sum(m2) * inv_c;
    for (int c = lane * V; c < C; c += 32 * V) {
      float a[V], d[V], g[V], o[V];
      vec::load<T, V>(a, xr + c);
      vec::load<T, V>(d, dyr + c);
      vec::load<float, V>(g, gamma + c);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xhat = (a[j] - mean) * rstd;
        o[j] = rstd * (d[j] * g[j] - m1 - xhat * m2);
        sdg[c + j] += d[j] * xhat;
        sdb[c + j] += d[j];
      }
      vec::store<T, V>(dx + row * C + c, o);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int w = 0; w < warps; ++w) {
      g += smem[(size_t)w * 2 * C + c];
      b += smem[(size_t)w * 2 * C + C + c];
    }
    part[(int64_t)blockIdx.x * C + c] = g;
    part[((int64_t)G + blockIdx.x) * C + c] = b;
  }
}

template <typename T, int V>
int launch_fwd(const void* x, const float* gamma, const float* beta, void* y, int64_t rows,
               int C, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kFwdWarps - 1) / kFwdWarps);
  layer_norm_fwd_kernel<T, V><<<grid, kFwdWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), rows, C, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* x, const float* gamma, const void* dy, void* dx, float* part,
               void* dgamma, void* dbeta, int64_t rows, int C, int G, float eps,
               int param_dtype, cudaStream_t stream) {
  // warp slices of 2 * C fp32 each: 8 warps up to C = 1024 (64 KB), 4 above
  // (up to 128 KB at C = 4096)
  const int warps = C <= 1024 ? 8 : 4;
  const size_t smem = (size_t)warps * 2 * C * sizeof(float);
  auto kernel = layer_norm_bwd_kernel<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<G, warps * 32, smem, stream>>>(static_cast<const T*>(x), gamma,
                                          static_cast<const T*>(dy), static_cast<T*>(dx), part,
                                          rows, C, G, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  vec::sum_partials(part, dgamma, param_dtype, G, C, stream);
  vec::sum_partials(part + (int64_t)G * C, dbeta, param_dtype, G, C, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = LayerNorm(x) over rows of C. x, y: [rows, C] contiguous, dtype 0 fp32
// or 1 bf16; gamma, beta: fp32 [C]. Returns a cudaError_t (0 on success).
int layer_norm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                   long long rows, int C, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vec::kBFloat16) {
    return C % 8 == 0 ? launch_fwd<bf16, 8>(x, gamma, beta, y, rows, C, eps, s)
                      : launch_fwd<bf16, 1>(x, gamma, beta, y, rows, C, eps, s);
  }
  return C % 4 == 0 ? launch_fwd<float, 4>(x, gamma, beta, y, rows, C, eps, s)
                    : launch_fwd<float, 1>(x, gamma, beta, y, rows, C, eps, s);
}

// dx (x's dtype), dgamma and dbeta (param_dtype, 0 fp32 or 1 bf16) of
// LayerNorm over rows of C, given x, gamma (fp32) and dy (x's dtype). part:
// fp32 scratch of [2, G, C] for the G CTAs' partial sums.
int layer_norm_bwd(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                   void* dgamma, void* dbeta, long long rows, int C, int G, float eps,
                   int dtype, int param_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vec::kBFloat16) {
    return C % 8 == 0
        ? launch_bwd<bf16, 8>(x, gamma, dy, dx, part, dgamma, dbeta, rows, C, G, eps,
                              param_dtype, s)
        : launch_bwd<bf16, 1>(x, gamma, dy, dx, part, dgamma, dbeta, rows, C, G, eps,
                              param_dtype, s);
  }
  return C % 4 == 0
      ? launch_bwd<float, 4>(x, gamma, dy, dx, part, dgamma, dbeta, rows, C, G, eps,
                             param_dtype, s)
      : launch_bwd<float, 1>(x, gamma, dy, dx, part, dgamma, dbeta, rows, C, G, eps,
                             param_dtype, s);
}

}  // extern "C"
