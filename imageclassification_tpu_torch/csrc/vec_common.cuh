// Helpers shared by the LayerNorm, depthwise-conv and 1x1-conv kernels
// (layernorm.cu, dwconv7x7.cu, conv1x1_bn.cu): fixed-width vectors of fp32 or
// bf16 with conversions to and from fp32, and the deterministic second pass
// that sums per-CTA fp32 partials.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vec {

typedef __nv_bfloat16 bf16;

// the dtype codes the Python wrappers pass
enum Dtype { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// V elements of T in one aligned load or store (16 bytes for 8 bf16 or 4 fp32)
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(float (&out)[V], const T* p) {
  const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_float(a.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Vec<T, V> a;
#pragma unroll
  for (int j = 0; j < V; ++j) a.v[j] = from_float<T>(in[j]);
  *reinterpret_cast<Vec<T, V>*>(p) = a;
}

// out[n] = sum over p of part[p * N + n], p in order within each of 8 row
// groups and the 8 group sums in order: the same result on every run. Block
// (32, 8), grid ceil(N / 32).
template <typename OT>
__global__ void sum_partials_kernel(const float* __restrict__ part, OT* __restrict__ out,
                                    int P, int64_t N) {
  __shared__ float sums[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t n = (int64_t)blockIdx.x * 32 + tx;
  float s = 0.f;
  if (n < N) {
    for (int p = ty; p < P; p += 8) s += part[(int64_t)p * N + n];
  }
  sums[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += sums[i][tx];
    out[n] = from_float<OT>(t);
  }
}

inline void sum_partials(const float* part, void* out, int out_dtype, int P, int64_t N,
                         cudaStream_t stream) {
  const dim3 block(32, 8), grid((unsigned)((N + 31) / 32));
  if (out_dtype == kBFloat16) {
    sum_partials_kernel<bf16><<<grid, block, 0, stream>>>(part, static_cast<bf16*>(out), P, N);
  } else {
    sum_partials_kernel<float><<<grid, block, 0, stream>>>(part, static_cast<float*>(out), P, N);
  }
}

}  // namespace vec
