// 7x7 depthwise convolution, NHWC, stride 1, zero padding 3, for sm_90a:
// the forward (also the input gradient) and the weight gradient.
//
// Replaces `depthwise_conv7x7` of imageclassification_tpu/ops/pallas_dwconv.py:
// the Pallas TPU kernel `_kernel` (:43) behind `_dwconv_pallas` (pallas_call
// at :58), which runs the forward on a `jnp.pad`-ed input (:95) and the input
// gradient on the padded output gradient with the spatially flipped kernel
// (:107-109); and the weight gradient, 49 shifted reductions that the JAX
// package leaves to XLA (:111-120).
//
//   out[b, h, w, c] = sum_{ky, kx} x[b, h + ky - 3, w + kx - 3, c] * k[ky, kx, c]
//   dx  = the same on dy with k[6 - ky, 6 - kx, c] (flip = 1)
//   dw[ky, kx, c] = sum_{b, h, w} x[b, h + ky - 3, w + kx - 3, c] * dy[b, h, w, c]
// with x outside the image read as 0, fp32 accumulation, the output in x's
// dtype (dw in w's dtype).
//
// What bounds it on an H100: operations. 2 * 49 flops per output element on
// the CUDA cores in fp32 (a depthwise conv has no tensor-core form) against
// 2 bytes read and 2 written per bf16 element: at 67 TFLOP/s and 3.35 TB/s
// the flops take about 1.2x as long as the bytes. So the design feeds the
// FMAs from registers and shared memory, not from device memory: one CTA per
// (batch, 8x8 output tile, 32 channels) copies its input tile with the 3-pixel
// halo (14x14x32) into shared memory with 16-byte cp.async loads (channels
// contiguous, so neighbouring threads read neighbouring bytes), zero-filling
// the border in the copy itself (source size 0) instead of padding the
// tensor; each thread owns 8 channels of a strip of 4 output pixels, holds
// one 10-pixel input row of the window in registers per kernel row and runs
// the 7 kernel columns over it (fp32 FMAs, 32 accumulators in registers).
//
// The weight gradient is a reduction over every pixel of the batch: CTAs
// (P slots x channel tiles) each walk over (batch, tile) items, stage x with
// its halo and dy in shared memory, and accumulate 49 taps x 8 channels per
// thread in registers; each CTA writes one fp32 partial row of [49 * C] and
// vec::sum_partials adds the P rows in a fixed order. No atomics: the same
// result on every run.

#include "vec_common.cuh"

namespace {

using vec::bf16;

constexpr int kK = 7, kPad = 3, kTaps = kK * kK;
constexpr int kTile = 8;                   // output tile kTile x kTile
constexpr int kIn = kTile + 2 * kPad;      // input tile with the halo, 14
constexpr int kCT = 32;                    // channels per CTA
constexpr int kCV = 8;                     // channels per thread
constexpr int kGroups = kCT / kCV;         // 4 channel groups
constexpr int kStrip = 4;                  // output pixels per thread along w
constexpr int kThreads = kGroups * kTile * (kTile / kStrip);  // 64

// Copy the rows [h0 - 3, h0 + 11) x columns [w0 - 3, w0 + 11) x channels
// [c0, c0 + 32) of image b into s (pixel-major, 32 channels a pixel); pixels
// outside the image and channels >= C become zeros.
template <typename T>
__device__ __forceinline__ void load_halo_tile(T* s, const T* x, int b, int h0, int w0, int c0,
                                               int H, int W, int C) {
  constexpr int kChunk = 16 / sizeof(T);         // channels per 16-byte copy
  constexpr int kChunks = kCT / kChunk;          // copies per pixel
  for (int i = threadIdx.x; i < kIn * kIn * kChunks; i += kThreads) {
    const int p = i / kChunks, ch = i % kChunks;
    const int gy = h0 - kPad + p / kIn, gx = w0 - kPad + p % kIn, c = c0 + ch * kChunk;
    const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
    const T* src = valid ? x + (((int64_t)b * H + gy) * W + gx) * C + c : x;
    vec::cp_async_16(s + p * kCT + ch * kChunk, src, valid);
  }
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads)
dwconv7x7_fwd_kernel(const T* __restrict__ x, const WT* __restrict__ w, T* __restrict__ out,
                     int H, int W, int C, int flip) {
  __shared__ __align__(16) T sx[kIn * kIn * kCT];
  __shared__ __align__(16) float sw[kTaps * kCT];
  const int tiles_w = (W + kTile - 1) / kTile;
  const int h0 = (blockIdx.x / tiles_w) * kTile, w0 = (blockIdx.x % tiles_w) * kTile;
  const int c0 = blockIdx.y * kCT, b = blockIdx.z;
  load_halo_tile<T>(sx, x, b, h0, w0, c0, H, W, C);
  for (int i = threadIdx.x; i < kTaps * kCT; i += kThreads) {
    const int tap = i / kCT, c = c0 + i % kCT;
    // flip: tap (ky, kx) reads k[6 - ky, 6 - kx], whose index is 48 - tap
    sw[i] = c < C ? vec::to_float(w[(int64_t)(flip ? kTaps - 1 - tap : tap) * C + c]) : 0.f;
  }
  vec::cp_async_wait_all();
  __syncthreads();

  const int g = threadIdx.x % kGroups;
  const int strip = (threadIdx.x / kGroups) % (kTile / kStrip);
  const int r = threadIdx.x / (kGroups * (kTile / kStrip));
  const int c = c0 + g * kCV;
  if (c >= C) return;
  float acc[kStrip][kCV];
#pragma unroll
  for (int i = 0; i < kStrip; ++i)
#pragma unroll
    for (int j = 0; j < kCV; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int ky = 0; ky < kK; ++ky) {
    float in[kStrip + kK - 1][kCV];
#pragma unroll
    for (int q = 0; q < kStrip + kK - 1; ++q)
      vec::load<T, kCV>(in[q], sx + ((r + ky) * kIn + strip * kStrip + q) * kCT + g * kCV);
#pragma unroll
    for (int kx = 0; kx < kK; ++kx) {
      float wv[kCV];
      vec::load<float, kCV>(wv, sw + (ky * kK + kx) * kCT + g * kCV);
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
#pragma unroll
        for (int j = 0; j < kCV; ++j) acc[i][j] = fmaf(in[i + kx][j], wv[j], acc[i][j]);
    }
  }
  const int oy = h0 + r;
  if (oy >= H) return;
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    const int ox = w0 + strip * kStrip + i;
    if (ox < W) vec::store<T, kCV>(out + (((int64_t)b * H + oy) * W + ox) * C + c, acc[i]);
  }
}

// Grid (P, C / 32 rounded up). CTA (slot, channel tile) sums the items
// slot, slot + P, ... of the B * tiles (batch, 8x8 tile) items. Thread t owns
// channel group t % 4 and the taps t / 4, t / 4 + 16, t / 4 + 32 (and 48 for
// t / 4 == 0). part: [P, 49 * C] fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dwconv7x7_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ part,
                    int B, int H, int W, int C) {
  __shared__ __align__(16) T sx[kIn * kIn * kCT];
  __shared__ __align__(16) T sdy[kTile * kTile * kCT];
  constexpr int kChunk = 16 / sizeof(T), kChunks = kCT / kChunk;
  constexpr int kMyTaps = (kTaps + kThreads / kGroups - 1) / (kThreads / kGroups);  // 4
  const int tiles_w = (W + kTile - 1) / kTile;
  const int tiles = tiles_w * ((H + kTile - 1) / kTile);
  const int64_t items = (int64_t)B * tiles;
  const int c0 = blockIdx.y * kCT;
  const int g = threadIdx.x % kGroups, t0 = threadIdx.x / kGroups;
  const int c = c0 + g * kCV;
  float acc[kMyTaps][kCV];
#pragma unroll
  for (int k = 0; k < kMyTaps; ++k)
#pragma unroll
    for (int j = 0; j < kCV; ++j) acc[k][j] = 0.f;

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = (int)(item / tiles), tile = (int)(item % tiles);
    const int h0 = (tile / tiles_w) * kTile, w0 = (tile % tiles_w) * kTile;
    __syncthreads();  // the previous item's reads of sx, sdy are done
    load_halo_tile<T>(sx, x, b, h0, w0, c0, H, W, C);
    for (int i = threadIdx.x; i < kTile * kTile * kChunks; i += kThreads) {
      const int p = i / kChunks, ch = i % kChunks;
      const int gy = h0 + p / kTile, gx = w0 + p % kTile, cc = c0 + ch * kChunk;
      const bool valid = gy < H && gx < W && cc < C;
      const T* src = valid ? dy + (((int64_t)b * H + gy) * W + gx) * C + cc : dy;
      vec::cp_async_16(sdy + p * kCT + ch * kChunk, src, valid);
    }
    vec::cp_async_wait_all();
    __syncthreads();
    if (c >= C) continue;
#pragma unroll 1
    for (int p = 0; p < kTile * kTile; ++p) {
      const int py = p / kTile, px = p % kTile;
      float d[kCV];
      vec::load<T, kCV>(d, sdy + p * kCT + g * kCV);
#pragma unroll
      for (int k = 0; k < kMyTaps; ++k) {
        const int tap = t0 + k * (kThreads / kGroups);
        if (tap < kTaps) {
          float a[kCV];
          vec::load<T, kCV>(a, sx + ((py + tap / kK) * kIn + px + tap % kK) * kCT + g * kCV);
#pragma unroll
          for (int j = 0; j < kCV; ++j) acc[k][j] = fmaf(a[j], d[j], acc[k][j]);
        }
      }
    }
  }
  if (c >= C) return;
#pragma unroll
  for (int k = 0; k < kMyTaps; ++k) {
    const int tap = t0 + k * (kThreads / kGroups);
    if (tap < kTaps) {
      vec::store<float, kCV>(part + (int64_t)blockIdx.x * kTaps * C + (int64_t)tap * C + c,
                             acc[k]);
    }
  }
}

dim3 fwd_grid(int B, int H, int W, int C) {
  return dim3((unsigned)(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile)),
              (unsigned)((C + kCT - 1) / kCT), (unsigned)B);
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* out, int B, int H, int W, int C, int flip,
               int w_dtype, cudaStream_t stream) {
  const dim3 grid = fwd_grid(B, H, W, C);
  if (w_dtype == vec::kBFloat16) {
    dwconv7x7_fwd_kernel<T, bf16><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const bf16*>(w), static_cast<T*>(out), H, W, C,
        flip);
  } else {
    dwconv7x7_fwd_kernel<T, float><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), H, W, C,
        flip);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, float* part, void* dw, int B, int H, int W, int C,
              int P, int w_dtype, cudaStream_t stream) {
  const dim3 grid((unsigned)P, (unsigned)((C + kCT - 1) / kCT));
  dwconv7x7_dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, B, H, W, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  vec::sum_partials(part, dw, w_dtype, P, (int64_t)kTaps * C, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = depthwise 7x7 conv of x with k (flip = 1: with k flipped in both
// spatial axes, which gives the input gradient when x is the output
// gradient). x, out: [B, H, W, C] contiguous, x_dtype 0 fp32 or 1 bf16;
// k: [7, 7, C] contiguous, w_dtype 0 fp32 or 1 bf16; C a multiple of 8.
// Returns a cudaError_t (0 on success).
int dwconv7x7_fwd(const void* x, const void* k, void* out, int B, int H, int W, int C, int flip,
                  int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == vec::kBFloat16 ? launch_fwd<bf16>(x, k, out, B, H, W, C, flip, w_dtype, s)
                                   : launch_fwd<float>(x, k, out, B, H, W, C, flip, w_dtype, s);
}

// dw [7, 7, C] (w_dtype) = the weight gradient for input x and output
// gradient dy ([B, H, W, C] contiguous, x_dtype). part: fp32 scratch of
// [P, 49 * C] for the P slots' partial sums.
int dwconv7x7_dw(const void* x, const void* dy, float* part, void* dw, int B, int H, int W,
                 int C, int P, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == vec::kBFloat16
      ? launch_dw<bf16>(x, dy, part, dw, B, H, W, C, P, w_dtype, s)
      : launch_dw<float>(x, dy, part, dw, B, H, W, C, P, w_dtype, s);
}

}  // extern "C"
