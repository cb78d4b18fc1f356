// Fused 1x1 conv + BatchNorm statistics for sm_90a: y = maybe_relu(x * scale
// + shift) @ W with fp32 accumulation on the tensor cores, y stored in bf16,
// and the per-column sum and sum of squares of the fp32 accumulator (not of
// the rounded y), for x [M, K] and W [K, N] bf16, row-major.
//
// Replaces imageclassification_tpu/ops/pallas_conv1x1_bn.py: `_kernel` (:85,
// the plain variant) and `_kernel_bn_in` (:95, the prologue variant) behind
// `conv1x1_bn_stats` (:132).
//
// What bounds it on an H100: bytes at every ResNet-50 1x1 shape but the last
// stage (M = B*H*W rows against K, N <= 2048: 2MKN flops over 989 TFLOP/s
// stay below the bytes of x and y over 3.35 TB/s), where the operations bind
// (M = 3136 at batch 64, K x N = 512 x 2048). What the design does about it:
// x and y cross device memory once each (the prologue is applied to the x
// tile in shared memory, the statistics are taken from the accumulators in
// registers), W tiles are re-read from L2; the tile loads are cp.async
// double-buffered behind mma.sync.
//
// What the TPU kernel leaned on that Hopper lacks:
// * the whole (K, N) weight resident in VMEM: here a CTA computes a 128 x 128
//   tile of y, stepping over K in 32-deep slices of x and W held in shared
//   memory (two stages, 32 KB);
// * statistics carried across sequential grid steps: CTAs run in no order,
//   so each writes the fp32 column partials of its M-tile, reduced over its
//   warps in shared memory, and a second pass (vec::sum_partials) sums the
//   partials in a fixed order; no atomics, the same bits on every run;
// * M a multiple of 128: here any M; rows past M are zero-filled, never
//   stored and left out of the statistics. K and N must be multiples of 8
//   (16-byte rows), which the wrapper checks.
//
// The prologue rounds maybe_relu(x * scale + shift) (fp32 multiply, then
// add, as the plain version) to bf16 before the product, as `_kernel_bn_in`
// rounds to the weight's dtype.

#include "mma_common.cuh"
#include "vec_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWarpM = kBM / kWarpsM;  // 64 rows a warp
constexpr int kWarpN = kBN / kWarpsN;  // 32 columns a warp
constexpr int kMT = kWarpM / 16;       // m16 tiles a warp
constexpr int kNT = kWarpN / 8;        // n8 tiles a warp
constexpr int kAChunks = kBK / 8;      // 16-byte chunks in a row of the x tile
constexpr int kBChunks = kBN / 8;      // 16-byte chunks in a row of the W tile
constexpr int kLoads = kBM * kAChunks / kThreads;  // chunks a thread copies of each tile
static_assert(kBM * kAChunks == kBK * kBChunks, "x and W tiles have the same chunk count");

// x tile [kBM][kBK] (64-byte rows): chunk c of row r sits at chunk
// c ^ ((r >> 1) & 3), so the 8 rows of an ldmatrix fall in 8 bank groups.
__device__ __forceinline__ int x_off(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// W tile [kBK][kBN] (256-byte rows): chunk c of row r at chunk c ^ (r & 7).
__device__ __forceinline__ int w_off(int row, int chunk) {
  return row * kBN + ((chunk ^ (row & 7)) << 3);
}

// Copy the x and W tiles of K-slice k0 into shared memory; chunks past M, K
// or N are zero-filled. A thread copies chunks tid and tid + kThreads of each.
__device__ __forceinline__ void load_tiles(bf16* xs, bf16* ws, const bf16* x, const bf16* w,
                                           int64_t m0, int n0, int k0, int64_t M, int K, int N,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kAChunks, chunk = c % kAChunks;
    const int64_t m = m0 + row;
    const int k = k0 + chunk * 8;
    const bool valid = m < M && k < K;
    vec::cp_async_16(xs + x_off(row, chunk), valid ? x + m * K + k : x, valid);
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kBChunks, chunk = c % kBChunks;
    const int k = k0 + row, n = n0 + chunk * 8;
    const bool valid = k < K && n < N;
    vec::cp_async_16(ws + w_off(row, chunk), valid ? w + (int64_t)k * N + n : w, valid);
  }
}

// x <- bf16(maybe_relu(x * scale + shift)) on the chunks of the x tile that
// this thread copied (so its own cp.async wait covers them); columns past K
// stay zero.
template <bool kRelu>
__device__ __forceinline__ void prologue(bf16* xs, const float* __restrict__ scale,
                                         const float* __restrict__ shift, int k0, int K,
                                         int tid) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kAChunks, chunk = c % kAChunks;
    const int k = k0 + chunk * 8;
    if (k >= K) continue;
    float v[8], sc[2][4], sh[2][4];
    bf16* p = xs + x_off(row, chunk);
    vec::load<bf16, 8>(v, p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      vec::load<float, 4>(sc[h], scale + k + 4 * h);
      vec::load<float, 4>(sh[h], shift + k + 4 * h);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __fadd_rn(__fmul_rn(v[j], sc[j >> 2][j & 3]), sh[j >> 2][j & 3]);
      if (kRelu) v[j] = v[j] < 0.f ? 0.f : v[j];  // keeps a NaN, as relu does
    }
    vec::store<bf16, 8>(p, v);
  }
}

// One CTA: the 128 x 128 tile (blockIdx.x, blockIdx.y) of y and its column
// partials part[0][blockIdx.x][n] (sum) and part[1][blockIdx.x][n] (sum of
// squares), part being [2, gridDim.x, N].
template <bool kBnIn, bool kRelu>
__global__ void __launch_bounds__(kThreads)
conv1x1_bn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  bf16* __restrict__ y, float* __restrict__ part, int64_t M, int K, int N) {
  __shared__ __align__(128) bf16 xs[2][kBM * kBK];
  __shared__ __align__(128) bf16 ws[2][kBK * kBN];
  __shared__ float red[2][kWarpsM][kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kt_count = (K + kBK - 1) / kBK;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  load_tiles(xs[0], ws[0], x, w, m0, n0, 0, M, K, N, tid);
  for (int kt = 0; kt < kt_count; ++kt) {
    const int buf = kt & 1;
    vec::cp_async_wait_all();  // this thread's copies of slice kt have landed
    if (kBnIn) prologue<kRelu>(xs[buf], scale, shift, kt * kBK, K, tid);
    // slice kt is complete for every thread, and every thread is done with
    // slice kt - 1, whose buffers the next copy overwrites
    __syncthreads();
    if (kt + 1 < kt_count)
      load_tiles(xs[buf ^ 1], ws[buf ^ 1], x, w, m0, n0, (kt + 1) * kBK, M, K, N, tid);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      unsigned a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int row = wm * kWarpM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        mma::ldmatrix_x4(a[i], xs[buf] + x_off(row, ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        unsigned f[4];
        const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int chunk = (wn * kWarpN + jp * 16) / 8 + (lane >> 4);
        mma::ldmatrix_x4_trans(f, ws[buf] + w_off(krow, chunk));
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma::mma_16816(acc[i][2 * jp], a[i], f[0], f[1]);
          mma::mma_16816(acc[i][2 * jp + 1], a[i], f[2], f[3]);
        }
      }
    }
  }

  // epilogue: store y (rows < M, columns < N) and sum the thread's rows of
  // each of its columns, from the fp32 accumulators
  const int g = lane >> 2, t = lane & 3;
  float s[kNT][2], q[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = q[j][0] = q[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * kWarpM + i * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + wn * kWarpN + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (n < N) *reinterpret_cast<unsigned*>(y + m * N + n) = mma::pack_bf16(v0, v1);
        s[j][0] += v0;
        s[j][1] += v1;
        q[j][0] += v0 * v0;
        q[j][1] += v1 * v1;
      }
    }
  }
  // over the 8 row groups g of the warp (lanes t, t + 4, ..., t + 28)
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
        q[j][e] += __shfl_xor_sync(0xffffffffu, q[j][e], off);
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * kWarpN + j * 8 + 2 * t + e;
        red[0][wm][col] = s[j][e];
        red[1][wm][col] = q[j][e];
      }
    }
  }
  __syncthreads();
  // over the CTA's warps along M, in order: one column a thread
  if (tid < kBN && n0 + tid < N) {
    const int64_t P = gridDim.x;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarpsM; ++wi) v += red[r][wi][tid];
      part[((int64_t)r * P + blockIdx.x) * N + n0 + tid] = v;
    }
  }
}

}  // namespace

// y [M, N] bf16 and stats [2, N] fp32 (column sums, then sums of squares) of
// maybe_relu(x * scale + shift) @ w, the prologue only when `scale` is not
// null. part: [2, ceil(M / 128), N] fp32 scratch. Pointers 16-byte aligned,
// K and N multiples of 8. Returns the CUDA error of the launches.
extern "C" int conv1x1_bn_stats(const void* x, const void* w, const float* scale,
                                const float* shift, void* y, float* part, float* stats,
                                long long M, int K, int N, int relu, void* stream) {
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  if (scale == nullptr) {
    conv1x1_bn_kernel<false, false><<<grid, kThreads, 0, s>>>(xb, wb, scale, shift, yb, part, M,
                                                              K, N);
  } else if (relu) {
    conv1x1_bn_kernel<true, true><<<grid, kThreads, 0, s>>>(xb, wb, scale, shift, yb, part, M,
                                                            K, N);
  } else {
    conv1x1_bn_kernel<true, false><<<grid, kThreads, 0, s>>>(xb, wb, scale, shift, yb, part, M,
                                                             K, N);
  }
  const int P = (int)grid.x;
  vec::sum_partials(part, stats, vec::kFloat32, P, N, s);
  vec::sum_partials(part + (int64_t)P * N, stats + N, vec::kFloat32, P, N, s);
  return (int)cudaGetLastError();
}
