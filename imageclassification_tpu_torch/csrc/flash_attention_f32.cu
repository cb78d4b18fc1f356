// Flash attention's forward in fp32 for Hopper (sm_90a), fp32 in and out,
// head_dim 64.
//
// Replaces: imageclassification_tpu/models/vit.py:25 `flash_attention_fn` in a
// model whose dtype is fp32 (`--half_precision false`), where the JAX package
// hands the Pallas TPU kernel (jax.experimental.pallas.ops.tpu.flash_attention)
// fp32 q, k and v: the forward (`_flash_attention_impl`, flash_attention.py:758).
// Its backward in fp32 is flash_attention_f32_bwd.cu; the bf16 kernels are
// flash_attention_fwd.cu and flash_attention_bwd.cu.
//
// Arithmetic: what the JAX kernel computes in fp32. Every product and every
// sum is an fp32 FFMA or FADD on the CUDA cores: no tensor core (no TF32, no
// bf16 round trip). The softmax runs online in fp32, with the scale folded
// into log2(e) and exp2f; the forward writes the natural-log row
// log-sum-exp lse = m + log(l) as fp32 [B, H, N] when autograd will run the
// backward, which recomputes P = exp(S * scale - lse) from it. The ragged
// tail is masked in the kernel: key columns >= N get P = 0, query rows >= N
// load as zeros and are never stored. Nothing is padded in memory. Every sum
// runs in one fixed order (no atomics), so two runs are bitwise equal.
//
// What bounds it on an H100: 4*B*H*N^2*64 flops (S and P V) against 66.9
// TFLOP/s of fp32 on the CUDA cores; the bytes (each of q, k, v read once, o
// written once, 4 bytes an element) bound it only at small N. So the
// products bound it, and the design keeps the FFMA pipes fed from shared
// memory: each thread owns a 4 x 8 block of a 64 x 64 product and reads its
// operands as 16-byte vectors (4 FFMA a loaded element), from tiles whose
// padded row pitch keeps a warp's loads free of bank conflicts.
//
// Design (simple; one CTA of 128 threads for each (batch, head, 64-row
// block), the 64-row K/V tiles streamed through shared memory):
//   * thread t owns rows r + 16 i (r = t / 8, i = 0..3) and columns c + 8 j
//     (c = t % 8, j = 0..7) of each 64 x 64 score tile, and the same rows
//     and head dims 4c..4c+3, 32+4c..32+4c+3 of the 64 x 64 accumulator;
//     the 8 threads of a row group are lanes of one warp, so row maxima and
//     sums are three shuffles, and a warp reads back only the rows of the P
//     tile that it wrote (a __syncwarp between);
//   * Q tile once, then K/V tiles; S = Q K^T, online softmax, P through
//     shared memory, O += P V; O / l at the end.
// Tiles are loaded with 16-byte loads from the strided [B, N, H, 64] views
// (the q, k, v views of the fused qkv projection as they lie) and stored to
// shared memory with a pitch of 68 floats (72 for the P tile).

#include "flash_attention_common.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kRows = 64;      // rows of a tile (queries or keys)
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kLd = 68;        // pitch of the Q, K, V tiles (floats)
constexpr int kLdP = 72;       // pitch of the P tile (floats)
constexpr int kTile = kRows * kLd;
constexpr int kTileP = kRows * kLdP;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kFwdSmem = (3 * kTile + kTileP) * 4;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows row0 .. row0 + 63 of one (batch, head) of a strided [B, N, H, 64]
// view (`base` already at the batch and head; `sn` the row stride in
// floats) into a tile of pitch kLd; rows >= N as zeros
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long sn, int row0,
                                          int N, int t) {
#pragma unroll
  for (int it = 0; it < kRows * (kD / 4) / kThreads; ++it) {
    const int idx = t + it * kThreads;
    const int row = idx >> 4, chunk = idx & 15;
    const int n = row0 + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N) v = ld4(base + (long long)n * sn + chunk * 4);
    *reinterpret_cast<float4*>(tile + row * kLd + chunk * 4) = v;
  }
}

// acc[i][0..7] (rows r + 16 i, dims 4c..4c+3 and 32+4c..32+4c+3) +=
// sum over the 64 columns k of a[row][k] * b[k][dims]: a of pitch kLdP
// (P or dS), b of pitch kLd
__device__ __forceinline__ void accumulate_pv(float (&acc)[4][8], const float* a, const float* b,
                                              int r, int c) {
#pragma unroll 2
  for (int k = 0; k < kRows; k += 4) {
    float4 a4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a4[i] = ld4(a + (r + 16 * i) * kLdP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = ld4(b + (k + kk) * kLd + 4 * c);
      const float4 b1 = ld4(b + (k + kk) * kLd + 32 + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
        axpy4(av, b0, &acc[i][0]);
        axpy4(av, b1, &acc[i][4]);
      }
    }
  }
}

// s[i][j] = sum over the head dims of x[r + 16 i] * y[c + 8 j] (both pitch kLd)
__device__ __forceinline__ void scores(float (&s)[4][8], const float* x, const float* y, int r,
                                       int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 x4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x4[i] = ld4(x + (r + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 y4 = ld4(y + (c + 8 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = dot4(x4[i], y4, s[i][j]);
    }
  }
}

// the sum or max over the 8 lanes of a row group
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

// rows r + 16 i of acc times scale[i] into rows row0 + r + 16 i (< N) of a
// contiguous [B, N, H, 64] tensor at (b, h)
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][8],
                                           const float (&scale)[4], int b, int h, int row0,
                                           int N, int H, int r, int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + r + 16 * i;
    if (n >= N) continue;
    float* p = out + (((long long)b * N + n) * H + h) * kD;
    *reinterpret_cast<float4*>(p + 4 * c) =
        make_float4(acc[i][0] * scale[i], acc[i][1] * scale[i], acc[i][2] * scale[i],
                    acc[i][3] * scale[i]);
    *reinterpret_cast<float4*>(p + 32 + 4 * c) =
        make_float4(acc[i][4] * scale[i], acc[i][5] * scale[i], acc[i][6] * scale[i],
                    acc[i][7] * scale[i]);
  }
}

// strides in floats: sb, sn, sh of the q/k/v views
struct Strides {
  long long b, n, h;
};

__device__ __forceinline__ Strides floats(const long long (&bytes)[3]) {
  // FlashLaunch keeps byte strides on H, N, B
  return {bytes[2] / 4, bytes[1] / 4, bytes[0] / 4};
}

__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, float* __restrict__ o,
                                   float* __restrict__ lse, FlashLaunch l, int num_blocks,
                                   float scale_log2) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTile;
  float* sv = sk + kTile;
  float* sp = sv + kTile;
  const int N = l.N, H = l.H;
  const int t = threadIdx.x, r = t >> 3, c = t & 7;
  const int m0 = (blockIdx.x % num_blocks) * kRows;
  const int bh = blockIdx.x / num_blocks, b = bh / H, h = bh % H;
  const Strides s = floats(l.qkv_stride);
  const long long head = b * s.b + h * s.h;

  load_tile(sq, q + head, s.n, m0, N, t);
  float acc[4][8], m[4], sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int key0 = 0; key0 < N; key0 += kRows) {
    __syncthreads();  // the previous tile's K and V are read
    load_tile(sk, k + head, s.n, key0, N, t);
    load_tile(sv, v + head, s.n, key0, N, t);
    __syncthreads();
    float p[4][8];
    scores(p, sq, sk, r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[i][j] = key0 + c + 8 * j < N ? p[i][j] * scale_log2 : -INFINITY;
        mt = fmaxf(mt, p[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[i][j] = exp2f(p[i][j] - m_new);
        rs += p[i][j];
        sp[(r + 16 * i) * kLdP + c + 8 * j] = p[i][j];
      }
      sum[i] = sum[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a warp reads back only the P rows it wrote
    accumulate_pv(acc, sp, sv, r, c);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum[i] = group_sum(sum[i]);
    inv[i] = 1.f / sum[i];
  }
  store_rows(o, acc, inv, b, h, m0, N, H, r, c);
  if (lse != nullptr && c == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = m0 + r + 16 * i;
      if (n < N) lse[(long long)bh * N + n] = (m[i] + log2f(sum[i])) * kLn2;
    }
  }
}

// set a kernel's dynamic shared memory limit once per device
inline int allow_smem(const void* kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) done[dev] = true;
  return 0;
}

// the grid of one CTA a (batch, head, 64-row block), or an error
inline int grid_of(const FlashLaunch* l, int* num_blocks, int* blocks) {
  *num_blocks = (l->N + kRows - 1) / kRows;
  const long long items = (long long)*num_blocks * l->B * l->H;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = (int)items;
  return 0;
}

}  // namespace

// The tensors as for the bf16 entry point (flash_attention_fwd.cu), fp32:
// q, k, v [B, N, H, 64] with unit stride on the last axis and the byte
// strides l->qkv_stride on H, N and B (each a multiple of 16, each base
// pointer 16-byte aligned); o contiguous [B, N, H, 64] fp32, lse contiguous
// fp32 [B, H, N] or null to skip it. Makes l->device current, launches on
// `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch.
extern "C" size_t flash_attention_f32_launch_bytes() { return sizeof(FlashLaunch); }

extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, const FlashLaunch* l, void* stream) {
  if (l->B == 0 || l->N == 0 || l->H == 0) return 0;
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  static bool done[64] = {false};
  int err = allow_smem((const void*)flash_attention_fwd_f32_kernel, kFwdSmem, done);
  int num_blocks = 0, blocks = 0;
  if (err == 0) err = grid_of(l, &num_blocks, &blocks);
  if (err != 0) return err;
  flash_attention_fwd_f32_kernel<<<blocks, kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), *l, num_blocks, l->sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
