// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation, head_dim 64.
//
// Replaces: imageclassification_tpu/models/vit.py:25 `flash_attention_fn`,
// which runs the Pallas TPU kernel jax.experimental.pallas.ops.tpu.flash_attention
// (forward only here; the backward comes with the training slice).
//
// Computes O = softmax(Q K^T * sm_scale) V for every (batch, head) without
// forming the N x N matrix. Q, K, V are read in the JAX layout [B, N, H, 64]
// through strides (so a view into a fused qkv projection works without a
// copy); O is written contiguous [B, N, H, 64]. The ragged tail is masked in
// the kernel: key columns >= N get -inf before the softmax, query rows >= N
// are loaded as zeros and never stored. Nothing is padded in memory.
//
// What bounds it on an H100: it moves 4*B*N*H*64*2 bytes (q, k, v in, o out)
// and does 4*B*H*N^2*64 flops, N/2 flops per byte; the card's bf16 ridge is
// ~295 flops per byte, so below N ~ 590 (ViT at 224^2 has N = 197) device
// memory bounds it and above that the tensor cores do. The design
// reads each Q tile once, streams K/V tiles through shared memory with
// cp.async double buffering (the K/V re-reads of the query tiles of one head
// come from L2), keeps S and P in registers (no N x N traffic), and runs both
// products on the tensor cores with mma.sync m16n8k16.
//
// Design (FlashAttention-2 forward):
//   * one CTA of 4 warps per (batch, head, 64-row query tile); each warp owns
//     16 query rows;
//   * a loop over 64-key tiles of K and V held in shared memory, loaded with
//     cp.async 16-byte copies into a 128-byte-row XOR swizzle so ldmatrix is
//     free of bank conflicts; the next tile loads while this one is used;
//   * S = Q K^T and O += P V on tensor cores (bf16 inputs, fp32 accumulators);
//     the S accumulator fragment is repacked in registers as the A fragment
//     of P V;
//   * online softmax in fp32 with exp2 and the scale folded into log2(e).
// wgmma, TMA and warp specialisation are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 64;
constexpr int kBlockM = 64;  // query rows per CTA
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileElems = kBlockN * kHeadDim;

// A tile row is 64 bf16 = 128 bytes = 8 chunks of 16 bytes. Chunk c of row r
// is stored at chunk c ^ (r & 7): the 8 row addresses that ldmatrix takes for
// one 8x8 matrix then fall in 8 different 16-byte bank groups.
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * kHeadDim + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a(16x16, row) * b(16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair; `lo` lands in the low 16 bits (lower column).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy rows [n0, n0 + 64) of one (batch, head) slice into a swizzled tile;
// rows >= N become zeros. 512 chunks of 16 bytes, 4 per thread.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, int64_t stride_n,
                                          int n0, int N, int tid) {
#pragma unroll
  for (int i = 0; i < (kBlockN * 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c >> 3, chunk = c & 7;
    const int n = n0 + row;
    const bool valid = n < N;
    const bf16* src = valid ? base + (int64_t)n * stride_n + chunk * 8 : base;
    cp_async_16(tile + swizzle(row, chunk), src, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           int N, int H, int num_m_tiles,
                           int64_t stride_b, int64_t stride_n, int64_t stride_h,
                           float scale_log2) {
  __shared__ __align__(128) bf16 sQ[kBlockM * kHeadDim];
  __shared__ __align__(128) bf16 sK[2][kTileElems];
  __shared__ __align__(128) bf16 sV[2][kTileElems];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // query tiles of one (batch, head) are neighbours in launch order, so the
  // K/V they all read stays hot in L2
  const int m_tile = blockIdx.x % num_m_tiles;
  const int bh = blockIdx.x / num_m_tiles;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = m_tile * kBlockM;
  const int64_t offset = (int64_t)b * stride_b + (int64_t)h * stride_h;
  const bf16* qb = q + offset;
  const bf16* kb = k + offset;
  const bf16* vb = v + offset;

  load_tile(sQ, qb, stride_n, m0, N, tid);
  load_tile(sK[0], kb, stride_n, 0, N, tid);
  load_tile(sV[0], vb, stride_n, 0, N, tid);
  cp_async_commit();

  unsigned q_frag[kHeadDim / 16][4];
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // this thread's two rows: g = lane / 4 and g + 8 of the warp's 16
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // partial over this thread's columns

  const int num_n_tiles = (N + kBlockN - 1) / kBlockN;
  for (int t = 0; t < num_n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < num_n_tiles) {
      // buffer cur ^ 1 was last read in iteration t - 1, which ended in a barrier
      load_tile(sK[cur ^ 1], kb, stride_n, (t + 1) * kBlockN, N, tid);
      load_tile(sV[cur ^ 1], vb, stride_n, (t + 1) * kBlockN, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int chunk = ks * 2 + (lane >> 4);
        ldmatrix_x4(q_frag[ks], sQ + swizzle(row, chunk));
      }
    }

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 accumulators of 16x8
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* k_tile = sK[cur];
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        unsigned kf[4];
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = ks * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(kf, k_tile + swizzle(row, chunk));
        mma_16816(s[2 * np], q_frag[ks], kf[0], kf[1]);
        mma_16816(s[2 * np + 1], q_frag[ks], kf[2], kf[3]);
      }
    }

    // scale into the log2 domain and mask the ragged key tail
    const int key0 = t * kBlockN;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + j * 8 + (lane & 3) * 2 + (e & 1);
        s[j][e] = col < N ? s[j][e] * scale_log2 : -INFINITY;
      }
    }

    // online softmax; every tile holds at least one real key, so the new
    // maximum is finite and exp2(-inf - m) = 0 for masked columns
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = row_max[i];
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) m = fmaxf(m, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      alpha[i] = exp2f(row_max[i] - m);
      row_max[i] = m;
      row_sum[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - row_max[0]);
      s[j][1] = exp2f(s[j][1] - row_max[0]);
      s[j][2] = exp2f(s[j][2] - row_max[1]);
      s[j][3] = exp2f(s[j][3] - row_max[1]);
      row_sum[0] += s[j][0] + s[j][1];
      row_sum[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the C fragments of key tiles 2kk and 2kk+1 are the A fragment
    // of the 16-key step kk
    const bf16* v_tile = sV[cur];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        unsigned vf[4];
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int chunk = dp * 2 + (lane >> 4);
        ldmatrix_x4_trans(vf, v_tile + swizzle(row, chunk));
        mma_16816(acc[2 * dp], pa, vf[0], vf[1]);
        mma_16816(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();
  }

  // the four threads of a quad share a row: sum their partial denominators
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
  }
  const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = m0 + warp * 16 + (lane >> 2) + i * 8;
    if (n >= N) continue;
    bf16* dst = o + (((int64_t)b * N + n) * H + h) * kHeadDim + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      *reinterpret_cast<unsigned*>(dst + j * 8) =
          pack_bf16(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
    }
  }
}

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with unit stride on the last axis and the given
// element strides on the other three (the same for all three tensors; each a
// multiple of 8, each base pointer 16-byte aligned). o: contiguous
// [B, N, H, 64] bf16. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int N, int H, long long stride_b,
                                        long long stride_n, long long stride_h,
                                        float sm_scale, void* stream) {
  if (B == 0 || N == 0 || H == 0) return 0;
  const int num_m_tiles = (N + kBlockM - 1) / kBlockM;
  const long long blocks = (long long)num_m_tiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale_log2 = sm_scale * 1.4426950408889634f;  // log2(e)
  flash_attention_fwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), N, H, num_m_tiles, stride_b, stride_n, stride_h, scale_log2);
  return (int)cudaGetLastError();
}
