// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in and
// out, fp32 accumulation, head_dim 64.
//
// Replaces the backward of the Pallas TPU kernel behind
// imageclassification_tpu/models/vit.py:25 `flash_attention_fn`
// (jax.experimental.pallas.ops.tpu.flash_attention `_flash_attention_bwd`):
//   * `_flash_attention_bwd_dkv` (pl.pallas_call at flash_attention.py:1121,
//     kernel `_flash_attention_dkv_kernel`) -> flash_attention_bwd_dkv_kernel;
//   * `_flash_attention_bwd_dq` (pl.pallas_call at flash_attention.py:1456,
//     kernel `_flash_attention_dq_kernel`) -> flash_attention_bwd_dq_kernel.
//
// With S = Q K^T * sm_scale, P = exp(S - lse), di = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di),
//   dQ = dS K * sm_scale,  dK = dS^T Q * sm_scale.
// P is recomputed from Q, K and the forward's per-row lse; the N x N
// matrices never leave registers. di is computed by the caller (the TPU code
// computes it in jnp outside Pallas too).
//
// Layout: q, k, v (and dO) are read as [B, N, H, 64] through strides, so the
// views of ViT's fused qkv projection are read in place; dq, dk, dv are
// written contiguous [B, N, H, 64]; lse and di are fp32 [B, H, N]. The ragged
// tail is masked in the kernels: rows >= N load as zeros and are never
// stored, key columns >= N get P = 0 in dQ, and query rows >= N get lse = +inf
// (so P = 0) in dK/dV. Nothing is padded in memory.
//
// What bounds it on an H100: the two kernels move 7*B*N*H*64*2 bytes of bf16
// (q, k, v, dO in, dq, dk, dv out) plus lse and di, and do 14*B*H*N^2*64 flops
// with the recomputation (S and dP in both kernels, dV and dK in one, dQ in
// the other): N flops a byte. The card's bf16 ridge is ~295 flops a byte, so
// at ViT's N = 197 the bytes bound it, and from N ~ 300 up the tensor cores.
//
// Design (FlashAttention-2 backward, two kernels so neither needs atomics;
// the TPU grid runs in order and accumulates across grid steps, here a CTA
// loops over the other axis itself):
//   * dK/dV: one CTA of 4 warps per (batch, head, 64-key tile); each warp
//     holds its 16 keys' K and V rows as mma A fragments in registers and two
//     16 x 64 fp32 accumulators (dK, dV); it loops over 64-query tiles of Q
//     and dO, double-buffered in shared memory with cp.async, computing S^T =
//     K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q, with P^T
//     and dS^T repacked from accumulators into A fragments (the transposed
//     operands come from ldmatrix .trans on the swizzled tiles).
//   * dQ: one CTA of 4 warps per (batch, head, 64-query tile); each warp holds
//     its 16 queries' Q and dO rows as A fragments and one fp32 accumulator;
//     it loops over 64-key tiles of K and V, computing S = Q K^T, dP = dO V^T,
//     then dQ += dS K.
//   * P and dS are rounded to bf16 before their products, as the forward
//     rounds P; everything else accumulates in fp32.
// wgmma, TMA and warp specialisation are left for a later change.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// lse (natural log, scaled here to log2 units) and di of query rows
// [m0, m0 + 64) into shared memory; rows >= N get lse = +inf and di = 0, so
// their P and dS are 0. Plain loads: an lse row is not 16-byte aligned.
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_di, const float* lse,
                                               const float* di, int m0, int N, int tid) {
  const int r = tid & (kBlock - 1);
  const int n = m0 + r;
  if (tid < kBlock) {
    s_lse[r] = n < N ? lse[n] * kLog2e : INFINITY;
  } else {
    s_di[r] = n < N ? di[n] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ di,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H,
                               int num_n_tiles, int64_t stride_b, int64_t stride_n,
                               int64_t stride_h, int64_t dstride_b, int64_t dstride_n,
                               int64_t dstride_h, float scale_log2, float sm_scale) {
  __shared__ __align__(128) bf16 sQ[2][kTileElems];
  __shared__ __align__(128) bf16 sdO[2][kTileElems];
  __shared__ float sLse[2][kBlock];
  __shared__ float sDi[2][kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tile = blockIdx.x % num_n_tiles;
  const int bh = blockIdx.x / num_n_tiles;
  const int b = bh / H;
  const int h = bh % H;
  const int n0 = n_tile * kBlock;
  const int64_t offset = (int64_t)b * stride_b + (int64_t)h * stride_h;
  const bf16* qb = q + offset;
  const bf16* kb = k + offset;
  const bf16* vb = v + offset;
  const bf16* dob = dout + (int64_t)b * dstride_b + (int64_t)h * dstride_h;
  const float* lse_bh = lse + (int64_t)bh * N;
  const float* di_bh = di + (int64_t)bh * N;

  // this CTA's K and V rows go through the second buffers once, into
  // registers; the first query tile goes into the first buffers
  load_tile(sQ[1], kb, stride_n, n0, N, tid);
  load_tile(sdO[1], vb, stride_n, n0, N, tid);
  load_tile(sQ[0], qb, stride_n, 0, N, tid);
  load_tile(sdO[0], dob, dstride_n, 0, N, tid);
  cp_async_commit();
  load_row_stats(sLse[0], sDi[0], lse_bh, di_bh, 0, N, tid);
  cp_async_wait<0>();
  __syncthreads();
  unsigned k_frag[kHeadDim / 16][4], v_frag[kHeadDim / 16][4];
  load_a_frags(k_frag, sQ[1], warp, lane);
  load_a_frags(v_frag, sdO[1], warp, lane);
  __syncthreads();

  float dk_acc[kHeadDim / 8][4], dv_acc[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  const int num_m_tiles = (N + kBlock - 1) / kBlock;
  for (int t = 0; t < num_m_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < num_m_tiles) {
      // buffer cur ^ 1 was last read in iteration t - 1 (or, at t = 0, by the
      // K/V fragment loads), each followed by a barrier
      load_tile(sQ[cur ^ 1], qb, stride_n, (t + 1) * kBlock, N, tid);
      load_tile(sdO[cur ^ 1], dob, dstride_n, (t + 1) * kBlock, N, tid);
      cp_async_commit();
      load_row_stats(sLse[cur ^ 1], sDi[cur ^ 1], lse_bh, di_bh, (t + 1) * kBlock, N, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
    float s[kBlock / 8][4], dp[kBlock / 8][4];
    mma_a_tileT(s, k_frag, sQ[cur], lane);
    mma_a_tileT(dp, v_frag, sdO[cur], lane);

    // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - di), lse and di per column
    const float* lse_t = sLse[cur];
    const float* di_t = sDi[cur];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + (lane & 3) * 2 + (e & 1);
        const float p = exp2f(s[j][e] * scale_log2 - lse_t[col]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - di_t[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q
    mma_c_tile(dv_acc, s, sdO[cur], lane);
    mma_c_tile(dk_acc, dp, sQ[cur], lane);
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  const float scale[2] = {sm_scale, sm_scale};
  store_rows(dv, dv_acc, one, b, h, n0 + warp * 16, N, H, lane);
  store_rows(dk, dk_acc, scale, b, h, n0 + warp * 16, N, H, lane);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ di,
                              bf16* __restrict__ dq, int N, int H, int num_m_tiles,
                              int64_t stride_b, int64_t stride_n, int64_t stride_h,
                              int64_t dstride_b, int64_t dstride_n, int64_t dstride_h,
                              float scale_log2, float sm_scale) {
  __shared__ __align__(128) bf16 sK[2][kTileElems];
  __shared__ __align__(128) bf16 sV[2][kTileElems];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m_tile = blockIdx.x % num_m_tiles;
  const int bh = blockIdx.x / num_m_tiles;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = m_tile * kBlock;
  const int64_t offset = (int64_t)b * stride_b + (int64_t)h * stride_h;
  const bf16* qb = q + offset;
  const bf16* kb = k + offset;
  const bf16* vb = v + offset;
  const bf16* dob = dout + (int64_t)b * dstride_b + (int64_t)h * dstride_h;

  // this CTA's Q and dO rows go through the second buffers once, into
  // registers; the first key tile goes into the first buffers
  load_tile(sK[1], qb, stride_n, m0, N, tid);
  load_tile(sV[1], dob, dstride_n, m0, N, tid);
  load_tile(sK[0], kb, stride_n, 0, N, tid);
  load_tile(sV[0], vb, stride_n, 0, N, tid);
  cp_async_commit();

  // lse (log2 units) and di of this thread's rows g and g + 8; rows >= N are
  // zero rows that are never stored, any finite value does
  float row_lse[2], row_di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = m0 + warp * 16 + (lane >> 2) + i * 8;
    row_lse[i] = n < N ? lse[(int64_t)bh * N + n] * kLog2e : 0.f;
    row_di[i] = n < N ? di[(int64_t)bh * N + n] : 0.f;
  }

  cp_async_wait<0>();
  __syncthreads();
  unsigned q_frag[kHeadDim / 16][4], do_frag[kHeadDim / 16][4];
  load_a_frags(q_frag, sK[1], warp, lane);
  load_a_frags(do_frag, sV[1], warp, lane);
  __syncthreads();

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int num_n_tiles = (N + kBlock - 1) / kBlock;
  for (int t = 0; t < num_n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < num_n_tiles) {
      load_tile(sK[cur ^ 1], kb, stride_n, (t + 1) * kBlock, N, tid);
      load_tile(sV[cur ^ 1], vb, stride_n, (t + 1) * kBlock, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: the warp's 16 queries x 64 keys
    float s[kBlock / 8][4], dp[kBlock / 8][4];
    mma_a_tileT(s, q_frag, sK[cur], lane);
    mma_a_tileT(dp, do_frag, sV[cur], lane);

    // dS = P (dP - di) with P = exp(S - lse); key columns >= N get P = 0
    const int key0 = t * kBlock;
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + j * 8 + (lane & 3) * 2 + (e & 1);
        const int i = e >> 1;
        const float p = col < N ? exp2f(s[j][e] * scale_log2 - row_lse[i]) : 0.f;
        dp[j][e] = p * (dp[j][e] - row_di[i]);
      }
    }

    // dQ += dS K
    mma_c_tile(acc, dp, sK[cur], lane);
    __syncthreads();
  }

  const float scale[2] = {sm_scale, sm_scale};
  store_rows(dq, acc, scale, b, h, m0 + warp * 16, N, H, lane);
}

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with unit stride on the last axis and the
// strides (stride_b, stride_n, stride_h), shared by the three; dout: the same
// shape with its own strides (dstride_*); each stride a multiple of 8, each
// base pointer 16-byte aligned. lse, di: contiguous fp32 [B, H, N]. dk, dv
// (dq): contiguous [B, N, H, 64] bf16. Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* di,
                                            void* dk, void* dv, int B, int N, int H,
                                            long long stride_b, long long stride_n,
                                            long long stride_h, long long dstride_b,
                                            long long dstride_n, long long dstride_h,
                                            float sm_scale, void* stream) {
  if (B == 0 || N == 0 || H == 0) return 0;
  const int num_n_tiles = (N + kBlock - 1) / kBlock;
  const long long blocks = (long long)num_n_tiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_bwd_dkv_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H,
      num_n_tiles, stride_b, stride_n, stride_h, dstride_b, dstride_n, dstride_h,
      sm_scale * kLog2e, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* di,
                                           void* dq, int B, int N, int H, long long stride_b,
                                           long long stride_n, long long stride_h,
                                           long long dstride_b, long long dstride_n,
                                           long long dstride_h, float sm_scale,
                                           void* stream) {
  if (B == 0 || N == 0 || H == 0) return 0;
  const int num_m_tiles = (N + kBlock - 1) / kBlock;
  const long long blocks = (long long)num_m_tiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_bwd_dq_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), N, H, num_m_tiles, stride_b,
      stride_n, stride_h, dstride_b, dstride_n, dstride_h, sm_scale * kLog2e, sm_scale);
  return (int)cudaGetLastError();
}
