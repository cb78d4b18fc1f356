// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation, head_dim 64.
//
// Replaces: imageclassification_tpu/models/vit.py:25 `flash_attention_fn`,
// which runs the Pallas TPU kernel jax.experimental.pallas.ops.tpu.flash_attention
// (`_flash_attention_impl`; the backward is flash_attention_bwd.cu).
//
// Computes O = softmax(Q K^T * sm_scale) V for every (batch, head) without
// forming the N x N matrix. Q, K, V are read in the JAX layout [B, N, H, 64]
// through strides (so a view into a fused qkv projection works without a
// copy); O is written contiguous [B, N, H, 64]. The ragged tail is masked in
// the kernel: key columns >= N get -inf before the softmax, query rows >= N
// are loaded as zeros and never stored. Nothing is padded in memory. When the
// caller passes an `lse` buffer (autograd will need the backward), the kernel
// also writes the residual the backward recomputes P from, the natural-log
// row log-sum-exp lse = m + log(l) as fp32 [B, H, N] (the TPU kernel's l and
// m, `flash_attention.py:246-251`, folded into one number).
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

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int N, int H, int num_m_tiles,
                           int64_t stride_b, int64_t stride_n, int64_t stride_h,
                           float scale_log2) {
  __shared__ __align__(128) bf16 sQ[kTileElems];
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
  const int m0 = m_tile * kBlock;
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

  const int num_n_tiles = (N + kBlock - 1) / kBlock;
  for (int t = 0; t < num_n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < num_n_tiles) {
      // buffer cur ^ 1 was last read in iteration t - 1, which ended in a barrier
      load_tile(sK[cur ^ 1], kb, stride_n, (t + 1) * kBlock, N, tid);
      load_tile(sV[cur ^ 1], vb, stride_n, (t + 1) * kBlock, N, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (t == 0) load_a_frags(q_frag, sQ, warp, lane);

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 accumulators of 16x8
    float s[kBlock / 8][4];
    mma_a_tileT(s, q_frag, sK[cur], lane);

    // scale into the log2 domain and mask the ragged key tail
    const int key0 = t * kBlock;
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
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
      for (int j = 0; j < kBlock / 8; ++j) m = fmaxf(m, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      alpha[i] = exp2f(row_max[i] - m);
      row_max[i] = m;
      row_sum[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
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

    // O += P V (P rounded to bf16)
    mma_c_tile(acc, s, sV[cur], lane);
    __syncthreads();
  }

  // the four threads of a quad share a row: sum their partial denominators
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
  }
  const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
  store_rows(o, acc, inv, b, h, m0 + warp * 16, N, H, lane);
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = m0 + warp * 16 + (lane >> 2) + i * 8;
      // row_max is in log2 units (scores times sm_scale * log2(e))
      if (n < N) lse[(int64_t)bh * N + n] = (row_max[i] + log2f(row_sum[i])) * kLn2;
    }
  }
}

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with unit stride on the last axis and the given
// element strides on the other three (the same for all three tensors; each a
// multiple of 8, each base pointer 16-byte aligned). o: contiguous
// [B, N, H, 64] bf16. lse: contiguous fp32 [B, H, N], or null to skip it.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int N, int H, long long stride_b,
                                        long long stride_n, long long stride_h,
                                        float sm_scale, void* stream) {
  if (B == 0 || N == 0 || H == 0) return 0;
  const int num_m_tiles = (N + kBlock - 1) / kBlock;
  const long long blocks = (long long)num_m_tiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_fwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), N, H, num_m_tiles, stride_b, stride_n,
      stride_h, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
