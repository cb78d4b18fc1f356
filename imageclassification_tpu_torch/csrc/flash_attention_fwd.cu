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
// memory bounds it and above that the tensor cores do. At N = 197 the time
// of a short CTA is mostly the latency of its first loads, so the design
// keeps many bytes in flight and starts every product as soon as its tile
// lands; at large N it keeps the warpgroup tensor cores fed.
//
// Design (FlashAttention-2 forward on Hopper's warpgroup tensor cores):
//   * persistent CTAs, two an SM, each walking over (batch, head, 128-row
//     query block) items: two consumer warpgroups of 64 query rows each and
//     one producer warp;
//   * the producer's one thread issues TMA loads: an item's two Q boxes into
//     one of two Q slots, then its 64-key tiles of K and V into a ring of 4
//     stages, each slot and stage guarded by a "full" mbarrier (bytes landed)
//     and an "empty" one (the warpgroups done with it). At N = 197 the ring
//     holds every K/V tile of a head, so all of an item's loads are in flight
//     at once, and the next item's Q and K/V load while this one computes
//     and stores; at larger N the producer refills a stage as soon as both
//     warpgroups release it. The tensor maps describe the strided
//     [B, N, H, 64] view itself and zero-fill rows >= N;
//   * S = Q K^T and O += P V run as wgmma m64n64k16: S reads Q and K from
//     shared memory, P V takes P in registers (the fp32 S accumulators
//     rounded to bf16 in place) and V from shared memory, all through
//     128-byte-swizzle descriptors (Q and K as stored, V transposed). Q is
//     not held in registers: that keeps a thread within the 112 registers
//     that two CTAs an SM leave it, without spilling;
//   * online softmax in fp32 with exp2 and the scale folded into log2(e); a
//     last tile of at most 16 real keys (N = 197, 577 and 4097 each end in
//     one) runs as m64n16k16 and one 16-deep P V step instead of four;
//   * O is staged through the warpgroup's Q tile and written with 16-byte
//     stores, 128 contiguous bytes a row.
// Two CTAs fit on an SM (96 KB of shared memory each), so four consumer
// warpgroups take turns on the tensor cores while the others run softmax.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int kConsumers = 2;                        // warpgroups of 64 query rows
constexpr int kStages = 4;                           // K/V ring
constexpr int kRowsPerCta = kConsumers * kBlock;     // 128
constexpr int kFwdThreads = (kConsumers * 4 + 1) * 32;  // + the producer warp

struct alignas(1024) FwdSmem {
  bf16 q[2][kConsumers][kTileElems];  // two items' Q; each tile 8 KB, 1024-byte aligned
  bf16 k[kStages][kTileElems];
  bf16 v[kStages][kTileElems];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
// + slack to align the dynamic shared memory to 1024 bytes (the swizzle atom)
constexpr int kSmemBytes = sizeof(FwdSmem) + 1024;

// One key tile of the warpgroup's online softmax: the first kKeys (64 or 16)
// keys of the stage whose K and V descriptors are dk and dv, keys key0 ..
// key0 + kKeys - 1 of the head, those >= N masked.
template <int kKeys>
__device__ __forceinline__ void attend_tile(float (&acc)[32], float (&row_max)[2],
                                            float (&row_sum)[2], uint64_t dq, uint64_t dk,
                                            uint64_t dv, int key0, int N, float scale_log2,
                                            int lane) {
  constexpr int kRegs = kKeys / 2;  // S accumulators a thread: kKeys / 8 chunks of 4
  // S = Q K^T for the warpgroup's 64 rows x kKeys keys; Q and K are stored
  // K-major (a row's 64 values contiguous): a 16-deep step is 32 bytes along
  // the swizzled rows
  float sc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) sc[i] = 0.f;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    hopper::wgmma_m64k16_ss<kKeys, 0>(sc, dq + 2 * ks, dk + 2 * ks, ks > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);

  // mask the ragged key tail
  if (key0 + kKeys > N) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      const int col = key0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      if (col >= N) sc[i] = -INFINITY;
    }
  }

  // online softmax in the log2 domain (scores times sm_scale * log2(e), the
  // scale folded into the exponent's fma); every tile holds at least one
  // real key, so the new maximum is finite and masked columns give 0
  float alpha[2], neg_max[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) m = fmaxf(m, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    m = fmaxf(row_max[r], m * scale_log2);
    alpha[r] = exp2f(row_max[r] - m);
    row_max[r] = m;
    row_sum[r] *= alpha[r];
    neg_max[r] = -m;
  }
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2f(fmaf(sc[i], scale_log2, neg_max[r]));
    row_sum[r] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

  // O += P V with P rounded to bf16: the accumulator of keys 16kk..16kk+15
  // is the A fragment of step kk; V is stored MN-major (a key's 64 values
  // contiguous), a 16-deep step is 16 rows = 2048 bytes
  unsigned p[kKeys / 16][4];
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    hopper::wgmma_m64k16_rs<64, 1>(acc, p[kk], dv + 128 * kk, 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// Persistent: CTA c takes the work items c, c + gridDim.x, ... of the
// `items` = B * H * num_m_blocks (batch, head, 128-row query block) items, in
// that order (the query blocks of one head are neighbours, so the K/V they
// all read stays hot in L2). Q has two slots, so the producer loads the next
// item's Q and its first K/V tiles while the warpgroups finish this one.
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                           float* __restrict__ lse, int N, int H, int num_m_blocks, int items,
                           float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + kBlock - 1) / kBlock;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&s.q_full[i], 1);
      hopper::mbar_init(&s.q_empty[i], kConsumers * 128);  // every consumer thread
    }
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], kConsumers);  // one thread per warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // producer: one thread issues every load of the CTA. `li` counts this
    // CTA's items (Q slot li % 2), `gt` its K/V tiles (ring stage gt % kStages)
    if (lane == 0) {
      int gt = 0;
      for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
        const int m0 = (item % num_m_blocks) * kRowsPerCta;
        const int bh = item / num_m_blocks, b = bh / H, h = bh % H;
        // a warpgroup whose 64 rows all lie past N gets no Q
        const int consumers = min(kConsumers, (N - m0 + kBlock - 1) / kBlock);
        const int qs = li & 1;
        // slot qs last held item li - 2: wait for every consumer thread to
        // release it (that release completed phase li / 2 - 1)
        if (li >= 2) hopper::mbar_wait(&s.q_empty[qs], ((li >> 1) + 1) & 1);
        hopper::mbar_arrive_expect_tx(&s.q_full[qs], consumers * kTileBytes);
        for (int c = 0; c < consumers; ++c) {
          hopper::tma_load_4d(s.q[qs][c], &tq, &s.q_full[qs], 0, h, m0 + c * kBlock, b);
        }
        for (int t = 0; t < n_tiles; ++t, ++gt) {
          const int st = gt % kStages;
          // stage st last held tile gt - kStages: wait for both warpgroups to
          // release it (that release completed phase gt / kStages - 1)
          if (gt >= kStages) hopper::mbar_wait(&s.empty[st], ((gt / kStages) + 1) & 1);
          hopper::mbar_arrive_expect_tx(&s.full[st], 2 * kTileBytes);
          hopper::tma_load_4d(s.k[st], &tk, &s.full[st], 0, h, t * kBlock, b);
          hopper::tma_load_4d(s.v[st], &tv, &s.full[st], 0, h, t * kBlock, b);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wl = warp & 3;  // this warp's 16 rows of the warpgroup's 64
  int gt = 0;
  for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
    const int m0 = (item % num_m_blocks) * kRowsPerCta;
    const int bh = item / num_m_blocks, b = bh / H, h = bh % H;
    // a warpgroup whose rows all lie past N only keeps the barriers' count
    const bool active = m0 + wg * kBlock < N;
    const int qs = li & 1;
    hopper::mbar_wait(&s.q_full[qs], (li >> 1) & 1);
    const uint64_t dq = hopper::desc_b128(s.q[qs][wg], 16, 1024);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // this thread's two rows: g = lane / 4 and g + 8 of the warp's 16
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // partial over this thread's columns

    for (int t = 0; t < n_tiles; ++t, ++gt) {
      const int st = gt % kStages;
      hopper::mbar_wait(&s.full[st], (gt / kStages) & 1);
      const int key0 = t * kBlock;
      const uint64_t dk = hopper::desc_b128(s.k[st], 16, 1024);
      const uint64_t dv = hopper::desc_b128(s.v[st], 0, 1024);
      if (active && N - key0 <= 16) {
        // a ragged last tile of at most 16 keys (N = 197, 577 and 4097 each
        // end in one): a quarter of the products and of the exponentials
        attend_tile<16>(acc, row_max, row_sum, dq, dk, dv, key0, N, scale_log2, lane);
      } else if (active) {
        attend_tile<kBlock>(acc, row_max, row_sum, dq, dk, dv, key0, N, scale_log2, lane);
      }
      // both products of this stage are done: hand it back to the producer
      if ((tid & 127) == 0) hopper::mbar_arrive(&s.empty[st]);
    }

    if (active) {
      // the four threads of a quad share a row: sum their partial denominators
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
      }
      const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};

      // stage O in the warpgroup's own Q tile (its last product is done), in
      // the same swizzle, then write whole 128-byte rows with 16-byte stores
      stage_acc(s.q[qs][wg], acc, inv, wl, lane);
      hopper::named_barrier_sync(1 + wg, 128);
      const int row0 = m0 + wg * kBlock;
      write_tile(o, s.q[qs][wg], b, h, row0, N, H, tid & 127);
      if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = row0 + wl * 16 + (lane >> 2) + r * 8;
          // row_max is in log2 units (scores times sm_scale * log2(e))
          if (n < N) lse[(int64_t)bh * N + n] = (row_max[r] + log2f(row_sum[r])) * kLn2;
        }
      }
    }
    // this thread is done with slot qs (its reads of the staged O included):
    // order them before the TMA writes of the item after next, then release
    hopper::fence_proxy_async();
    hopper::mbar_arrive(&s.q_empty[qs]);
  }
}

}  // namespace

// q, k, v: [B, N, H, 64] bf16 with unit stride on the last axis and the byte
// strides l->qkv_stride on H, N and B (the same for all three tensors; each a
// multiple of 16, each base pointer 16-byte aligned): the tensor maps of dims
// (64, H, N, B). o: contiguous [B, N, H, 64] bf16. lse: contiguous fp32
// [B, H, N], or null to skip it. Makes l->device current, launches on
// `stream`, allocates nothing, and returns a tensor map's encoding error or
// cudaGetLastError() after the launch.
extern "C" size_t flash_attention_fwd_launch_bytes() { return sizeof(FlashLaunch); }

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, const FlashLaunch* l, void* stream) {
  const int B = l->B, N = l->N, H = l->H;
  if (B == 0 || N == 0 || H == 0) return 0;
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_rows(&maps[i], bases[i], B, N, H, l->qkv_stride[0],
                                l->qkv_stride[1], l->qkv_stride[2]);
    if (err != 0) return err;
  }
  const int num_m_blocks = (N + kRowsPerCta - 1) / kRowsPerCta;
  const long long items = (long long)num_m_blocks * B * H;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // two persistent CTAs an SM
  static int sms[64] = {0};
  int n_sms = 0;
  const int err = hopper::prepare_persistent((const void*)flash_attention_fwd_kernel, kSmemBytes,
                                             sms, &n_sms);
  if (err != 0) return err;
  const int blocks = (int)(items < 2LL * n_sms ? items : 2LL * n_sms);
  flash_attention_fwd_kernel<<<blocks, kFwdThreads, kSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), static_cast<float*>(lse), N, H,
      num_m_blocks, (int)items, l->sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
