// Flash-attention backward for Hopper (sm_90a): dQ (with di) and dK/dV, bf16
// in and out, fp32 accumulation, head_dim 64.
//
// Replaces the backward of the Pallas TPU kernel behind
// imageclassification_tpu/models/vit.py:25 `flash_attention_fn`
// (jax.experimental.pallas.ops.tpu.flash_attention `_flash_attention_bwd`):
//   * `_flash_attention_bwd_dq` (pl.pallas_call at flash_attention.py:1456,
//     kernel `_flash_attention_dq_kernel`) -> flash_attention_bwd_dq_kernel,
//     which also computes di = rowsum(dO * O), the jnp expression that the
//     TPU code runs outside Pallas (flash_attention.py:273-275);
//   * `_flash_attention_bwd_dkv` (pl.pallas_call at flash_attention.py:1121,
//     kernel `_flash_attention_dkv_kernel`) -> flash_attention_bwd_dkv_kernel.
//
// With S = Q K^T * sm_scale, P = exp(S - lse), di = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di),
//   dQ = dS K * sm_scale,  dK = dS^T Q * sm_scale.
// P is recomputed from Q, K and the forward's per-row lse; the N x N
// matrices never leave registers. The dQ kernel runs first: it writes di
// (fp32 [B, H, N]) for the dK/dV kernel, so one backward is two launches and
// nothing else. Neither kernel uses atomics, and every output element is
// summed by one thread in a fixed order: two runs give the same bits.
//
// Layout: q, k, v, o and dO are read as [B, N, H, 64] through strides (q, k, v
// share theirs, o and dO have their own), so the views of ViT's fused qkv
// projection are read in place; dq, dk, dv are written contiguous
// [B, N, H, 64]; lse and di are fp32 [B, H, N]. The ragged tail is masked in
// the kernels: TMA loads rows >= N as zeros and they are never stored, key
// columns >= N get P = 0 in dQ, and query rows >= N get lse = +inf (so P = 0)
// in dK/dV. Nothing is padded in memory.
//
// What bounds it on an H100: together the two kernels move 8 tensors of
// B*N*H*64 bf16 (q, k, v, o, dO in; dq, dk, dv out) plus lse and di, and do
// seven products of 2*B*H*N^2*64 flops (S and dP in both kernels, dQ in one,
// dV and dK in the other): about N flops a byte. The card's bf16 ridge is
// ~295 flops a byte, so at ViT's N = 197 the bytes bound it, and from
// N ~ 300 up the tensor cores.
//
// Design (the forward's machinery: persistent CTAs, TMA loads into rings
// guarded by full/empty mbarriers, products on the warpgroup tensor cores):
//   * one CTA an SM: two consumer warpgroups (64 rows each) and a producer
//     warpgroup that gives the consumers its registers (setmaxnreg: 232 a
//     consumer thread, which holds up to four 64 x 64 fp32 accumulators and
//     its rows' A fragments of the two score products);
//   * dQ: items of (batch, head, 128-query block). The producer loads the
//     item's Q, dO and O (two slots, so that the next item's load while this
//     one computes), then K/V tiles into a ring. Each warpgroup first sums di
//     for its 64 rows from O and dO in shared memory (a quad of threads a
//     row) and writes it out, and loads its rows of Q and dO as wgmma A
//     fragments; then per 64-key tile: S = Q K^T and dP = dO V^T with K and
//     V from shared memory, dS = P (dP - di) in registers, dQ += dS K with dS
//     from registers and K read MN-major;
//   * dK/dV: items of (batch, head, 128-key block). The producer loads the
//     item's K and V (two slots), then Q and dO tiles into a ring, with lse
//     (in log2 units, +inf past N) and di beside each tile, which its warp
//     copies with plain loads. Each warpgroup holds its 64 keys' K and V as
//     A fragments; per 64-query tile: S^T = K Q^T and dP^T = V dO^T, P^T and
//     dS^T in registers, then dV += P^T dO and dK += dS^T Q with dO and Q
//     read MN-major;
//   * in both, a tile's score products are issued right behind the previous
//     tile's gradient products, so the tensor cores run them back to back,
//     and one wait a tile covers both; the two warpgroups of a CTA overlap
//     one's exponentials with the other's products;
//   * a last tile of at most 16 real rows on the looped axis (N = 197, 577
//     and 4097 each end in one) runs its products as m64n16k16 and one
//     16-deep step instead of four, as the forward does;
//   * dQ, dK and dV are staged as bf16 in the item's own tiles and written
//     as whole 128-byte rows with 16-byte stores;
//   * P and dS are rounded to bf16 before their products, as the forward
//     rounds P; everything else accumulates in fp32.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// Each kernel: two consumer warpgroups of 64 rows of an item, and a producer
// warpgroup of which one warp works: a warpgroup, so that it can hand its
// registers to the consumers (setmaxnreg). At launch a thread gets 168
// registers (65536 over 384 threads, in steps of 8); the producer drops to 40
// and the consumers rise to 232
constexpr int kConsumers = 2;
constexpr int kRowsPerItem = kConsumers * kBlock;  // 128
constexpr int kBwdThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <= 65536,
              "registers over an SM's 65536");
constexpr int kDqStages = 6;      // K/V ring of the dQ kernel
constexpr int kDkvStages = 6;     // Q/dO ring of the dK/dV kernel
constexpr int kMaxSmem = 232448;  // a CTA's limit on an H100

struct alignas(1024) DqSmem {
  bf16 q[2][kConsumers][kTileElems];  // two items' Q, dO and O
  bf16 dout[2][kConsumers][kTileElems];
  bf16 o[2][kConsumers][kTileElems];
  bf16 k[kDqStages][kTileElems];
  bf16 v[kDqStages][kTileElems];
  uint64_t item_full[2];
  uint64_t item_empty[2];
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
};

struct alignas(1024) DkvSmem {
  bf16 k[2][kConsumers][kTileElems];  // two items' K and V
  bf16 v[2][kConsumers][kTileElems];
  bf16 q[kDkvStages][kTileElems];
  bf16 dout[kDkvStages][kTileElems];
  float lse[kDkvStages][kBlock];  // log2 units; +inf for rows >= N
  float di[kDkvStages][kBlock];   // 0 for rows >= N
  uint64_t item_full[2];
  uint64_t item_empty[2];
  uint64_t full[kDkvStages];
  uint64_t empty[kDkvStages];
};

// + slack to align the dynamic shared memory to 1024 bytes (the swizzle atom)
constexpr int kDqSmemBytes = sizeof(DqSmem) + 1024;
constexpr int kDkvSmemBytes = sizeof(DkvSmem) + 1024;
static_assert(kDqSmemBytes <= kMaxSmem, "dQ kernel: shared memory over a CTA's limit");
static_assert(kDkvSmemBytes <= kMaxSmem, "dK/dV kernel: shared memory over a CTA's limit");

template <typename T>
__device__ __forceinline__ T& aligned_smem(uint8_t* raw) {
  return *reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                               ~static_cast<uintptr_t>(1023));
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0 (the
// P of masked and far-off keys)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue (and commit, without waiting) both score-sized products of a tile:
// s = A1 B1^T and dp = A2 B2^T over the 64-deep head dimension, A1 and A2 in
// registers (`load_a_frags`), B1 and B2 K-major in shared memory.
template <int kCols>
__device__ __forceinline__ void issue_scores(float (&s)[kCols / 2], float (&dp)[kCols / 2],
                                             const unsigned (&a1)[kHeadDim / 16][4],
                                             uint64_t b1,
                                             const unsigned (&a2)[kHeadDim / 16][4],
                                             uint64_t b2) {
  hopper::fence_regs(s);
  hopper::fence_regs(dp);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    hopper::wgmma_m64k16_rs<kCols, 0>(s, a1[ks], b1 + 2 * ks, ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    hopper::wgmma_m64k16_rs<kCols, 0>(dp, a2[ks], b2 + 2 * ks, ks > 0);
  }
  hopper::wgmma_commit();
}

// Issue (without committing) acc(64 x 64) += A B over kSteps 16-deep steps,
// A in registers, B MN-major in shared memory (a step is 16 rows, 2048
// bytes). Products into one accumulator may be in flight together; nothing
// else touches it until the last is waited for.
template <int kSteps>
__device__ __forceinline__ void issue_product(float (&acc)[32], const unsigned (&a)[kSteps][4],
                                              uint64_t b) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) hopper::wgmma_m64k16_rs<64, 1>(acc, a[kk], b + 128 * kk, 1);
}

// A use of A fragments that a product issued earlier reads: keeps the
// compiler from giving their registers to other values before the wait that
// follows the product
template <int kSteps>
__device__ __forceinline__ void keep_frags(const unsigned (&f)[kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    asm volatile("" ::"r"(f[kk][0]), "r"(f[kk][1]), "r"(f[kk][2]), "r"(f[kk][3]));
  }
}

// dS = P (dP - di) of the dQ warpgroup's tile of kKeys keys key0.., as the A
// fragments of dQ += dS K (rounded to bf16), with P = exp2(S * sm_scale *
// log2(e) - lse * log2(e)) and keys >= N masked. Register i of s and dp holds
// row (i >> 1) & 1 of the thread's two, key column 8(i >> 2) + 2(lane % 4) +
// (i & 1); the pair (2m, 2m + 1) is element m % 4 of step m / 4's fragment.
template <int kKeys>
__device__ __forceinline__ void dq_grads(unsigned (&ds)[kKeys / 16][4], const float (&s)[kKeys / 2],
                                         const float (&dp)[kKeys / 2], const float (&neg_lse)[2],
                                         const float (&di)[2], int key0, int N,
                                         float scale_log2, int lane) {
  const bool ragged = key0 + kKeys > N;
#pragma unroll
  for (int m = 0; m < kKeys / 4; ++m) {
    float g[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * m + c;
      const int r = (i >> 1) & 1;
      float p = exp2_ftz(fmaf(s[i], scale_log2, neg_lse[r]));
      if (ragged && key0 + (i >> 2) * 8 + (lane & 3) * 2 + c >= N) p = 0.f;
      g[c] = p * (dp[i] - di[r]);
    }
    ds[m >> 2][m & 3] = pack_bf16(g[0], g[1]);
  }
}

// P^T and dS^T = P^T (dP^T - di) of the dK/dV warpgroup's tile of kQueries
// queries, as the A fragments of dV += P^T dO and dK += dS^T Q (rounded to
// bf16): lse (log2 units, +inf past N) and di per query column; register i
// holds column 8(i >> 2) + 2(lane % 4) + (i & 1).
template <int kQueries>
__device__ __forceinline__ void dkv_grads(unsigned (&pf)[kQueries / 16][4],
                                          unsigned (&dsf)[kQueries / 16][4],
                                          const float (&s)[kQueries / 2],
                                          const float (&dp)[kQueries / 2], const float* lse,
                                          const float* di, float scale_log2, int lane) {
#pragma unroll
  for (int m = 0; m < kQueries / 4; ++m) {
    const int col = (m >> 1) * 8 + (lane & 3) * 2;  // registers 2m and 2m + 1
    const float2 l = *reinterpret_cast<const float2*>(lse + col);
    const float2 d = *reinterpret_cast<const float2*>(di + col);
    const float p0 = exp2_ftz(fmaf(s[2 * m], scale_log2, -l.x));
    const float p1 = exp2_ftz(fmaf(s[2 * m + 1], scale_log2, -l.y));
    pf[m >> 2][m & 3] = pack_bf16(p0, p1);
    dsf[m >> 2][m & 3] = pack_bf16(p0 * (dp[2 * m] - d.x), p1 * (dp[2 * m + 1] - d.y));
  }
}

// Persistent, like the forward: CTA c takes items c, c + gridDim.x, ... of
// the B * H * num_m_blocks (batch, head, 128-query block) items, the query
// blocks of one head neighbours (the K/V they all read stays in L2). `li`
// counts a CTA's items (item slot li % 2), `gt` its K/V tiles (ring stage
// gt % kDqStages).
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap to,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse, float* __restrict__ di,
                              bf16* __restrict__ dq, int N, int H, int num_m_blocks, int items,
                              float scale_log2, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& s = aligned_smem<DqSmem>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + kBlock - 1) / kBlock;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&s.item_full[i], 1);
      hopper::mbar_init(&s.item_empty[i], kConsumers * 128);  // every consumer thread
    }
#pragma unroll
    for (int i = 0; i < kDqStages; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], kConsumers);  // one thread per warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    // producer: one thread issues every load of the CTA
    if (warp == kConsumers * 4 && lane == 0) {
      int gt = 0;
      for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
        const int m0 = (item % num_m_blocks) * kRowsPerItem;
        const int bh = item / num_m_blocks, b = bh / H, h = bh % H;
        // a warpgroup whose 64 rows all lie past N gets no tiles
        const int consumers = min(kConsumers, (N - m0 + kBlock - 1) / kBlock);
        const int slot = li & 1;
        // slot last held item li - 2; its release completed phase li / 2 - 1
        if (li >= 2) hopper::mbar_wait(&s.item_empty[slot], ((li >> 1) + 1) & 1);
        hopper::mbar_arrive_expect_tx(&s.item_full[slot], consumers * 3 * kTileBytes);
        for (int c = 0; c < consumers; ++c) {
          const int row = m0 + c * kBlock;
          hopper::tma_load_4d(s.q[slot][c], &tq, &s.item_full[slot], 0, h, row, b);
          hopper::tma_load_4d(s.dout[slot][c], &tdo, &s.item_full[slot], 0, h, row, b);
          hopper::tma_load_4d(s.o[slot][c], &to, &s.item_full[slot], 0, h, row, b);
        }
        for (int t = 0; t < n_tiles; ++t, ++gt) {
          const int st = gt % kDqStages;
          if (gt >= kDqStages) hopper::mbar_wait(&s.empty[st], ((gt / kDqStages) + 1) & 1);
          hopper::mbar_arrive_expect_tx(&s.full[st], 2 * kTileBytes);
          hopper::tma_load_4d(s.k[st], &tk, &s.full[st], 0, h, t * kBlock, b);
          hopper::tma_load_4d(s.v[st], &tv, &s.full[st], 0, h, t * kBlock, b);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int wl = warp & 3;  // this warp's 16 rows of the warpgroup's 64
  int gt = 0;
  for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
    const int m0 = (item % num_m_blocks) * kRowsPerItem;
    const int bh = item / num_m_blocks, b = bh / H, h = bh % H;
    const int row0 = m0 + wg * kBlock;
    // a warpgroup whose rows all lie past N only keeps the barriers' count
    const bool active = row0 < N;
    const int slot = li & 1;
    hopper::mbar_wait(&s.item_full[slot], (li >> 1) & 1);

    // di of this thread's rows g and g + 8: each thread of the quad sums the
    // products of two 16-byte chunks of O and dO, the quad adds them up.
    // Rows >= N are zeros (di = 0) and get lse 0: never stored, any finite
    // value does
    float neg_lse[2] = {0.f, 0.f}, row_di[2] = {0.f, 0.f};
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wl * 16 + (lane >> 2) + r * 8;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int off = swizzle(row, (lane & 3) * 2 + c);
          const uint4 a = *reinterpret_cast<const uint4*>(s.o[slot][wg] + off);
          const uint4 g = *reinterpret_cast<const uint4*>(s.dout[slot][wg] + off);
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa = __bfloat1622float2(a2[e]);
            const float2 fg = __bfloat1622float2(g2[e]);
            sum = fmaf(fa.x, fg.x, sum);
            sum = fmaf(fa.y, fg.y, sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        row_di[r] = sum;
        const int n = row0 + row;
        if (n < N) {
          neg_lse[r] = -lse[(int64_t)bh * N + n] * kLog2e;
          if ((lane & 3) == 0) di[(int64_t)bh * N + n] = sum;
        }
      }
    }

    // the stage of this item's key tile t is (gt + t) % kDqStages, its fill
    // the (gt + t) / kDqStages-th
    auto wait_full = [&](int t) {
      hopper::mbar_wait(&s.full[(gt + t) % kDqStages], ((gt + t) / kDqStages) & 1);
    };
    // the tile's products are done: hand its stage back to the producer
    auto release = [&](int t) {
      if ((tid & 127) == 0) hopper::mbar_arrive(&s.empty[(gt + t) % kDqStages]);
    };
    auto desc = [&](const bf16 (&tiles)[kDqStages][kTileElems], int t, uint32_t lbo) {
      return hopper::desc_b128(tiles[(gt + t) % kDqStages], lbo, 1024);
    };
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (active) {
      unsigned q_frag[kHeadDim / 16][4], do_frag[kHeadDim / 16][4];
      load_a_frags(q_frag, s.q[slot][wg], wl, lane);
      load_a_frags(do_frag, s.dout[slot][wg], wl, lane);
      const int n_full = N - (n_tiles - 1) * kBlock <= 16 ? n_tiles - 1 : n_tiles;
      float sc[32], dpc[32];
      unsigned ds[kBlock / 16][4];
      for (int t = 0; t < n_full; ++t) {
        wait_full(t);
        issue_scores<kBlock>(sc, dpc, q_frag, desc(s.k, t, 16), do_frag, desc(s.v, t, 16));
        hopper::wgmma_wait<0>();
        if (t > 0) {
          keep_frags(ds);
          release(t - 1);
        }
        hopper::fence_regs(sc);
        hopper::fence_regs(dpc);
        dq_grads<kBlock>(ds, sc, dpc, neg_lse, row_di, t * kBlock, N, scale_log2, lane);
        issue_product(acc, ds, desc(s.k, t, 0));
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      if (n_full > 0) {
        keep_frags(ds);
        release(n_full - 1);
      }
      if (n_full < n_tiles) {
        float s16[8], dp16[8];
        unsigned ds16[1][4];
        wait_full(n_full);
        issue_scores<16>(s16, dp16, q_frag, desc(s.k, n_full, 16), do_frag,
                         desc(s.v, n_full, 16));
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s16);
        hopper::fence_regs(dp16);
        dq_grads<16>(ds16, s16, dp16, neg_lse, row_di, n_full * kBlock, N, scale_log2, lane);
        issue_product(acc, ds16, desc(s.k, n_full, 0));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        keep_frags(ds16);
        release(n_full);
      }
      hopper::fence_regs(acc);
    } else {
      for (int t = 0; t < n_tiles; ++t) {
        wait_full(t);
        release(t);
      }
    }
    gt += n_tiles;

    if (active) {
      // stage dQ * sm_scale in the warpgroup's own Q tile (its last product
      // is done), then write whole rows
      const float scale[2] = {sm_scale, sm_scale};
      stage_acc(s.q[slot][wg], acc, scale, wl, lane);
      hopper::named_barrier_sync(1 + wg, 128);
      write_tile(dq, s.q[slot][wg], b, h, row0, N, H, tid & 127);
    }
    // this thread is done with the slot (its reads of O, dO and the staged
    // dQ included): order them before the TMA writes of the item after
    // next, then release
    hopper::fence_proxy_async();
    hopper::mbar_arrive(&s.item_empty[slot]);
  }
}

// Persistent over the B * H * num_n_blocks (batch, head, 128-key block)
// items, the key blocks of one head neighbours (the Q and dO they all read
// stays in L2). The whole producer warp fills the ring: lane 0 issues the
// TMA loads, and every lane copies two rows' lse and di before it arrives
// (so `full` counts lane 0's expect-tx arrival and the 32 lanes' arrivals).
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse, const float* __restrict__ di,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H,
                               int num_n_blocks, int items, float scale_log2, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& s = aligned_smem<DkvSmem>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + kBlock - 1) / kBlock;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&s.item_full[i], 1);
      hopper::mbar_init(&s.item_empty[i], kConsumers * 128);  // every consumer thread
    }
#pragma unroll
    for (int i = 0; i < kDkvStages; ++i) {
      hopper::mbar_init(&s.full[i], 1 + 32);
      hopper::mbar_init(&s.empty[i], kConsumers * 4);  // one lane per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp > kConsumers * 4) return;
    int gt = 0;
    for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
      const int n0 = (item % num_n_blocks) * kRowsPerItem;
      const int bh = item / num_n_blocks, b = bh / H, h = bh % H;
      const int consumers = min(kConsumers, (N - n0 + kBlock - 1) / kBlock);
      const int slot = li & 1;
      if (lane == 0) {
        if (li >= 2) hopper::mbar_wait(&s.item_empty[slot], ((li >> 1) + 1) & 1);
        hopper::mbar_arrive_expect_tx(&s.item_full[slot], consumers * 2 * kTileBytes);
        for (int c = 0; c < consumers; ++c) {
          const int row = n0 + c * kBlock;
          hopper::tma_load_4d(s.k[slot][c], &tk, &s.item_full[slot], 0, h, row, b);
          hopper::tma_load_4d(s.v[slot][c], &tv, &s.item_full[slot], 0, h, row, b);
        }
      }
      const float* lse_bh = lse + (int64_t)bh * N;
      const float* di_bh = di + (int64_t)bh * N;
      for (int t = 0; t < n_tiles; ++t, ++gt) {
        const int st = gt % kDkvStages;
        if (gt >= kDkvStages) hopper::mbar_wait(&s.empty[st], ((gt / kDkvStages) + 1) & 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&s.full[st], 2 * kTileBytes);
          hopper::tma_load_4d(s.q[st], &tq, &s.full[st], 0, h, t * kBlock, b);
          hopper::tma_load_4d(s.dout[st], &tdo, &s.full[st], 0, h, t * kBlock, b);
        }
#pragma unroll
        for (int r = lane; r < kBlock; r += 32) {
          const int n = t * kBlock + r;
          s.lse[st][r] = n < N ? lse_bh[n] * kLog2e : INFINITY;
          s.di[st][r] = n < N ? di_bh[n] : 0.f;
        }
        hopper::mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int wl = warp & 3;
  int gt = 0;
  for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
    const int n0 = (item % num_n_blocks) * kRowsPerItem;
    const int bh = item / num_n_blocks, b = bh / H, h = bh % H;
    const int row0 = n0 + wg * kBlock;
    const bool active = row0 < N;
    const int slot = li & 1;
    hopper::mbar_wait(&s.item_full[slot], (li >> 1) & 1);
    auto wait_full = [&](int t) {
      hopper::mbar_wait(&s.full[(gt + t) % kDkvStages], ((gt + t) / kDkvStages) & 1);
    };
    // this warp's reads of the stage (the statistics included) are done:
    // hand it back to the producer
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&s.empty[(gt + t) % kDkvStages]);
    };
    auto desc = [&](const bf16 (&tiles)[kDkvStages][kTileElems], int t, uint32_t lbo) {
      return hopper::desc_b128(tiles[(gt + t) % kDkvStages], lbo, 1024);
    };
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    if (active) {
      unsigned k_frag[kHeadDim / 16][4], v_frag[kHeadDim / 16][4];
      load_a_frags(k_frag, s.k[slot][wg], wl, lane);
      load_a_frags(v_frag, s.v[slot][wg], wl, lane);
      // full query tiles: tile t's S^T and dP^T are issued right behind tile
      // t - 1's dV and dK products, so the tensor cores run them back to
      // back; a last tile of at most 16 real queries after them
      const int n_full = N - (n_tiles - 1) * kBlock <= 16 ? n_tiles - 1 : n_tiles;
      float sc[32], dpc[32];
      unsigned pf[kBlock / 16][4], dsf[kBlock / 16][4];
      for (int t = 0; t < n_full; ++t) {
        const int st = (gt + t) % kDkvStages;
        wait_full(t);
        issue_scores<kBlock>(sc, dpc, k_frag, desc(s.q, t, 16), v_frag, desc(s.dout, t, 16));
        hopper::wgmma_wait<0>();
        if (t > 0) {
          keep_frags(pf);
          keep_frags(dsf);
          release(t - 1);
        }
        hopper::fence_regs(sc);
        hopper::fence_regs(dpc);
        dkv_grads<kBlock>(pf, dsf, sc, dpc, s.lse[st], s.di[st], scale_log2, lane);
        issue_product(dv_acc, pf, desc(s.dout, t, 0));
        issue_product(dk_acc, dsf, desc(s.q, t, 0));
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      if (n_full > 0) {
        keep_frags(pf);
        keep_frags(dsf);
        release(n_full - 1);
      }
      if (n_full < n_tiles) {
        const int st = (gt + n_full) % kDkvStages;
        float s16[8], dp16[8];
        unsigned pf16[1][4], dsf16[1][4];
        wait_full(n_full);
        issue_scores<16>(s16, dp16, k_frag, desc(s.q, n_full, 16), v_frag,
                         desc(s.dout, n_full, 16));
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s16);
        hopper::fence_regs(dp16);
        dkv_grads<16>(pf16, dsf16, s16, dp16, s.lse[st], s.di[st], scale_log2, lane);
        issue_product(dv_acc, pf16, desc(s.dout, n_full, 0));
        issue_product(dk_acc, dsf16, desc(s.q, n_full, 0));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        keep_frags(pf16);
        keep_frags(dsf16);
        release(n_full);
      }
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
    } else {
      for (int t = 0; t < n_tiles; ++t) {
        wait_full(t);
        release(t);
      }
    }
    gt += n_tiles;

    if (active) {
      // stage dV and dK * sm_scale in the warpgroup's own V and K tiles (its
      // products are done), then write whole rows
      const float one[2] = {1.f, 1.f};
      const float scale[2] = {sm_scale, sm_scale};
      stage_acc(s.v[slot][wg], dv_acc, one, wl, lane);
      stage_acc(s.k[slot][wg], dk_acc, scale, wl, lane);
      hopper::named_barrier_sync(1 + wg, 128);
      write_tile(dv, s.v[slot][wg], b, h, row0, N, H, tid & 127);
      write_tile(dk, s.k[slot][wg], b, h, row0, N, H, tid & 127);
    }
    hopper::fence_proxy_async();
    hopper::mbar_arrive(&s.item_empty[slot]);
  }
}

// The grid of a persistent launch: one CTA an SM, at most one per item.
int persistent_grid(const void* kernel, int smem_bytes, int (&cache)[64], long long items,
                    int* blocks) {
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int n_sms = 0;
  const int err = hopper::prepare_persistent(kernel, smem_bytes, cache, &n_sms);
  if (err != 0) return err;
  *blocks = (int)(items < n_sms ? items : n_sms);
  return 0;
}

}  // namespace

extern "C" size_t flash_attention_bwd_launch_bytes() { return sizeof(FlashLaunch); }

// q, k, v: [B, N, H, 64] bf16 with unit stride on the last axis and the byte
// strides l->qkv_stride on H, N and B, shared by the three; o and dout: the
// same shape with their own byte strides (l->o_stride, l->do_stride); each
// stride a multiple of 16, each base pointer 16-byte aligned (the tensor maps
// of dims (64, H, N, B)). lse: contiguous fp32 [B, H, N]. Writes dq
// (contiguous [B, N, H, 64] bf16) and di = rowsum(dout * o) (contiguous fp32
// [B, H, N]), which flash_attention_bwd_dkv_bf16 then reads. Makes l->device
// current, launches on `stream`, allocates nothing, and returns a tensor
// map's encoding error or cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* di, void* dq, const FlashLaunch* l,
                                           void* stream) {
  const int B = l->B, N = l->N, H = l->H;
  if (B == 0 || N == 0 || H == 0) return 0;
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  CUtensorMap maps[5];
  const void* bases[5] = {q, k, v, o, dout};
  const long long* strides[5] = {l->qkv_stride, l->qkv_stride, l->qkv_stride, l->o_stride,
                                 l->do_stride};
  for (int i = 0; i < 5; ++i) {
    const int err = encode_rows(&maps[i], bases[i], B, N, H, strides[i][0], strides[i][1],
                                strides[i][2]);
    if (err != 0) return err;
  }
  const int num_m_blocks = (N + kRowsPerItem - 1) / kRowsPerItem;
  const long long items = (long long)num_m_blocks * B * H;
  static int sms[64] = {0};
  int blocks = 0;
  const int err = persistent_grid((const void*)flash_attention_bwd_dq_kernel, kDqSmemBytes, sms,
                                  items, &blocks);
  if (err != 0) return err;
  flash_attention_bwd_dq_kernel<<<blocks, kBwdThreads, kDqSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<float*>(di), static_cast<bf16*>(dq), N, H, num_m_blocks, (int)items,
      l->sm_scale * kLog2e, l->sm_scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, lse and l as for flash_attention_bwd_dq_bf16; di: the fp32
// [B, H, N] that it wrote. Writes dk and dv, contiguous [B, N, H, 64] bf16.
// Makes l->device current, launches on `stream`, allocates nothing, and
// returns a tensor map's encoding error or cudaGetLastError() after the
// launch.
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* di,
                                            void* dk, void* dv, const FlashLaunch* l,
                                            void* stream) {
  const int B = l->B, N = l->N, H = l->H;
  if (B == 0 || N == 0 || H == 0) return 0;
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, dout};
  const long long* strides[4] = {l->qkv_stride, l->qkv_stride, l->qkv_stride, l->do_stride};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_rows(&maps[i], bases[i], B, N, H, strides[i][0], strides[i][1],
                                strides[i][2]);
    if (err != 0) return err;
  }
  const int num_n_blocks = (N + kRowsPerItem - 1) / kRowsPerItem;
  const long long items = (long long)num_n_blocks * B * H;
  static int sms[64] = {0};
  int blocks = 0;
  const int err = persistent_grid((const void*)flash_attention_bwd_dkv_kernel, kDkvSmemBytes,
                                  sms, items, &blocks);
  if (err != 0) return err;
  flash_attention_bwd_dkv_kernel<<<blocks, kBwdThreads, kDkvSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H,
      num_n_blocks, (int)items, l->sm_scale * kLog2e, l->sm_scale);
  return (int)cudaGetLastError();
}
