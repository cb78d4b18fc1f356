// Flash-attention backward in fp32 for Hopper (sm_90a): the dQ kernel (with
// di) and the dK/dV kernel, fp32 in and out, head_dim 64, every product on
// the warpgroup tensor cores in three TF32 passes.
//
// Replaces, in a model whose dtype is fp32 (`--half_precision false`), the
// backward of the Pallas TPU kernel behind imageclassification_tpu/models/
// vit.py:25 `flash_attention_fn` (jax.experimental.pallas.ops.tpu.
// flash_attention): `_flash_attention_bwd_dq` (pl.pallas_call at
// flash_attention.py:1456, kernel :1146) -> flash_attention_bwd_dq_f32_kernel,
// which also computes di = rowsum(dO * O) (the jnp lines :273-275), and
// `_flash_attention_bwd_dkv` (pl.pallas_call at :1121, kernel :796) ->
// flash_attention_bwd_dkv_f32_kernel. The fp32 forward is
// flash_attention_f32.cu; the bf16 kernels are flash_attention_{fwd,bwd}.cu.
//
// With S = Q K^T * sm_scale, P = exp(S - lse), di = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di),
//   dQ = dS K * sm_scale,  dK = dS^T Q * sm_scale.
// The dQ kernel runs first and writes di (fp32 [B, H, N]) for the dK/dV
// kernel: one backward is two launches and nothing else.
//
// Arithmetic: the JAX kernel's fp32 products, each as three TF32 products.
// An fp32 operand x is split into a tf32 head hi = tf32(x) (round to
// nearest) and a tf32 tail lo = tf32(x - hi), and a product is hi*hi +
// hi*lo + lo*hi, summed in fp32 on the tensor cores. The dropped lo*lo is
// ~2^-22 of it, so a product keeps about 21 bits, far inside the contract's
// 2^-12 of max|ref| (one TF32 pass, unit roundoff 2^-11, is not). Both parts
// are stored with their low 13 bits zero, so nothing rests on how the tensor
// core reads the low bits of an fp32 word. di = rowsum(dO * O) is the
// diagonal of O dO^T on the same tensor cores, its passes in the order of
// dP's (dO's tail pass first, then the other tail's, then the heads), so
// that dP - di is exactly 0 where it should be: for a row whose softmax is
// one-hot (N = 1), O = V and each dP equals di bit for bit, and dS, dQ and
// dK vanish as they do in exact arithmetic. The rest (P, dS, the sum of the
// two warpgroups' partials) is fp32 on the CUDA cores. No atomics, and every
// sum runs in one fixed order: two runs give the same bits.
//
// Layout: q, k, v, o and dO are read as [B, N, H, 64] through tensor maps of
// their own strides (q, k, v share theirs: the views of ViT's fused qkv),
// dq, dk, dv are written contiguous [B, N, H, 64], lse and di are fp32
// [B, H, N]. TMA loads rows >= N as zeros and they are never stored; key
// columns >= N get P = 0 in dQ, query columns >= N get lse = +inf (P = 0) in
// dK/dV. Nothing is padded in memory.
//
// What bounds them on an H100: the dQ kernel does three products of
// 2*B*H*N^2*64 flops (S, dP, dQ), the dK/dV kernel four (S, dP, dV, dK),
// each as three TF32 products at 495 TFLOP/s (165 TFLOP/s of fp32-grade
// products); each moves 6 tensors of B*N*H*64 fp32 plus lse and di. At ViT's
// N = 197 the bytes and the products weigh about the same; above, the
// products bound both kernels.
//
// Design (flash_attention_bwd.cu's machinery: persistent CTAs, TMA loads into
// rings guarded by full/empty mbarriers, products on wgmma):
//   * TF32 wgmma takes K-major operands only, so every tile lies as TMA loads
//     it. The score products S = Q K^T and dP = dO V^T (dK/dV: S^T = K Q^T,
//     dP^T = V dO^T) read both operands from shared memory, but dQ's dP takes
//     dO (head and tail) from registers, loaded once an item: shared
//     memory's bandwidth binds first, and a score product reads its A once a
//     pass. A second such A does not fit in the registers (ptxas then
//     serializes the wgmma). The gradients run transposed, with the loaded
//     tile as A in registers (read in the fragment's order) and the tile the
//     kernel makes as B in shared memory: dQ^T = K^T dS^T, dV^T = dO^T P,
//     dK^T = Q^T dS;
//   * an item is 64 rows of one (batch, head) (queries in dQ, keys in
//     dK/dV); the looped axis comes in ring tiles of 32 rows. The CTA's two
//     consumer warpgroups share the item's rows and take alternate ring
//     tiles, each summing a partial transposed gradient in registers; at the
//     item's end each adds the other's partial to its own for half the
//     columns (through shared memory) and stores them;
//   * the consumers split the item's tiles into heads (in place) and tails.
//     In dQ, O lands in Q's tail slot: warpgroup 0 first takes O into
//     registers, then Q is split, and while warpgroup 1 starts on its first
//     ring tile, warpgroup 0 forms di (O dO^T, its diagonal) and hands it
//     over through shared memory;
//   * the producer warpgroup: one thread issues every TMA load (the item's
//     tiles, then its ring tiles); the other three warps split each ring
//     tile and mark it ready (in dK/dV with the tile's lse, in log2 units and
//     +inf past N, and di beside it);
//   * per ring tile a consumer warpgroup issues the two score products,
//     waits, computes P and dS in registers, writes dS (dK/dV: P and dS) as
//     head and tail to its own shared tiles, loads its A fragments from the
//     ring tile, hands the ring tile back and issues the gradient products
//     without waiting. Its next score products queue behind them, and the
//     other warpgroup's products keep the tensor cores busy during its
//     exponentials;
//   * a last ring tile of at most 8 real rows (N = 197, 577 and 4097 each
//     end in one) runs as m64n8k8 score products and one 8-deep gradient
//     step.
//
// Shared memory binds the design (227 KB a CTA): an fp32 64 x 64 tile is
// 16 KB, twice bf16's, and every operand that wgmma reads from shared memory
// needs its tail beside it. dQ: the item's Q, dO and their tails 64 KB; per
// consumer warpgroup dS and its tail (64 x 32) 16 KB; a ring stage of K, V
// and their tails (32 rows) 32 KB, four stages 128 KB; lse and di 0.5 KB:
// 224.6 KB. dK/dV: the item's K, V and tails 64 KB; per warpgroup P, dS and
// tails 32 KB; three stages of Q, dO, tails, lse and di 96.8 KB: 224.8 KB.
// With 64-row ring stages (64 KB) one stage would fit; with a warpgroup's
// own 64 rows the item tiles alone would take 128 KB. One CTA an SM: 384
// threads start at 168 registers; the producer warpgroup drops to 56 and
// the consumers rise to 224.

#include "flash_attention_common.cuh"

namespace {

using flash::kHeadDim;  // 64
using flash::kLog2e;
using namespace flash::f32;  // the fp32 tiles' layout, split, fragments, tensor maps, grid

constexpr int kItemRows = 64;  // rows of an item: one warpgroup's M
constexpr int kTileRows = 32;  // rows of a ring tile (the looped axis)
constexpr int kItemElems = kItemRows * kHeadDim;
constexpr int kTileElems = kTileRows * kHeadDim;
constexpr int kGradElems = kItemRows * kTileRows;  // a gradient product's B
constexpr uint32_t kItemBytes = kItemElems * 4;
constexpr uint32_t kTileBytes = kTileElems * 4;

constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kConverters = 96;  // warps 1-3 of the producer warpgroup
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <= 65536,
              "registers over an SM's 65536");
constexpr int kDqStages = 4;
constexpr int kDkvStages = 3;
constexpr int kMaxSmem = 232448;  // a CTA's limit on an H100

// Named barriers (0 is __syncthreads): 1 + warpgroup for one consumer
// warpgroup; both consumer warpgroups; warpgroup 0's di handed to
// warpgroup 1 (dQ)
constexpr int kBarBoth = 3;
constexpr int kBarDi = 4;

struct alignas(1024) DqSmem {
  float q[kItemElems];  // the item's Q and dO, their tf32 heads once split
  float q_lo[kItemElems];  // O lands here first (for di), then Q's tail
  float dout[kItemElems];
  float dout_lo[kItemElems];
  float ds[kConsumers][2][kGradElems];  // a warpgroup's dS head and tail
  float k[kDqStages][kTileElems];
  float k_lo[kDqStages][kTileElems];
  float v[kDqStages][kTileElems];
  float v_lo[kDqStages][kTileElems];
  float lse[kItemRows];  // log2 units; 0 for rows >= N
  float di[kItemRows];
  uint64_t item_full, item_empty;
  uint64_t full[kDqStages], ready[kDqStages], empty[kDqStages];
};

struct alignas(1024) DkvSmem {
  float k[kItemElems];  // the item's K and V, their tf32 heads once split
  float k_lo[kItemElems];
  float v[kItemElems];
  float v_lo[kItemElems];
  float p[kConsumers][2][kGradElems];  // a warpgroup's P^T head and tail
  float ds[kConsumers][2][kGradElems];  // and dS^T's
  float q[kDkvStages][kTileElems];
  float q_lo[kDkvStages][kTileElems];
  float dout[kDkvStages][kTileElems];
  float dout_lo[kDkvStages][kTileElems];
  float lse[kDkvStages][kTileRows];  // log2 units; +inf for rows >= N
  float di[kDkvStages][kTileRows];   // 0 for rows >= N
  uint64_t item_full, item_empty;
  uint64_t full[kDkvStages], ready[kDkvStages], empty[kDkvStages];
};

// + slack to align the dynamic shared memory to 1024 bytes (the swizzle atom)
constexpr int kDqSmemBytes = sizeof(DqSmem) + 1024;
constexpr int kDkvSmemBytes = sizeof(DkvSmem) + 1024;
static_assert(kDqSmemBytes <= kMaxSmem, "dQ kernel: shared memory over a CTA's limit");
static_assert(kDkvSmemBytes <= kMaxSmem, "dK/dV kernel: shared memory over a CTA's limit");

template <typename T>
__device__ __forceinline__ T& aligned_smem(uint8_t* raw) {
  return *hopper::align_smem<T, 1024>(raw);
}

// Issue (without committing) d = A B^T over the 64 head dims in three TF32
// passes, tails before heads: A (64 item rows) and B (the first kCols rows
// of a ring tile) K-major in shared memory, heads and tails. kBTailFirst:
// B's tail pass (hi(A) lo(B)) before A's (lo(A) hi(B)); the order is dO's
// tail first in each kernel, as in di's product (issue_di)
template <int kCols, bool kBTailFirst>
__device__ __forceinline__ void product3(float (&d)[kCols / 2], const float* a, const float* a_lo,
                                         const float* b, const float* b_lo) {
  const uint64_t da = hopper::desc_b128(a, 16, 1024), da_lo = hopper::desc_b128(a_lo, 16, 1024);
  const uint64_t db = hopper::desc_b128(b, 16, 1024), db_lo = hopper::desc_b128(b_lo, 16, 1024);
  const uint64_t a1 = kBTailFirst ? da : da_lo, b1 = kBTailFirst ? db_lo : db;
  const uint64_t a2 = kBTailFirst ? da_lo : da, b2 = kBTailFirst ? db : db_lo;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    hopper::wgmma_tf32_ss<kCols>(d, a1 + step_off<kItemRows>(ks), b1 + step_off<kTileRows>(ks),
                                 ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    hopper::wgmma_tf32_ss<kCols>(d, a2 + step_off<kItemRows>(ks), b2 + step_off<kTileRows>(ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    hopper::wgmma_tf32_ss<kCols>(d, da + step_off<kItemRows>(ks), db + step_off<kTileRows>(ks), 1);
  }
}

// The A fragments (heads and tails) of acc += T^T B for a ring tile T (32
// rows x 64 head dims, rows kGradSteps * 8 of it): A(head dim m, tile row k)
// = T[k][m], this warp's head dims 16wl .. 16wl + 15, in the m16k8 layout
// (hopper::wgmma_tf32_rs). T's heads and tails are tf32 already.
template <int kGradSteps>
__device__ __forceinline__ void load_t_frags(unsigned (&f)[4][4], unsigned (&f_lo)[4][4],
                                             const float* t, const float* t_lo, int wl,
                                             int lane) {
#pragma unroll
  for (int ks = 0; ks < kGradSteps; ++ks) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int row = ks * 8 + (lane & 3) + (v >> 1) * 4;
      const int off = tile_off<kTileRows>(row, wl * 16 + (lane >> 2) + (v & 1) * 8);
      f[ks][v] = __float_as_uint(t[off]);
      f_lo[ks][v] = __float_as_uint(t_lo[off]);
    }
  }
}

// Write a value pair's tf32 heads and tails (columns col, col + 1 of row
// `row`) into a gradient product's B tile (64 rows x 32 columns, one
// swizzled block)
__device__ __forceinline__ void store_split(float* hi, float* lo, int row, int col, float x0,
                                            float x1) {
  const float h0 = hopper::to_tf32(x0), h1 = hopper::to_tf32(x1);
  const int off = swz(row, col);
  *reinterpret_cast<float2*>(hi + off) = make_float2(h0, h1);
  *reinterpret_cast<float2*>(lo + off) =
      make_float2(hopper::to_tf32(x0 - h0), hopper::to_tf32(x1 - h1));
}

// The two consumer warpgroups' partial transposed gradients acc (64 head dims
// x 64 item rows, wgmma layout: this thread's head dims d0 = 16wl + lane / 4
// and d0 + 8, rows 8j + 2(lane % 4) + {0, 1}) added and written as rows
// row0.. (< N) of contiguous [B, N, H, 64] tensors, the last of them times
// `scale`. Warpgroup kWg stores rows 32kWg .. 32kWg + 31 (registers 16kWg ..
// 16kWg + 15): it hands the other half of its partial over through `mine`
// (16 floats a thread and tensor) and adds the other warpgroup's from
// `theirs`. Ends with both warpgroups past their reads of each other's.
template <int kWg, int kAccs>
__device__ __forceinline__ void combine_store(const float (&acc)[kAccs][32], float* mine,
                                              const float* theirs, float* const (&out)[kAccs],
                                              float scale, int b, int h, int row0, int N, int H,
                                              int wl, int lane) {
  const int tw = (wl << 5) | lane;
#pragma unroll
  for (int a = 0; a < kAccs; ++a) {
#pragma unroll
    for (int i = 0; i < 16; ++i) mine[(a * 16 + i) * 128 + tw] = acc[a][(1 - kWg) * 16 + i];
  }
  hopper::named_barrier_sync(kBarBoth, kConsumers * 128);
#pragma unroll
  for (int a = 0; a < kAccs; ++a) {
    const float s = a == kAccs - 1 ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = kWg * 16 + i;
      const float sum = acc[a][e] + theirs[(a * 16 + i) * 128 + tw];
      const int d = wl * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
      const int n = row0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
      if (n < N) out[a][(((int64_t)b * N + n) * H + h) * kHeadDim + d] = sum * s;
    }
  }
  hopper::named_barrier_sync(kBarBoth, kConsumers * 128);
}

// dS = P (dP - di) of a dQ ring tile (64 queries x kCols keys key0..), with
// P = exp2(S * sm_scale * log2(e) - lse * log2(e)) and keys >= N masked,
// written as head and tail to the warpgroup's dS tiles. Register i of s and
// dp holds row 16wl + lane / 4 + 8((i >> 1) & 1), key column 8(i >> 2) +
// 2(lane % 4) + (i & 1).
template <int kCols>
__device__ __forceinline__ void dq_grads(float* ds, float* ds_lo, const float (&s)[kCols / 2],
                                         const float (&dp)[kCols / 2], const float (&lse2)[2],
                                         const float (&row_di)[2], int key0, int N,
                                         float scale_log2, int wl, int lane) {
  const bool ragged = key0 + kCols > N;
#pragma unroll
  for (int i = 0; i < kCols / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int col = (i >> 2) * 8 + (lane & 3) * 2;
    float g[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float p = exp2f(fmaf(s[i + c], scale_log2, -lse2[r]));
      if (ragged && key0 + col + c >= N) p = 0.f;
      g[c] = p * (dp[i + c] - row_di[r]);
    }
    store_split(ds, ds_lo, wl * 16 + (lane >> 2) + r * 8, col, g[0], g[1]);
  }
}

// P^T and dS^T = P^T (dP^T - di) of a dK/dV ring tile (64 keys x kCols
// queries): lse (log2 units, +inf past N) and di per query column, from the
// ring tile; written as heads and tails to the warpgroup's P and dS tiles
template <int kCols>
__device__ __forceinline__ void dkv_grads(float* p, float* p_lo, float* ds, float* ds_lo,
                                          const float (&s)[kCols / 2],
                                          const float (&dp)[kCols / 2], const float* lse,
                                          const float* di, float scale_log2, int wl, int lane) {
#pragma unroll
  for (int i = 0; i < kCols / 2; i += 2) {
    const int row = wl * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + (lane & 3) * 2;
    const float2 l = *reinterpret_cast<const float2*>(lse + col);
    const float2 d = *reinterpret_cast<const float2*>(di + col);
    const float p0 = exp2f(fmaf(s[i], scale_log2, -l.x));
    const float p1 = exp2f(fmaf(s[i + 1], scale_log2, -l.y));
    store_split(p, p_lo, row, col, p0, p1);
    store_split(ds, ds_lo, row, col, p0 * (dp[i] - d.x), p1 * (dp[i + 1] - d.y));
  }
}

// di = rowsum(dO * O) of a dQ item as the diagonal of O dO^T: O (raw fp32,
// in Q's tail slot) split in registers as the A operand, dO's head and tail
// in shared memory as B, three TF32 passes in dP's order (dO's tail first,
// then O's, then the heads), so that where O's row equals a row of V, di
// equals that dP bit for bit. Issued and committed here, without waiting;
// once O's registers are loaded, its slot may be overwritten.
__device__ __forceinline__ void issue_di(float (&d)[32], unsigned (&f)[kSteps][4],
                                         unsigned (&f_lo)[kSteps][4], const float* o,
                                         const float* dout, const float* dout_lo, int wl,
                                         int lane) {
  load_item_frags(f, o, wl, lane);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float x = __uint_as_float(f[ks][v]), hi = hopper::to_tf32(x);
      f[ks][v] = __float_as_uint(hi);
      f_lo[ks][v] = __float_as_uint(hopper::to_tf32(x - hi));
    }
  }
  hopper::wgmma_fence();
  product3_rs<kItemRows, kItemRows, true>(d, f, f_lo, dout, dout_lo);
  hopper::wgmma_commit();
}

// This thread's rows' (16wl + lane / 4, + 8) di from the waited product of
// issue_di: row 16wl + g's diagonal element is register 8wl + (g & 1) of
// lane 4g + g / 2, row 16wl + 8 + g's register 8wl + 6 + (g & 1) of the same
// lane (selected by constant indices: the accumulator stays in registers)
__device__ __forceinline__ void take_di(float (&row_di)[2], const float (&d)[32], int wl,
                                        int lane) {
  const int g = lane >> 2;
  float c0 = 0.f, c1 = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (r == 8 * wl + (g & 1)) c0 = d[r];
    if (r == 8 * wl + 6 + (g & 1)) c1 = d[r];
  }
  row_di[0] = __shfl_sync(0xffffffffu, c0, 4 * g + (g >> 1));
  row_di[1] = __shfl_sync(0xffffffffu, c1, 4 * g + (g >> 1));
}

// The ring tiles of an item: n_tiles of 32 rows, the last of at most 8 real
// rows runs as an 8-column tile
__device__ __forceinline__ bool short_tile(int t, int n_tiles, int N) {
  return t == n_tiles - 1 && N - t * kTileRows <= 8;
}

// Wait until ring tile u (the CTA's u-th; stage u % kStages, its fill
// u / kStages) is ready. The two consumer warpgroups take alternate tiles,
// so a stage's fills can alternate between them, and a warpgroup may reach
// fill k while the other still holds fill k - 1: a wait on ready's parity
// alone would then take fill k - 2's completed phase for fill k's. So it
// first waits for fill k - 1's release, after which ready is in fill k's
// phase or past it.
template <int kStages>
__device__ __forceinline__ void wait_ready(uint64_t (&ready)[kStages], uint64_t (&empty)[kStages],
                                           int u) {
  const int st = u % kStages, fill = u / kStages;
  if (fill > 0) hopper::mbar_wait(&empty[st], (fill - 1) & 1);
  hopper::mbar_wait(&ready[st], fill & 1);
}

// Producer warp, one thread: every TMA load of the CTA, item by item: the
// item's kItemTiles tiles of 64 rows (item_maps into item_dst), then its
// ring tiles, two of 32 rows a stage (ring0 into r0, ring1 into r1), in the
// order the consumers take them.
template <int kStages, int kItemTiles>
__device__ __forceinline__ void produce(const CUtensorMap* const (&item_maps)[kItemTiles],
                                        float* const (&item_dst)[kItemTiles],
                                        const CUtensorMap* ring0, const CUtensorMap* ring1,
                                        float (&r0)[kStages][kTileElems],
                                        float (&r1)[kStages][kTileElems], uint64_t* item_full,
                                        uint64_t* item_empty, uint64_t (&full)[kStages],
                                        uint64_t (&empty)[kStages], int items, int num_blocks,
                                        int n_tiles, int H) {
  int gt = 0;
  for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
    const int row0 = (item % num_blocks) * kItemRows;
    const int bh = item / num_blocks, b = bh / H, h = bh % H;
    // the item tiles last held item li - 1
    if (li > 0) hopper::mbar_wait(item_empty, (li - 1) & 1);
    hopper::mbar_arrive_expect_tx(item_full, kItemTiles * kItemBytes);
#pragma unroll
    for (int i = 0; i < kItemTiles; ++i) {
      load_tile<kItemRows>(item_dst[i], item_maps[i], item_full, h, row0, b);
    }
    for (int t = 0; t < n_tiles; ++t, ++gt) {
      const int st = gt % kStages;
      if (gt >= kStages) hopper::mbar_wait(&empty[st], ((gt / kStages) + 1) & 1);
      hopper::mbar_arrive_expect_tx(&full[st], 2 * kTileBytes);
      load_tile<kTileRows>(r0[st], ring0, &full[st], h, t * kTileRows, b);
      load_tile<kTileRows>(r1[st], ring1, &full[st], h, t * kTileRows, b);
    }
  }
}

// One dQ ring tile of kCols keys (32, or 8 for a short last tile) for this
// warpgroup: S = Q K^T and dP = dO V^T (dO's fragments of and of_lo, loaded
// once an item), dS into its shared tiles, the K^T fragments, the tile
// handed back, dQ^T += K^T dS^T issued (not waited). kf, kf_lo: the
// fragments of the product in flight, kept until the next wait.
template <int kCols>
__device__ __forceinline__ void dq_tile(DqSmem& s, int st, float (&acc)[32], unsigned (&kf)[4][4],
                                        unsigned (&kf_lo)[4][4], const unsigned (&of)[kSteps][4],
                                        const unsigned (&of_lo)[kSteps][4],
                                        const float (&lse2)[2], const float (&row_di)[2],
                                        int key0, int N, float scale_log2, int wg, int wl,
                                        int lane) {
  float* const ds = s.ds[wg][0];
  float* const ds_lo = s.ds[wg][1];
  float sc[kCols / 2], dpc[kCols / 2];
  hopper::wgmma_fence();
  product3<kCols, false>(sc, s.q, s.q_lo, s.k[st], s.k_lo[st]);
  product3_rs<kCols, kTileRows, false>(dpc, of, of_lo, s.v[st], s.v_lo[st]);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();  // the previous tile's dQ^T product too
  keep_frags(kf);
  keep_frags(kf_lo);
  hopper::fence_regs(sc);
  hopper::fence_regs(dpc);
  dq_grads<kCols>(ds, ds_lo, sc, dpc, lse2, row_di, key0, N, scale_log2, wl, lane);
  load_t_frags<kCols / 8>(kf, kf_lo, s.k[st], s.k_lo[st], wl, lane);
  hopper::fence_proxy_async();  // dS, before wgmma reads it
  // the warpgroup's barrier also waits for its loads of the ring tile (the
  // fragments); only then is the tile handed back. An mbarrier arrival alone
  // does not wait for loads in flight: the next TMA fill could land under
  // them, and whole head-dim rows of the gradient come from another tile
  hopper::named_barrier_sync(1 + wg, 128);
  hopper::mbar_arrive(&s.empty[st]);
  hopper::wgmma_fence();
  product3_rs_block<kCols / 8>(acc, kf, kf_lo, ds, ds_lo);
  hopper::wgmma_commit();
}

// One dK/dV ring tile of kCols queries for this warpgroup: S^T = K Q^T and
// dP^T = V dO^T, P^T and dS^T into its shared tiles, the dO^T and Q^T
// fragments, the tile handed back (as in dq_tile), dV^T += dO^T P and
// dK^T += Q^T dS issued (not waited)
template <int kCols>
__device__ __forceinline__ void dkv_tile(DkvSmem& s, int st, float (&acc)[2][32],
                                         unsigned (&of)[4][4], unsigned (&of_lo)[4][4],
                                         unsigned (&qf)[4][4], unsigned (&qf_lo)[4][4],
                                         float scale_log2, int wg, int wl, int lane) {
  float* const p = s.p[wg][0];
  float* const p_lo = s.p[wg][1];
  float* const ds = s.ds[wg][0];
  float* const ds_lo = s.ds[wg][1];
  float sc[kCols / 2], dpc[kCols / 2];
  hopper::wgmma_fence();
  product3<kCols, true>(sc, s.k, s.k_lo, s.q[st], s.q_lo[st]);
  product3<kCols, true>(dpc, s.v, s.v_lo, s.dout[st], s.dout_lo[st]);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();  // the previous tile's dV^T and dK^T products too
  keep_frags(of);
  keep_frags(of_lo);
  keep_frags(qf);
  keep_frags(qf_lo);
  hopper::fence_regs(sc);
  hopper::fence_regs(dpc);
  dkv_grads<kCols>(p, p_lo, ds, ds_lo, sc, dpc, s.lse[st], s.di[st], scale_log2, wl, lane);
  load_t_frags<kCols / 8>(of, of_lo, s.dout[st], s.dout_lo[st], wl, lane);
  load_t_frags<kCols / 8>(qf, qf_lo, s.q[st], s.q_lo[st], wl, lane);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1 + wg, 128);
  hopper::mbar_arrive(&s.empty[st]);
  hopper::wgmma_fence();
  product3_rs_block<kCols / 8>(acc[0], of, of_lo, p, p_lo);
  product3_rs_block<kCols / 8>(acc[1], qf, qf_lo, ds, ds_lo);
  hopper::wgmma_commit();
}

// Persistent: CTA c takes items c, c + gridDim.x, ... of the B * H *
// num_blocks (batch, head, 64-query block) items, the query blocks of one
// head neighbours (the K/V they all read stays in L2). `li` counts a CTA's
// items, `gt` its key tiles (ring stage gt % kDqStages).
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap to,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse, float* __restrict__ di,
                                  float* __restrict__ dq, int N, int H, int num_blocks, int items,
                                  float scale_log2, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& s = aligned_smem<DqSmem>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;

  if (tid == 0) {
    hopper::mbar_init(&s.item_full, 1);
    hopper::mbar_init(&s.item_empty, kConsumers * 128);
#pragma unroll
    for (int i = 0; i < kDqStages; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.ready[i], kConverters);
      hopper::mbar_init(&s.empty[i], 128);  // the warpgroup that took the tile
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers * 4) {
      if (lane == 0) {
        const CUtensorMap* const maps[3] = {&tq, &tdo, &to};
        float* const dst[3] = {s.q, s.dout, s.q_lo};  // O into Q's tail slot
        produce<kDqStages, 3>(maps, dst, &tk, &tv, s.k, s.v, &s.item_full, &s.item_empty,
                              s.full, s.empty, items, num_blocks, n_tiles, H);
      }
      return;
    }
    // converters: each ring tile's K and V split into heads and tails
    const int ct = tid - (kConsumers * 4 + 1) * 32;
    const int n_ring = ((items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * n_tiles;
    for (int gt = 0; gt < n_ring; ++gt) {
      const int st = gt % kDqStages;
      hopper::mbar_wait(&s.full[st], (gt / kDqStages) & 1);
      split<kConverters>(s.k[st], s.k_lo[st], kTileElems, ct);
      split<kConverters>(s.v[st], s.v_lo[st], kTileElems, ct);
      hopper::fence_proxy_async();  // the writes, before wgmma reads them
      hopper::mbar_arrive(&s.ready[st]);
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int wl = warp & 3;  // this warp's 16 rows of the 64 (of a product's M)
  const int tc = tid;       // 0..255 among the consumers
  float* const out[1] = {dq};
  int gt = 0;
  for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
    const int m0 = (item % num_blocks) * kItemRows;
    const int bh = item / num_blocks, b = bh / H, h = bh % H;
    hopper::mbar_wait(&s.item_full, li & 1);
    // dO's heads and tails (di's B operand and dP's A), the rows' lse; then
    // warpgroup 0 takes O into registers, and Q's split takes O's place
    split<kConsumers * 128>(s.dout, s.dout_lo, kItemElems, tc);
    if (tc < kItemRows) {
      const int n = m0 + tc;
      s.lse[tc] = n < N ? lse[(int64_t)bh * N + n] * kLog2e : 0.f;
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(kBarBoth, kConsumers * 128);
    // warpgroup 0 takes O into registers and issues di's product, Q's split
    // takes O's place meanwhile, then warpgroup 0 hands di to warpgroup 1
    float row_di[2];
    if (wg == 0) {
      float dd[32];
      unsigned of[kSteps][4], of_lo[kSteps][4];
      issue_di(dd, of, of_lo, s.q_lo, s.dout, s.dout_lo, wl, lane);
      hopper::named_barrier_sync(kBarBoth, kConsumers * 128);  // O is read
      split<kConsumers * 128>(s.q, s.q_lo, kItemElems, tc);
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(kBarBoth, kConsumers * 128);
      hopper::wgmma_wait<0>();
      keep_frags(of);
      keep_frags(of_lo);
      hopper::fence_regs(dd);
      take_di(row_di, dd, wl, lane);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wl * 16 + (lane >> 2) + r * 8, n = m0 + row;
          s.di[row] = row_di[r];
          if (n < N) di[(int64_t)bh * N + n] = row_di[r];
        }
      }
      hopper::named_barrier_arrive(kBarDi, kConsumers * 128);
    } else {
      hopper::named_barrier_sync(kBarBoth, kConsumers * 128);
      split<kConsumers * 128>(s.q, s.q_lo, kItemElems, tc);
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(kBarBoth, kConsumers * 128);
      hopper::named_barrier_sync(kBarDi, kConsumers * 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) row_di[r] = s.di[wl * 16 + (lane >> 2) + r * 8];
    }
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lse2[r] = s.lse[wl * 16 + (lane >> 2) + r * 8];
    // dO's fragments, dP's A for every ring tile of the item
    unsigned dof[kSteps][4], dof_lo[kSteps][4];
    load_item_frags(dof, s.dout, wl, lane);
    load_item_frags(dof_lo, s.dout_lo, wl, lane);
    float acc[1][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;
    // A fragments of the dQ^T product in flight
    unsigned kf[4][4] = {}, kf_lo[4][4] = {};
    for (int t = wg; t < n_tiles; t += kConsumers) {
      const int u = gt + t, st = u % kDqStages;
      wait_ready(s.ready, s.empty, u);
      if (short_tile(t, n_tiles, N)) {
        dq_tile<8>(s, st, acc[0], kf, kf_lo, dof, dof_lo, lse2, row_di, t * kTileRows, N,
                   scale_log2, wg, wl, lane);
      } else {
        dq_tile<kTileRows>(s, st, acc[0], kf, kf_lo, dof, dof_lo, lse2, row_di, t * kTileRows, N,
                           scale_log2, wg, wl, lane);
      }
    }
    hopper::wgmma_wait<0>();
    keep_frags(kf);
    keep_frags(kf_lo);
    keep_frags(dof);
    keep_frags(dof_lo);
    hopper::fence_regs(acc[0]);
    gt += n_tiles;
    // the item's tiles are read: the producer may load the next item's
    hopper::mbar_arrive(&s.item_empty);
    if (wg == 0) {
      combine_store<0, 1>(acc, s.ds[0][0], s.ds[1][0], out, sm_scale, b, h, m0, N, H, wl, lane);
    } else {
      combine_store<1, 1>(acc, s.ds[1][0], s.ds[0][0], out, sm_scale, b, h, m0, N, H, wl, lane);
    }
  }
}

// Persistent over the B * H * num_blocks (batch, head, 64-key block) items,
// the key blocks of one head neighbours (the Q and dO they all read stays in
// L2); the converters copy each ring tile's lse and di beside it.
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const float* __restrict__ lse, const float* __restrict__ di,
                                   float* __restrict__ dk, float* __restrict__ dv, int N, int H,
                                   int num_blocks, int items, float scale_log2, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& s = aligned_smem<DkvSmem>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;

  if (tid == 0) {
    hopper::mbar_init(&s.item_full, 1);
    hopper::mbar_init(&s.item_empty, kConsumers * 128);
#pragma unroll
    for (int i = 0; i < kDkvStages; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.ready[i], kConverters);
      hopper::mbar_init(&s.empty[i], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers * 4) {
      if (lane == 0) {
        const CUtensorMap* const maps[2] = {&tk, &tv};
        float* const dst[2] = {s.k, s.v};
        produce<kDkvStages, 2>(maps, dst, &tq, &tdo, s.q, s.dout, &s.item_full, &s.item_empty,
                               s.full, s.empty, items, num_blocks, n_tiles, H);
      }
      return;
    }
    // converters: each ring tile's Q and dO split, its rows' lse and di
    const int ct = tid - (kConsumers * 4 + 1) * 32;
    int gt = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int bh = item / num_blocks;
      for (int t = 0; t < n_tiles; ++t, ++gt) {
        const int st = gt % kDkvStages;
        hopper::mbar_wait(&s.full[st], (gt / kDkvStages) & 1);
        if (ct < kTileRows) {
          const int n = t * kTileRows + ct;
          s.lse[st][ct] = n < N ? lse[(int64_t)bh * N + n] * kLog2e : INFINITY;
          s.di[st][ct] = n < N ? di[(int64_t)bh * N + n] : 0.f;
        }
        split<kConverters>(s.q[st], s.q_lo[st], kTileElems, ct);
        split<kConverters>(s.dout[st], s.dout_lo[st], kTileElems, ct);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&s.ready[st]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int wl = warp & 3;
  const int tc = tid;
  float* const out[2] = {dv, dk};
  int gt = 0;
  for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
    const int n0 = (item % num_blocks) * kItemRows;
    const int bh = item / num_blocks, b = bh / H, h = bh % H;
    hopper::mbar_wait(&s.item_full, li & 1);
    split<kConsumers * 128>(s.k, s.k_lo, kItemElems, tc);
    split<kConsumers * 128>(s.v, s.v_lo, kItemElems, tc);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(kBarBoth, kConsumers * 128);
    float acc[2][32];  // dV^T, dK^T
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
    // A fragments of the dV^T (dO^T) and dK^T (Q^T) products in flight
    unsigned of[4][4] = {}, of_lo[4][4] = {}, qf[4][4] = {}, qf_lo[4][4] = {};
    for (int t = wg; t < n_tiles; t += kConsumers) {
      const int u = gt + t, st = u % kDkvStages;
      wait_ready(s.ready, s.empty, u);
      if (short_tile(t, n_tiles, N)) {
        dkv_tile<8>(s, st, acc, of, of_lo, qf, qf_lo, scale_log2, wg, wl, lane);
      } else {
        dkv_tile<kTileRows>(s, st, acc, of, of_lo, qf, qf_lo, scale_log2, wg, wl, lane);
      }
    }
    hopper::wgmma_wait<0>();
    keep_frags(of);
    keep_frags(of_lo);
    keep_frags(qf);
    keep_frags(qf_lo);
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    gt += n_tiles;
    hopper::mbar_arrive(&s.item_empty);
    if (wg == 0) {
      combine_store<0, 2>(acc, s.p[0][0], s.p[1][0], out, sm_scale, b, h, n0, N, H, wl, lane);
    } else {
      combine_store<1, 2>(acc, s.p[1][0], s.p[0][0], out, sm_scale, b, h, n0, N, H, wl, lane);
    }
  }
}

}  // namespace

extern "C" size_t flash_attention_f32_bwd_launch_bytes() { return sizeof(FlashLaunch); }

// q, k, v: [B, N, H, 64] fp32 with unit stride on the last axis and the byte
// strides l->qkv_stride on H, N and B, shared by the three; o and dout: the
// same shape with their own byte strides (l->o_stride, l->do_stride); each
// stride a multiple of 16, each base pointer 16-byte aligned (the tensor maps
// of dims (64, H, N, B)). lse: contiguous fp32 [B, H, N]. Writes dq
// (contiguous [B, N, H, 64] fp32) and di = rowsum(dout * o) (contiguous fp32
// [B, H, N]), which flash_attention_bwd_dkv_f32 then reads. Makes l->device
// current, launches on `stream`, allocates nothing, and returns a tensor
// map's encoding error or cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
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
  const int rows[5] = {kItemRows, kTileRows, kTileRows, kItemRows, kItemRows};
  for (int i = 0; i < 5; ++i) {
    const int err = encode_rows(&maps[i], bases[i], B, N, H, strides[i], rows[i]);
    if (err != 0) return err;
  }
  static int sms[64] = {0};
  int num_blocks = 0, items = 0, blocks = 0;
  const int err = persistent_grid((const void*)flash_attention_bwd_dq_f32_kernel, kDqSmemBytes,
                                  sms, l, kItemRows, &num_blocks, &items, &blocks);
  if (err != 0) return err;
  flash_attention_bwd_dq_f32_kernel<<<blocks, kThreads, kDqSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<float*>(di), static_cast<float*>(dq), N, H, num_blocks, items,
      l->sm_scale * kLog2e, l->sm_scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, lse and l as for flash_attention_bwd_dq_f32; di: the fp32
// [B, H, N] that it wrote. Writes dk and dv, contiguous [B, N, H, 64] fp32.
// Makes l->device current, launches on `stream`, allocates nothing, and
// returns a tensor map's encoding error or cudaGetLastError() after the
// launch.
extern "C" int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
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
  const int rows[4] = {kTileRows, kItemRows, kItemRows, kTileRows};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_rows(&maps[i], bases[i], B, N, H, strides[i], rows[i]);
    if (err != 0) return err;
  }
  static int sms[64] = {0};
  int num_blocks = 0, items = 0, blocks = 0;
  const int err = persistent_grid((const void*)flash_attention_bwd_dkv_f32_kernel, kDkvSmemBytes,
                                  sms, l, kItemRows, &num_blocks, &items, &blocks);
  if (err != 0) return err;
  flash_attention_bwd_dkv_f32_kernel<<<blocks, kThreads, kDkvSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv), N, H,
      num_blocks, items, l->sm_scale * kLog2e, l->sm_scale);
  return (int)cudaGetLastError();
}
