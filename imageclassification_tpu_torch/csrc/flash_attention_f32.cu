// Flash attention's forward in fp32 for Hopper (sm_90a), fp32 in and out,
// head_dim 64, every product on the warpgroup tensor cores in three TF32
// passes.
//
// Replaces: imageclassification_tpu/models/vit.py:25 `flash_attention_fn` in a
// model whose dtype is fp32 (`--half_precision false`), where the JAX package
// hands the Pallas TPU kernel (jax.experimental.pallas.ops.tpu.flash_attention)
// fp32 q, k and v: the forward (`_flash_attention_impl`, flash_attention.py:758).
// Its backward in fp32 is flash_attention_f32_bwd.cu; the bf16 kernels are
// flash_attention_fwd.cu and flash_attention_bwd.cu.
//
// Computes O = softmax(Q K^T * sm_scale) V, and, when the caller passes an
// lse buffer (autograd will run the backward), the natural-log row
// log-sum-exp lse = m + log(l) as fp32 [B, H, N], from which the backward
// recomputes P. q, k, v are read as [B, N, H, 64] through tensor maps of
// their strides (the views of ViT's fused qkv as they lie); O is written
// contiguous [B, N, H, 64]. The ragged tail is masked in the kernel: key
// columns >= N get P = 0, query rows >= N load as zeros (TMA) and are never
// stored. Nothing is padded in memory.
//
// Arithmetic: the JAX kernel's fp32 products, each as three TF32 products,
// as in flash_attention_f32_bwd.cu: an fp32 operand x is split into a tf32
// head hi = tf32(x) and tail lo = tf32(x - hi), both with their low 13 bits
// zero, and a product is lo*hi + hi*lo + hi*hi (the dropped lo*lo is ~2^-22
// of it), summed in fp32 on the tensor cores, the A operand's tail pass
// first. S = Q K^T runs in the dQ kernel's order for the same S, so the
// forward's S and the backward's recomputed S are summed alike. The online
// softmax is fp32 on the CUDA cores, with the scale folded into log2(e) and
// exp2f. Heads round by cvt.rna, which keeps a non-finite value non-finite;
// tails and P by two integer operations (hopper::to_tf32_finite, the same
// bits for finite values), which took 6-8 % off the kernel's time on an
// H100. No atomics, and every sum runs in one fixed order: two runs give the
// same bits.
//
// What bounds it on an H100: 4*B*H*N^2*64 flops (S and P V), each product as
// three TF32 products at 495 TFLOP/s (165 TFLOP/s of fp32-grade products);
// the bytes (q, k, v read once, o written once, 4 bytes an element) weigh
// about the same at ViT's N = 197, and the products bound it above.
//
// Design (flash_attention_f32_bwd.cu's machinery: persistent CTAs, a TMA ring
// guarded by full/ready/empty mbarriers, a producer warpgroup whose one
// thread issues every load and whose other three warps split each ring tile
// into tf32 heads and tails, two consumer warpgroups, setmaxnreg):
//   * an item is 128 query rows of one (batch, head); consumer warpgroup wg
//     takes rows 64wg .. 64wg + 63 and both take every ring tile of 32 keys,
//     so the split of a ring tile serves 128 rows;
//   * Q lands by TMA; each warpgroup loads its rows as the A fragments of
//     S = Q K^T and splits them into tf32 head and tail in registers (64
//     registers a thread), then hands Q's slot back for the next item's Q.
//     K's ring tile is the B operand exactly as TMA loads it (K-major over
//     the head dims), its head in place and its tail beside it;
//   * O = P V. TF32 wgmma takes K-major operands only, and V as loaded is
//     [keys, dims]: MN-major for the B of P V. Two ways round it: (a) Oᵀ =
//     Vᵀ Pᵀ, as the backward runs its gradients, with V's fragments as A and
//     P's head and tail written to shared memory as B; the per-row rescale
//     of the online softmax then falls on the accumulator's columns, which
//     other threads hold, so it goes through shared memory on every tile;
//     (b) the converter warps write Vᵀ's head and tail, and P, head and tail,
//     is A from registers. Chosen: (b). P never goes through shared memory
//     (in (a) each warpgroup would write 16 KB of P and its tail a tile, and
//     shared memory's bandwidth already carries every B operand), the
//     rescale stays in registers, and one transposed split serves both
//     warpgroups. TF32's A fragment (row lane / 4, columns lane % 4 and
//     lane % 4 + 4) is not the accumulator's layout (columns 2(lane % 4) and
//     2(lane % 4) + 1), so Vᵀ's columns hold the tile's keys permuted: in
//     each group of 8, column i is key 2i and column 4 + i is key 2i + 1
//     (i < 4). Each thread's S accumulators are then its P fragments as they
//     lie, and the product sums the same keys;
//   * per ring tile a consumer warpgroup issues S, waits (which also retires
//     the previous tile's P V, so that tile's stage goes back to the
//     producer), masks, runs the online softmax in registers, takes the
//     previous tile's P V into O and rescales it, splits P into head and
//     tail fragments and issues pv = P V without waiting. The other
//     warpgroup's products keep the tensor cores busy during its
//     exponentials;
//   * O sums the tiles' P V in fp32 on the CUDA cores, O = (O + pv) * alpha,
//     and each tile's P V starts from a zeroed accumulator. With O itself as
//     the accumulator (the tensor cores adding every tile's 12 steps into the
//     running sum) the output missed the plain version by 9.2e-6 at 2 x 4097
//     x 12 heads against the contract's 1.6e-5 on an H100; with pv, by
//     9.8e-7, for about 3 % more time (PERF.md);
//   * a last ring tile of at most 8 real keys (N = 197, 577 and 4097 each
//     end in one) runs as m64n8k8 score products and one 8-deep P V step;
//   * O / l is written from registers (two floats a store, a 32-byte sector
//     a row), lse by the first thread of each row's quad.
//
// Shared memory (227 KB a CTA), planned before the code: Q, 128 rows, 32 KB;
// a ring stage of 32 keys holds K's head and tail, V as loaded, and Vᵀ's
// head and tail, 5 x 8 KB; four stages 160 KB: 192 KB. 64-key stages (80 KB)
// would fit two, and a ring of two leaves no tile in flight while both are
// read. Registers: Q's head and tail 64 a thread, O 32, pv 32, S 16, P's head
// and tail 32 (in flight while the next tile's S is issued). One CTA an SM: 384
// threads start at 168 registers; the producer warpgroup drops to 56 and the
// consumers rise to 224.

#include "flash_attention_common.cuh"

namespace {

using flash::kHeadDim;  // 64
using flash::kLn2;
using flash::kLog2e;
using namespace flash::f32;  // the fp32 tiles' layout, split, fragments, tensor maps, grid

constexpr int kConsumers = 2;
constexpr int kWgRows = kFragRows;                // query rows of a consumer warpgroup
constexpr int kItemRows = kConsumers * kWgRows;   // 128
constexpr int kTileRows = 32;                     // keys of a ring tile
constexpr int kQElems = kWgRows * kHeadDim;
constexpr int kTileElems = kTileRows * kHeadDim;
constexpr uint32_t kQBytes = kQElems * 4;
constexpr uint32_t kTileBytes = kTileElems * 4;

constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kConverters = 96;  // warps 1-3 of the producer warpgroup
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <= 65536,
              "registers over an SM's 65536");
constexpr int kStages = 4;
constexpr int kMaxSmem = 232448;  // a CTA's limit on an H100

struct alignas(1024) FwdSmem {
  float q[kConsumers][kQElems];      // each warpgroup's 64 query rows, as loaded
  float k[kStages][kTileElems];      // the ring tile's K, its tf32 heads once split
  float k_lo[kStages][kTileElems];
  float v[kStages][kTileElems];      // V as loaded
  float vt[kStages][kTileElems];     // Vᵀ's heads: 64 head dims x 32 keys (permuted)
  float vt_lo[kStages][kTileElems];  // and tails
  uint64_t q_full, q_empty;
  uint64_t full[kStages], ready[kStages], empty[kStages];
};

// + slack to align the dynamic shared memory to 1024 bytes (the swizzle atom)
constexpr int kSmemBytes = sizeof(FwdSmem) + 1024;
static_assert(kSmemBytes <= kMaxSmem, "shared memory over a CTA's limit");

// Vᵀ's tf32 heads and tails from a ring tile's V (32 keys x 64 head dims as
// TMA wrote it), by the converters (this one the t-th): row d of vt and vt_lo
// (64 head dims x 32 columns, one swizzled block) holds the tile's keys in the
// order of P's A fragments, column 8c + i key 8c + 2i and column 8c + 4 + i
// key 8c + 2i + 1 (i < 4). A thread reads four keys of one head dim (a warp:
// one key of 32 head dims, no bank conflict) and writes 16 bytes of each of
// vt and vt_lo (8 lanes: 8 rows' chunks, no bank conflict).
__device__ __forceinline__ void split_transposed(const float* v, float* vt, float* vt_lo, int t) {
#pragma unroll 2
  for (int i = t; i < kHeadDim * kTileRows / 4; i += kConverters) {
    const int d = i % kHeadDim;
    const int chunk = i / kHeadDim;                   // columns 4 chunk .. 4 chunk + 3
    const int key = (chunk >> 1) * 8 + (chunk & 1);  // keys key, key + 2, key + 4, key + 6
    float x[4], hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = v[tile_off<kTileRows>(key + 2 * j, d)];
      hi[j] = hopper::to_tf32(x[j]);
      lo[j] = hopper::to_tf32_finite(x[j] - hi[j]);
    }
    const int off = swz(d, chunk * 4);
    *reinterpret_cast<float4*>(vt + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(vt_lo + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The online softmax of one tile of kCols keys key0.. for this thread's rows
// (16wl + lane / 4 and 8 below; register i of sc holds row (i >> 1) & 1, key
// column 8(i >> 2) + 2(lane % 4) + (i & 1)): keys >= N masked, the running
// maxima m (log2 units) and partial sums l updated, O taking the previous
// tile's P V and rescaled, O = (O + pv) * alpha, pv zeroed, and P split into
// the head and tail A fragments of P V (rounded by integer operations: a
// non-finite P makes l, and so the row's output, non-finite): in each 8-key
// step the
// fragment's (row, column) pairs (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4) (t = lane % 4) take the accumulators of keys 2t, 2t, 2t + 1, 2t + 1,
// Vᵀ's permuted columns t and t + 4.
template <int kCols>
__device__ __forceinline__ void softmax_tile(float (&sc)[kCols / 2], float (&m)[2], float (&l)[2],
                                             float (&o)[32], float (&pv)[32],
                                             unsigned (&pf)[4][4], unsigned (&pf_lo)[4][4],
                                             int key0, int N, float scale_log2, int lane) {
  if (key0 + kCols > N) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) {
      if (key0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1) >= N) sc[i] = -INFINITY;
    }
  }
  // every tile holds at least one real key, so the new maximum is finite and
  // masked columns give 0
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      mt = fmaxf(mt, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[r], mt * scale_log2);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2f(fmaf(sc[i], scale_log2, -m[r]));
    l[r] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] = (o[i] + pv[i]) * alpha[(i >> 1) & 1];
    pv[i] = 0.f;  // this tile's P V starts afresh
  }
#pragma unroll
  for (int ks = 0; ks < kCols / 8; ++ks) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float x = sc[4 * ks + ((v & 1) << 1) + (v >> 1)], hi = hopper::to_tf32_finite(x);
      pf[ks][v] = __float_as_uint(hi);
      pf_lo[ks][v] = __float_as_uint(hopper::to_tf32_finite(x - hi));
    }
  }
}

// One ring tile (stage st, keys key0..) of this warpgroup: S issued and
// waited (with the previous tile's P V, whose stage `prev` >= 0 then goes
// back to the producer), the online softmax, pv += P V issued (not waited).
// pf, pf_lo: the fragments of the P V product in flight, kept until the next
// wait.
template <int kCols>
__device__ __forceinline__ void attend_tile(FwdSmem& s, int st, int prev, float (&o)[32],
                                            float (&pv)[32], float (&m)[2], float (&l)[2],
                                            const unsigned (&qf)[kSteps][4],
                                            const unsigned (&qf_lo)[kSteps][4],
                                            unsigned (&pf)[4][4], unsigned (&pf_lo)[4][4],
                                            int key0, int N, float scale_log2, int lane) {
  float sc[kCols / 2];
  hopper::wgmma_fence();
  // lo(Q) hi(K) first: the dQ kernel's order for the same S
  product3_rs<kCols, kTileRows, false>(sc, qf, qf_lo, s.k[st], s.k_lo[st]);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();  // the previous tile's P V too
  keep_frags(qf);
  keep_frags(qf_lo);
  keep_frags(pf);
  keep_frags(pf_lo);
  hopper::fence_regs(sc);
  hopper::fence_regs(pv);
  if (prev >= 0) hopper::mbar_arrive(&s.empty[prev]);
  softmax_tile<kCols>(sc, m, l, o, pv, pf, pf_lo, key0, N, scale_log2, lane);
  hopper::fence_regs(pv);
  hopper::wgmma_fence();
  product3_rs_block<kCols / 8>(pv, pf, pf_lo, s.vt[st], s.vt_lo[st]);
  hopper::wgmma_commit();
}

// Persistent: CTA c takes items c, c + gridDim.x, ... of the B * H *
// num_blocks (batch, head, 128-query block) items, the query blocks of one
// head neighbours (the K/V they all read stays in L2). `li` counts a CTA's
// items, `gt` its key tiles (ring stage gt % kStages).
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                               float* __restrict__ lse, int N, int H, int num_blocks, int items,
                               float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& s = *hopper::align_smem<FwdSmem, 1024>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;

  if (tid == 0) {
    hopper::mbar_init(&s.q_full, 1);
    hopper::mbar_init(&s.q_empty, kConsumers * 128);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.ready[i], kConverters);
      hopper::mbar_init(&s.empty[i], kConsumers * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers * 4) {
      // producer, one thread: each item's Q (the rows of the warpgroups that
      // have any below N), then its ring tiles of K and V
      if (lane == 0) {
        int gt = 0;
        for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
          const int row0 = (item % num_blocks) * kItemRows;
          const int bh = item / num_blocks, b = bh / H, h = bh % H;
          const int consumers = min(kConsumers, (N - row0 + kWgRows - 1) / kWgRows);
          // Q's slot last held item li - 1
          if (li > 0) hopper::mbar_wait(&s.q_empty, (li - 1) & 1);
          hopper::mbar_arrive_expect_tx(&s.q_full, consumers * kQBytes);
          for (int c = 0; c < consumers; ++c) {
            load_tile<kWgRows>(s.q[c], &tq, &s.q_full, h, row0 + c * kWgRows, b);
          }
          for (int t = 0; t < n_tiles; ++t, ++gt) {
            const int st = gt % kStages;
            // stage st last held tile gt - kStages: wait for its release
            if (gt >= kStages) hopper::mbar_wait(&s.empty[st], ((gt / kStages) + 1) & 1);
            hopper::mbar_arrive_expect_tx(&s.full[st], 2 * kTileBytes);
            load_tile<kTileRows>(s.k[st], &tk, &s.full[st], h, t * kTileRows, b);
            load_tile<kTileRows>(s.v[st], &tv, &s.full[st], h, t * kTileRows, b);
          }
        }
      }
      return;
    }
    // converters: each ring tile's K split in place, V split into Vᵀ
    const int ct = tid - (kConsumers * 4 + 1) * 32;
    const int n_ring = ((items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * n_tiles;
    for (int gt = 0; gt < n_ring; ++gt) {
      const int st = gt % kStages;
      hopper::mbar_wait(&s.full[st], (gt / kStages) & 1);
      split<kConverters>(s.k[st], s.k_lo[st], kTileElems, ct);
      split_transposed(s.v[st], s.vt[st], s.vt_lo[st], ct);
      hopper::fence_proxy_async();  // the writes, before wgmma reads them
      hopper::mbar_arrive(&s.ready[st]);
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int wl = warp & 3;  // this warp's 16 rows of the warpgroup's 64
  const int g = lane >> 2;  // this thread's rows g and g + 8 of them
  int gt = 0;
  for (int item = blockIdx.x, li = 0; item < items; item += gridDim.x, ++li) {
    const int m0 = (item % num_blocks) * kItemRows + wg * kWgRows;  // this warpgroup's rows
    const int bh = item / num_blocks, b = bh / H, h = bh % H;
    // a warpgroup whose rows all lie past N only keeps the barriers' counts
    const bool active = m0 < N;
    hopper::mbar_wait(&s.q_full, li & 1);
    unsigned qf[kSteps][4], qf_lo[kSteps][4];
    if (active) {
      load_item_frags(qf, s.q[wg], wl, lane);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float x = __uint_as_float(qf[ks][v]), hi = hopper::to_tf32(x);
          qf[ks][v] = __float_as_uint(hi);
          qf_lo[ks][v] = __float_as_uint(hopper::to_tf32_finite(x - hi));
        }
      }
    }
    // Q's slot goes back once the warpgroup's loads of it are done: the
    // named barrier waits for them (an mbarrier arrival alone does not), the
    // fence orders them before the next item's TMA writes
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + wg, 128);
    hopper::mbar_arrive(&s.q_empty);
    if (!active) {
      for (int t = 0; t < n_tiles; ++t, ++gt) {
        const int st = gt % kStages;
        hopper::mbar_wait(&s.ready[st], (gt / kStages) & 1);
        hopper::mbar_arrive(&s.empty[st]);
      }
      continue;
    }
    // O in fp32 on the CUDA cores, and pv, a tile's P V on the tensor cores,
    // added to O at the next tile's softmax
    float acc[32], pv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = pv[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // row maxima, log2 units
    float l[2] = {0.f, 0.f};              // partial row sums over this thread's columns
    unsigned pf[4][4] = {}, pf_lo[4][4] = {};  // P's fragments of the P V in flight
    for (int t = 0; t < n_tiles; ++t, ++gt) {
      const int st = gt % kStages, prev = t > 0 ? (gt - 1) % kStages : -1;
      // both warpgroups take every tile, so ready's parity alone is safe:
      // fill k - 1 of this stage was this warpgroup's own tile
      hopper::mbar_wait(&s.ready[st], (gt / kStages) & 1);
      const int key0 = t * kTileRows;
      if (t == n_tiles - 1 && N - key0 <= 8) {
        attend_tile<8>(s, st, prev, acc, pv, m, l, qf, qf_lo, pf, pf_lo, key0, N, scale_log2,
                       lane);
      } else {
        attend_tile<kTileRows>(s, st, prev, acc, pv, m, l, qf, qf_lo, pf, pf_lo, key0, N,
                               scale_log2, lane);
      }
    }
    hopper::wgmma_wait<0>();
    keep_frags(qf);
    keep_frags(qf_lo);
    keep_frags(pf);
    keep_frags(pf_lo);
    hopper::fence_regs(pv);
    hopper::mbar_arrive(&s.empty[(gt - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += pv[i];

    // the four threads of a quad share a row: their partial sums in a fixed
    // order; O / l and lse for the rows below N
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = m0 + wl * 16 + g + r * 8;
      if (n >= N) continue;
      const float inv = 1.f / l[r];
      float* const row = o + (((int64_t)b * N + n) * H + h) * kHeadDim + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
      if (lse != nullptr && (lane & 3) == 0) {
        lse[(int64_t)bh * N + n] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

}  // namespace

// The tensors as for the bf16 entry point (flash_attention_fwd.cu), fp32:
// q, k, v [B, N, H, 64] with unit stride on the last axis and the byte
// strides l->qkv_stride on H, N and B (the same for all three; each a
// multiple of 16, each base pointer 16-byte aligned): the tensor maps of dims
// (64, H, N, B). o: contiguous [B, N, H, 64] fp32. lse: contiguous fp32
// [B, H, N], or null to skip it. Makes l->device current, launches on
// `stream`, allocates nothing, and returns a tensor map's encoding error or
// cudaGetLastError() after the launch.
extern "C" size_t flash_attention_f32_launch_bytes() { return sizeof(FlashLaunch); }

extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, const FlashLaunch* l, void* stream) {
  const int B = l->B, N = l->N, H = l->H;
  if (B == 0 || N == 0 || H == 0) return 0;
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int rows[3] = {kWgRows, kTileRows, kTileRows};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_rows(&maps[i], bases[i], B, N, H, l->qkv_stride, rows[i]);
    if (err != 0) return err;
  }
  static int sms[64] = {0};
  int num_blocks = 0, items = 0, blocks = 0;
  const int err = persistent_grid((const void*)flash_attention_fwd_f32_kernel, kSmemBytes, sms,
                                  l, kItemRows, &num_blocks, &items, &blocks);
  if (err != 0) return err;
  flash_attention_fwd_f32_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), static_cast<float*>(lse), N, H,
      num_blocks, items, l->sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
