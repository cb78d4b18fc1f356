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
// (M = 3136 at batch 64, K x N = 512 x 2048). So x and y cross device memory
// once each, with enough bytes in flight to keep the memory busy, and the
// products run on the warpgroup tensor cores (wgmma), the only way to their
// full rate:
//
// - Persistent CTAs, one an SM: CTA (slot, N-tile) computes the 128 x 128
//   tiles of y of M-tiles slot, slot + slots, ... of its N-tile (the CTAs of
//   one slot walk the same M-tiles together, so x is read from device memory
//   about once and from L2 by the other N-tiles). Its W slice (K x 128)
//   stays in shared memory when it fits beside the ring (K <= 512), loaded
//   once; otherwise each 64-deep chunk of it is streamed with x's.
// - A producer thread keeps a ring of up to 8 stages loading by TMA: a stage
//   is one 64-deep chunk of an x tile (128 rows x 128 bytes, 128-byte
//   swizzle, zero-filled past M and K), with its W chunk when streamed; two
//   consumer warpgroups of 64 rows run the products, m64n128k16 with B (W)
//   read MN-major from shared memory (m64n64k16 on an N-tile whose last 64
//   columns lie past N: the consumer loop is compiled for each width, so no
//   branch falls between products), one chunk's group in flight while the
//   next is issued, and hand each stage back through an mbarrier.
// - The prologue: a warp loads its A fragments from the swizzled x chunk
//   (ldmatrix), computes x * scale + shift in fp32 (multiply, then add, as
//   the plain version) with scale and shift from shared memory, rounds to
//   bf16 before the register-A product (the rounding point of
//   `_kernel_bn_in` and of the plain version) and applies the relu to the
//   rounded pair, one instruction for two values (rounding keeps the sign and
//   maps 0 to 0, so the values are the plain version's). Without it A is
//   read from shared memory.
// - The epilogue: each thread adds its rows of its columns' fp32 accumulators
//   to sums and sums of squares that stay in registers across every tile the
//   CTA walks (rows past M left out: with the prologue their zeros became
//   relu(shift)). y is rounded to bf16 into a swizzled staging tile (no bank
//   conflicts) and written by TMA stores, which clip rows past M and columns
//   past N and run on while the next tile's products do.
// - At the end each CTA adds its warps' sums in a fixed order into one
//   partial row of [P, 2N] (sums, then sums of squares), and one
//   vec::sum_partials pass adds the P rows in a fixed order: no atomics, the
//   same bits on every run.
//
// The Pallas kernel keeps the whole weight in VMEM and carries the
// statistics across sequential grid steps; here the host plans the split
// and the shared-memory layout (ops/conv1x1_bn.py `k2_plan`), which the
// launch checks. K and N must be multiples of 8 (16-byte rows for TMA),
// which the wrapper checks; M is any.

#include "hopper_common.cuh"
#include "mma_common.cuh"
#include "vec_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kConsumers = 2;                         // warpgroups of 64 rows
constexpr int kConsumerThreads = kConsumers * 128;
// + a producer warpgroup of which one thread works: a warpgroup, so that it
// can hand its registers to the consumers (setmaxnreg). At launch a thread
// gets 168 registers (65536 over 384 threads, in steps of 8); the producer
// drops to 40 and the consumers rise to 232, which hold the accumulators,
// the statistics and two chunks' A fragments without spills
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumerThreads * kConsumerRegs <= 65536,
              "registers over an SM's 65536");
constexpr int kBlocks = kBN / 64;                     // 64-column blocks of a tile
constexpr int kChunkBytes = kBM * kBK * 2;            // an x chunk: 16 KB
constexpr int kBoxBytes = 64 * 64 * 2;                // a W or y box, 64 x 64: 8 KB
constexpr int kWChunkBytes = kBlocks * kBoxBytes;     // a W chunk, 64 x 128: 16 KB
constexpr int kYBytes = kConsumers * kBlocks * kBoxBytes;  // y staging: 32 KB
constexpr int kRedBytes = 2 * kConsumers * 4 * kBN * 4;    // the warps' column sums: 8 KB
constexpr int kMaxStages = 8;
// the dynamic shared memory a CTA may ask for: 227 KB, less its barriers
constexpr int kSmemMax = 232448 - 1024;

// The launch's split and shared-memory layout, computed on the host by
// ops/conv1x1_bn.py `k2_plan` (its `K2Plan`, field by field) and checked by
// `plan_holds`. Dynamic shared memory, from a 1024-byte aligned base: the
// resident W (w_bytes: k_chunks chunks of 64 x 128), the ring (stages x
// stage_bytes: the x chunk, then the W chunk when streamed), y staging
// (kYBytes), scale and shift (ss_bytes: 2 x k_chunks x 64 fp32 with the
// prologue), the warps' column sums (kRedBytes), + 1024 of alignment.
struct Plan {
  int m_tiles;      // ceil(M / 128)
  int n_tiles;      // ceil(N / 128): the grid's y
  int k_chunks;     // ceil(K / 64)
  int slots;        // CTAs an N-tile: the grid's x, one partial row each
  int resident;     // 1: W's K x 128 slice stays in shared memory
  int stages;       // ring stages, 2 to kMaxStages
  int stage_bytes;  // kChunkBytes (+ kWChunkBytes when W is streamed)
  int w_bytes;      // k_chunks x kWChunkBytes when resident, else 0
  int ss_bytes;     // 2 x k_chunks x 64 x 4 with the prologue, else 0
  int smem_bytes;
};

bool plan_holds(const Plan& p, int64_t M, int K, int N, bool bn_in) {
  const int64_t used = (int64_t)p.w_bytes + (int64_t)p.stages * p.stage_bytes + kYBytes +
                       p.ss_bytes + kRedBytes + 1024;
  return p.m_tiles == (M + kBM - 1) / kBM && p.n_tiles == (N + kBN - 1) / kBN &&
         p.k_chunks == (K + kBK - 1) / kBK && p.slots >= 1 && p.slots <= p.m_tiles &&
         (p.resident == 0 || p.resident == 1) && p.stages >= 2 && p.stages <= kMaxStages &&
         p.stage_bytes == kChunkBytes + (p.resident ? 0 : kWChunkBytes) &&
         p.w_bytes == (p.resident ? p.k_chunks * kWChunkBytes : 0) &&
         p.ss_bytes == (bn_in ? 2 * p.k_chunks * kBK * 4 : 0) && p.smem_bytes == used &&
         p.smem_bytes <= kSmemMax;
}

// bf16(maybe_relu(x * s + h)) for a pair of bf16 x (low half the lower
// column), x * s + h in fp32 (a multiply, then an add, as the plain
// version). The relu comes after the rounding, on the pair at once:
// rounding keeps the sign and maps 0 to 0, so this is the rounded relu;
// __hmax2_nan keeps a NaN, as torch.relu does
template <bool kRelu>
__device__ __forceinline__ unsigned prologue2(unsigned v, float2 s, float2 h) {
  const float a = __fadd_rn(__fmul_rn(__uint_as_float(v << 16), s.x), h.x);
  const float b = __fadd_rn(__fmul_rn(__uint_as_float(v & 0xffff0000u), s.y), h.y);
  __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  if (kRelu) r = __hmax2_nan(r, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<unsigned*>(&r);
}

// The warp's A fragments of the four 16-deep steps of an x chunk, with
// the prologue: xa is the warpgroup's 64 rows of the chunk (128 bytes a row,
// the 16-byte pieces of row r at piece ^ (r % 8), as TMA's 128-byte swizzle
// lays them); sc, sh the scale and shift of the chunk's 64 columns. Laid
// out as for mma.sync m16n8k16: a[ks][0] row g, columns 16ks + 2t, +1;
// [1] row g + 8; [2] and [3] the same 8 columns on. A chunk past K holds
// zeros (TMA's) and zero scale and shift, so all four steps are loaded,
// every load first, and the products run all four.
template <bool kRelu>
__device__ __forceinline__ void load_frags(unsigned (&a)[4][4], const uint8_t* xa,
                                           const float* sc, const float* sh, int wl, int lane) {
  const int row = wl * 16 + (lane & 15);
  const uint8_t* rp = xa + row * 128;
  const int t = lane & 3;
  unsigned r[4][4];
  float2 s[4][2], h[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int piece = 2 * ks + (lane >> 4);
    mma::ldmatrix_x4(r[ks], reinterpret_cast<const bf16*>(rp + ((piece ^ (row & 7)) << 4)));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = 16 * ks + 8 * half + 2 * t;
      s[ks][half] = *reinterpret_cast<const float2*>(sc + k);
      h[ks][half] = *reinterpret_cast<const float2*>(sh + k);
    }
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[ks][i] = prologue2<kRelu>(r[ks][i], s[ks][i >> 1], h[ks][i >> 1]);
  }
}

// The four 16-deep products of one x chunk into acc (kN = 128: both W
// boxes, the second at a leading-dimension offset of one box; 64: the first
// alone), as straight-line code of one shape: the consumer loop is
// instantiated for each tile width (`consume`), so no branch between the two
// forms falls between products (with one, ptxas injected warpgroup.arrives
// at its joins, info C7519). A chunk past K holds zeros, so all four steps
// run. W is stored MN-major (a K row's 64 values contiguous, box after box):
// a step is 16 rows, 2048 bytes; x K-major, a step 32 bytes along a row.
template <bool kBnIn, int kN>
__device__ __forceinline__ void issue_steps(float (&acc)[kN / 2], const unsigned (&a)[4][4],
                                            const uint8_t* xa, const uint8_t* wb, bool first) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t db = hopper::desc_b128(wb, kBoxBytes, 1024) + 128 * ks;
    const int scale_d = first && ks == 0 ? 0 : 1;
    if constexpr (kBnIn) {
      hopper::wgmma_m64k16_rs<kN, 1>(acc, a[ks], db, scale_d);
    } else {
      hopper::wgmma_m64k16_ss<kN, 1>(acc, hopper::desc_b128(xa, 16, 1024) + 2 * ks, db,
                                     scale_d);
    }
  }
}

// Issue one x chunk's products as one wgmma group: A the fragments `a` (the
// prologue) or the chunk in shared memory (xa); B the chunk's kNB W boxes at
// wb
template <bool kBnIn, int kNB>
__device__ __forceinline__ void issue_chunk(float (&acc)[kNB * 32], const unsigned (&a)[4][4],
                                            const uint8_t* xa, const uint8_t* wb, bool first) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  issue_steps<kBnIn, kNB * 64>(acc, a, xa, wb, first);
  hopper::wgmma_commit();
}

// What the consumer warpgroups of a CTA share, from the kernel's set-up
struct Consumer {
  const uint8_t* ring;
  const uint8_t* wres;
  uint8_t* ystage;
  const float* sc;
  const float* sh;
  float* red;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* w_full;
  const CUtensorMap* ty;
  float* part;
  int64_t M;
  int N, n0, tid;
  int64_t step;
};

// The consumer warpgroups over an N-tile of kNB 64-column blocks (2: 128
// columns; 1: the tile's last 64 lie past N): warpgroup wg owns rows 64 wg ..
// 64 wg + 63 of each tile; a thread holds rows g and g + 8 of its warp's 16
// and, in each 64-column block, columns 8 jj + 2t, + 1 (jj = 0..7)
template <bool kBnIn, bool kRelu, int kNB>
__device__ __forceinline__ void consume(const Consumer& s, const Plan& p) {
  const uint8_t* const ring = s.ring;
  const uint8_t* const wres = s.wres;
  const float* const sc = s.sc;
  const float* const sh = s.sh;
  float* const red = s.red;
  uint64_t* const full = s.full;
  uint64_t* const empty = s.empty;
  const int64_t M = s.M, step = s.step;
  const int N = s.N, n0 = s.n0;
  const int tid = s.tid, warp = tid >> 5, lane = tid & 31;
  const int stages = p.stages, chunks = p.k_chunks;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool lead = (tid & 127) == 0;
  float sum[kNB][16], sq[kNB][16];
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) sum[j][i] = sq[j][i] = 0.f;
  if (p.resident) hopper::mbar_wait(s.w_full, 0);

  uint8_t* const ys = s.ystage + wg * kBlocks * kBoxBytes;
  int gc = 0;
  for (int64_t mt = blockIdx.x; mt < p.m_tiles; mt += step) {
    float acc[kNB * 32];  // block j, columns 8 jj + 2t, + 1 of rows g and g + 8:
                         // acc[32 j + 4 jj + 2h + e]
    unsigned a[2][4][4];  // two chunks' fragments: one in flight, one being built
    // chunk c: wait for its stage, build its fragments, issue its products,
    // then wait for chunk c - 1's and hand that stage back
    auto run = [&](int c, unsigned (&frag)[4][4]) {
      const int st = gc % stages;
      hopper::mbar_wait(&full[st], (gc / stages) & 1);
      const uint8_t* buf = ring + st * p.stage_bytes;
      const uint8_t* xa = buf + wg * 64 * 128;
      const uint8_t* wb = p.resident ? wres + c * kWChunkBytes : buf + kChunkBytes;
      if constexpr (kBnIn) {
        load_frags<kRelu>(frag, xa, sc + c * kBK, sh + c * kBK, wl, lane);
      }
      issue_chunk<kBnIn, kNB>(acc, frag, xa, wb, c == 0);
      hopper::wgmma_wait<1>();
      if (c > 0 && lead) hopper::mbar_arrive(&empty[(gc - 1) % stages]);
      ++gc;
    };
    // every path from chunk c's products to the next that rebuilds its
    // fragments passes the wait that retires them: the loop exits as soon as
    // the chunks run out (ptxas serializes the products when a path could
    // rebuild fragments that a product in flight reads)
    for (int c = 0;; c += 2) {
      run(c, a[0]);
      if (c + 1 == chunks) break;
      run(c + 1, a[1]);
      if (c + 2 == chunks) break;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lead) hopper::mbar_arrive(&empty[(gc - 1) % stages]);

    // statistics of the fp32 accumulators, rows past M left out
    const int64_t m0 = mt * kBM + wg * 64;
    const int64_t r0 = m0 + wl * 16 + g;
    const bool v0 = r0 < M, v1 = r0 + 8 < M;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float v = acc[32 * j + i];
        const int col = 2 * (i >> 2) + (i & 1);
        if ((i & 2) ? v1 : v0) {
          sum[j][col] += v;
          sq[j][col] = fmaf(v, v, sq[j][col]);
        }
      }
    }
    // y: the warpgroup's staging tile is free once its last store has read
    // it; write it in bf16 in the 128-byte swizzle, then store it by TMA
    if (lead) hopper::bulk_wait_read<0>();
    hopper::named_barrier_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wl * 16 + g + 8 * h;
          *reinterpret_cast<unsigned*>(ys + j * kBoxBytes + row * 128 +
                                       ((jj ^ (row & 7)) << 4) + 4 * t) =
              mma::pack_bf16(acc[32 * j + 4 * jj + 2 * h], acc[32 * j + 4 * jj + 2 * h + 1]);
        }
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + wg, 128);
    if (lead && m0 < M) {
      for (int j = 0; j < kNB; ++j) hopper::tma_store_2d(s.ty, ys + j * kBoxBytes, n0 + 64 * j,
                                                         (int)m0);
      hopper::bulk_commit();
    }
  }

  // the CTA's partial row: over the 8 row groups g of each warp (lanes t, t +
  // 4, ..., t + 28) by shuffles, then over its 8 warps in order
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sum[j][i] += __shfl_xor_sync(0xffffffffu, sum[j][i], off);
        sq[j][i] += __shfl_xor_sync(0xffffffffu, sq[j][i], off);
      }
    }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 64 * j + 8 * (i >> 1) + 2 * t + (i & 1);
        red[warp * kBN + col] = sum[j][i];
        red[(kConsumers * 4 + warp) * kBN + col] = sq[j][i];
      }
  }
  hopper::named_barrier_sync(3, kConsumerThreads);
  if (tid < kBN && n0 + tid < N) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumers * 4; ++w) v += red[(r * kConsumers * 4 + w) * kBN + tid];
      s.part[((int64_t)blockIdx.x * 2 + r) * N + n0 + tid] = v;
    }
  }
  if (lead) hopper::bulk_wait<0>();  // the last y stores are done before the CTA exits
}

// Grid (slots, n_tiles), kThreads threads, p.smem_bytes of dynamic shared
// memory. tx, tw, ty: x [M, K], W [K, N] and y [M, N] as 2-d tensor maps
// with 128-byte swizzle, in boxes of (64, 128), (64, 64) and (64, 64). part:
// [slots, 2N] fp32, CTA (slot, n-tile) writing row slot's columns of its
// N-tile (sums at n, sums of squares at N + n).
template <bool kBnIn, bool kRelu>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_bn_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap ty, const float* __restrict__ scale,
                  const float* __restrict__ shift, float* __restrict__ part, int64_t M, int K,
                  int N, const Plan p) {
  extern __shared__ unsigned char k2_smem_raw[];
  uint8_t* const smem = hopper::align_smem<uint8_t, 1024>(k2_smem_raw);
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages], w_full;
  uint8_t* const wres = smem;
  uint8_t* const ring = smem + p.w_bytes;
  uint8_t* const ystage = ring + p.stages * p.stage_bytes;
  float* const sc = reinterpret_cast<float*>(ystage + kYBytes);
  float* const sh = sc + p.k_chunks * kBK;
  float* const red = reinterpret_cast<float*>(ystage + kYBytes + p.ss_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * kBN;
  const int nblk = min(kBlocks, (N - n0 + 63) / 64);  // 64-column blocks holding columns < N
  const int stages = p.stages, chunks = p.k_chunks;
  const int64_t step = gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);  // one thread a warpgroup
    }
    hopper::mbar_init(&w_full, 1);
    hopper::fence_barrier_init();
  }
  if (kBnIn) {
    // the prologue's scale and shift, zero past K (TMA's zeros there stay 0)
    for (int i = tid; i < chunks * kBK; i += kThreads) {
      sc[i] = i < K ? scale[i] : 0.f;
      sh[i] = i < K ? shift[i] : 0.f;
    }
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    // producer: one thread issues every load of the CTA; gc counts its
    // chunks (ring stage gc % stages)
    if (warp == kConsumers * 4 && lane == 0) {
      if (p.resident) {
        hopper::mbar_arrive_expect_tx(&w_full, chunks * nblk * kBoxBytes);
        for (int c = 0; c < chunks; ++c) {
          for (int j = 0; j < nblk; ++j) {
            hopper::tma_load_2d(wres + c * kWChunkBytes + j * kBoxBytes, &tw, &w_full,
                                n0 + 64 * j, c * kBK);
          }
        }
      }
      int gc = 0;
      for (int64_t mt = blockIdx.x; mt < p.m_tiles; mt += step) {
        for (int c = 0; c < chunks; ++c, ++gc) {
          const int st = gc % stages;
          // stage st last held chunk gc - stages: wait for both warpgroups to
          // release it (that release completed phase gc / stages - 1)
          if (gc >= stages) hopper::mbar_wait(&empty[st], ((gc / stages) + 1) & 1);
          uint8_t* buf = ring + st * p.stage_bytes;
          hopper::mbar_arrive_expect_tx(&full[st],
                                        kChunkBytes + (p.resident ? 0 : nblk * kBoxBytes));
          hopper::tma_load_2d(buf, &tx, &full[st], c * kBK, (int)(mt * kBM));
          if (!p.resident) {
            for (int j = 0; j < nblk; ++j) {
              hopper::tma_load_2d(buf + kChunkBytes + j * kBoxBytes, &tw, &full[st],
                                  n0 + 64 * j, c * kBK);
            }
          }
        }
      }
    }
    return;
  }

  // consumers: one instantiation for each width of the N-tile, so that
  // every product of the loop has one shape and no branch falls between
  // two of them
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const Consumer s{ring, wres, ystage, sc, sh, red, full, empty, &w_full, &ty, part,
                   M, N, n0, tid, step};
  if (nblk == kBlocks) {
    consume<kBnIn, kRelu, kBlocks>(s, p);
  } else {
    consume<kBnIn, kRelu, 1>(s, p);
  }
}

template <bool kBnIn, bool kRelu>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty,
           const float* scale, const float* shift, float* part, int64_t M, int K, int N,
           const Plan& p, cudaStream_t stream) {
  static unsigned long long configured = 0;
  const int e = hopper::allow_smem(conv1x1_bn_kernel<kBnIn, kRelu>, kSmemMax, configured);
  if (e != 0) return e;
  const dim3 grid((unsigned)p.slots, (unsigned)p.n_tiles);
  conv1x1_bn_kernel<kBnIn, kRelu><<<grid, kThreads, p.smem_bytes, stream>>>(
      tx, tw, ty, scale, shift, part, M, K, N, p);
  return (int)cudaGetLastError();
}

// a [rows, cols] bf16 row-major tensor as a 2-d tensor map with 128-byte
// swizzle, in boxes of 64 columns x box_rows rows
int encode_rows(CUtensorMap* map, const void* base, int64_t rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return hopper::encode<2>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

extern "C" {

// What a call passes besides its tensors and stream, described once per
// shape by ops/conv1x1_bn.py `_launch_args` (its `_Launch` mirrors this
// layout field by field and is checked against conv1x1_bn_launch_bytes at
// load).
struct Launch {
  long long M;  // > 0
  int K;        // a multiple of 8
  int N;        // a multiple of 8
  int bn_in;    // 1: the prologue (scale and shift given)
  int relu;     // with the prologue: relu after it
  int device;   // the tensors' device, made current for the launches
  Plan plan;
};

size_t conv1x1_bn_launch_bytes() { return sizeof(Launch); }

// y [M, N] bf16 and stats [2, N] fp32 (column sums, then sums of squares) of
// maybe_relu(x * scale + shift) @ w, the prologue when l->bn_in. x [M, K], w
// [K, N] bf16 row-major, scale and shift fp32 [K]; pointers 16-byte
// aligned. part: [plan.slots, 2N] fp32 scratch. Returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a plan that does not hold the shape).
int conv1x1_bn_stats(const void* x, const void* w, const float* scale, const float* shift,
                     void* y, float* part, float* stats, const Launch* l, void* stream) {
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  const Plan& p = l->plan;
  const int64_t M = l->M;
  const int K = l->K, N = l->N;
  if (!plan_holds(p, M, K, N, l->bn_in != 0) || (l->bn_in && (scale == nullptr ||
                                                              shift == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tx, tw, ty;
  int e = encode_rows(&tx, x, M, K, kBM);
  if (e == 0) e = encode_rows(&tw, w, K, N, 64);
  if (e == 0) e = encode_rows(&ty, y, M, N, 64);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!l->bn_in) {
    e = launch<false, false>(tx, tw, ty, scale, shift, part, M, K, N, p, s);
  } else if (l->relu) {
    e = launch<true, true>(tx, tw, ty, scale, shift, part, M, K, N, p, s);
  } else {
    e = launch<true, false>(tx, tw, ty, scale, shift, part, M, K, N, p, s);
  }
  if (e != 0) return e;
  vec::sum_partials(part, stats, vec::kFloat32, p.slots, 2 * (int64_t)N, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
