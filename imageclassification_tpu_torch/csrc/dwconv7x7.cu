// 7x7 depthwise convolution, NHWC, stride 1, zero padding 3, for sm_90a:
// the forward (also the input gradient) and the weight gradient.
//
// Replaces `depthwise_conv7x7` of imageclassification_tpu/ops/pallas_dwconv.py:
// the Pallas TPU kernel `_kernel` (:43) behind `_dwconv_pallas` (pallas_call
// at :58), which runs the forward on a `jnp.pad`-ed input (:95) and the input
// gradient on the padded output gradient with the spatially flipped kernel
// (:107-109); and the weight gradient, 49 shifted reductions that the JAX
// package leaves to XLA (:111-120).
//
//   out[b, h, w, c] = sum_{ky, kx} x[b, h + ky - 3, w + kx - 3, c] * k[ky, kx, c]
//   dx  = the same on dy with k[6 - ky, 6 - kx, c] (flip = 1)
//   dw[ky, kx, c] = sum_{b, h, w} x[b, h + ky - 3, w + kx - 3, c] * dy[b, h, w, c]
// with x outside the image read as 0, fp32 accumulation, the output in x's
// dtype (dw in w's dtype).
//
// What bounds it on an H100. The forward and dx, 2 * 49 flops per output
// element against 2 bytes read and 2 written per bf16 element: for bf16 the
// bytes. Both have a tensor-core form (per channel, each output row is a
// banded Toeplitz product of an input row with a kernel row, of which 22 %
// of the products are useful), so at the bf16 tensor-core rate the flops
// take a fraction of the bytes' time. On the fp32 CUDA cores, where this
// kernel runs them (the Toeplitz form needs a channel-major tile), the flops
// at 67 TFLOP/s take about 1.2x as long as the bytes at 3.35 TB/s, so it
// cannot reach the bytes bound. fp32 x has twice the bytes, which bind
// there too. dw too: per channel it is a 7 x 7
// product with depth B*H*W, A[kx, (b, h', w)] = x[b, h', w + kx],
// B[(b, h', w), ky] = dy[b, h' - ky, w], so at the bf16 tensor-core rate its
// bound is the bytes (x and dy read once). That product is too narrow
// (7 x 7) to fill an m64 tensor-core tile without building shifted copies in
// shared memory; this kernel runs it on the CUDA cores, so it cannot reach
// that bound. So both designs aim at the share of issued instructions that
// are FMAs: the inputs come from shared memory, filled by TMA, each value
// converted to fp32 once for the FMAs it feeds in a thread, and no
// instruction is spent on addresses in the inner loops. The tiles are
// addressed from the dynamic shared array by pointer arithmetic
// (hopper::align_smem), so the loads are LDS, not generic loads.
//
// The forward (`dwconv7x7_fwd_kernel`). Persistent CTAs (P slots x channel
// tiles of 32, up to 8 an SM) walk over work items of (batch, band of `rows`
// output rows, segment of `seg` = 7 or 14 columns); ops/dwconv.py
// `fwd_plan` picks them (and the slots, stages and shared-memory layout,
// which the launch checks). A CTA converts its tile's 49 x 32 weights to
// fp32 once (flipped for dx) into shared memory, while thread 0 starts a
// ring of 2 to 4 stages: each item's input band with its 3-pixel halo,
// (rows + 6) x (seg + 6) pixels x 32 channels, is one TMA load that
// zero-fills the borders and the channels past C. A thread owns 4 channels
// of one output row of the band: its seg x 4 fp32 accumulators stay in
// registers, and for each kernel row ky it slides along input row r + ky,
// loading each of the seg + 6 pixels once (one 8-byte load of four bf16,
// four ALU ops to fp32) for up to 7 x 4 FMAs with the 7 x 4 weights of that
// row in registers: 392 FMAs for 20 loads at seg = 14, all at constant
// offsets (the row loop is unrolled; 79 % of the loop's instructions are
// FMAs). 8 threads cover a pixel's 32 channels, so a quarter-warp reads 64
// contiguous bytes and the odd pixel pitch of a tile row puts two rows in
// different banks. The outputs go out as 8- (bf16) or 16-byte stores.
// Measured on the H100 (PERF.md §7), the loop issues an FMA in about half
// its cycles: neither the shared loads nor the conversions nor occupancy
// set that, so it sits at about 40 % of the fp32 rate.
//
// The weight gradient is a reduction over every pixel of the batch. Its
// design (`dwconv7x7_dw_kernel`) keeps the x values a thread multiplies in
// registers, so that shared memory is read twice per 28 FMAs, not once per
// 8: a warp owns one kernel row ky, and each of its threads owns 4 channels
// and one dy row of a band of 8 rows, with 7 (kx) x 4 fp32 accumulators. The
// thread slides along its row: the last 7 x values of input row h + ky - 3
// stay in a register window, so each new pixel costs one x load and one dy
// load (converted to fp32 once) for 28 FMAs. A work item is (batch, band of
// 8 rows, segment of up to 28 columns, 16 channels): its only halo is 3 rows
// above and below and 3 columns at each side, and a 7-, 14-, 28- or 56-wide
// row (two segments) has no padding. 4 channels a thread (not 8) keep a thread within the
// registers that three CTAs of 7 warps an SM leave it, so 21 warps hide the
// shared-memory latency. CTAs (P slots x channel tiles) walk over the items
// through a ring of up to 4 shared-memory stages (as many as fit beside the
// other CTAs; segments of at most 28 columns keep two or more at every
// ConvNeXt-T stage): one thread keeps the next items loading with TMA while
// all compute one. The tensor maps describe x and dy as [B, H, W, C]; a box
// of 16 channels x a tile row x the tile's rows lands as [row][pixel][16
// channels] with odd rows (so the rows that one load instruction of a warp
// reads fall in different banks), and TMA zero-fills the borders, so the
// threads spend no instructions on the copies. At the end the 8
// rows' sums are added by warp shuffles, each CTA writes one fp32 partial row
// of [49 * C], and vec::sum_partials adds the P rows in a fixed order. No
// atomics: the same result on every run.
//
// The launches take their scalars as one struct (FwdLaunch, DwLaunch),
// described once per shape by ops/dwconv.py and checked against
// dwconv7x7_*_launch_bytes when the library loads, and make the tensors'
// device current themselves.

#include "hopper_common.cuh"
#include "vec_common.cuh"

namespace {

using vec::bf16;

constexpr int kK = 7, kPad = 3, kTaps = kK * kK;

// ---- the forward (and dx) ----------------------------------------------------

constexpr int kFwdCT = 32;                  // channels a CTA: a TMA box's inner dimension
constexpr int kFwdCV = 4;                   // channels a thread: one 8-byte load of bf16
constexpr int kFwdLanes = kFwdCT / kFwdCV;  // threads an output row: 8
constexpr int kFwdMaxRows = 16;             // output rows a band
constexpr int kFwdMaxThreads = kFwdLanes * kFwdMaxRows;
constexpr int kFwdMaxStages = 4;
// the dynamic shared memory a forward CTA may ask for: 227 KB, less its
// static part (the tile's fp32 weights and the barriers) rounded up
constexpr int kFwdSmemMax = 232448 - 8192;

// The forward's work split and shared-memory layout, computed on the host by
// ops/dwconv.py `fwd_plan` (its `FwdPlan`, field by field) and checked by
// `fwd_plan_holds` before a launch. Item i of the `items` is (batch
// i / (bands * segs), band (i / segs) % bands, segment i % segs); CTA (slot,
// tile) computes the items slot, slot + slots, ... of channel tile `tile`.
struct FwdPlan {
  int rows;         // output rows a band, 1 to 16: one an 8-thread group
  int seg;          // output columns a segment: 7 or 14
  int bands;        // ceil(H / rows)
  int segs;         // ceil(W / seg)
  int tiles;        // channel tiles of 32: the grid's y
  int items;        // B * bands * segs
  int slots;        // CTAs a channel tile: the grid's x
  int stages;       // ring stages, 2 to 4
  int row_px;       // pixels a row of a stage's tile: odd, >= seg + 6
  int stage_bytes;  // (rows + 6) x row_px pixels of 32 channels, rounded to 128
  int smem_bytes;   // dynamic shared memory: stages x stage_bytes + 128
  int threads;      // 32 x ceil(rows / 4)
};

template <typename T>
bool fwd_plan_holds(const FwdPlan& p, int B, int H, int W, int C) {
  const int64_t tile = (int64_t)(p.rows + 2 * kPad) * p.row_px * kFwdCT * sizeof(T);
  return p.rows >= 1 && p.rows <= kFwdMaxRows && (p.seg == 7 || p.seg == 14) &&
         p.bands == (H + p.rows - 1) / p.rows && p.segs == (W + p.seg - 1) / p.seg &&
         p.tiles == (C + kFwdCT - 1) / kFwdCT && (int64_t)B * p.bands * p.segs == p.items &&
         p.slots >= 1 && p.slots <= p.items && p.stages >= 2 && p.stages <= kFwdMaxStages &&
         p.row_px % 2 == 1 && p.row_px >= p.seg + 2 * kPad && p.row_px <= 256 &&
         p.stage_bytes % 128 == 0 && p.stage_bytes >= tile &&
         p.smem_bytes >= (int64_t)p.stages * p.stage_bytes + 128 &&
         p.smem_bytes <= kFwdSmemMax && p.threads == 32 * ((p.rows + 3) / 4);
}

// 4 channels from shared memory in fp32: for bf16, each 32-bit word of two
// values becomes two floats by one shift and one mask (a bf16 is the high
// half of the float it stands for)
__device__ __forceinline__ void load4(float (&out)[4], const float* p) {
  vec::load<float, 4>(out, p);
}
__device__ __forceinline__ void load4(float (&out)[4], const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(raw.x << 16);
  out[1] = __uint_as_float(raw.x & 0xffff0000u);
  out[2] = __uint_as_float(raw.y << 16);
  out[3] = __uint_as_float(raw.y & 0xffff0000u);
}

__device__ __forceinline__ float weight(const void* w, int w_dtype, int64_t i) {
  return w_dtype == vec::kBFloat16 ? __bfloat162float(static_cast<const bf16*>(w)[i])
                                   : static_cast<const float*>(w)[i];
}

// Issue the TMA load of item `item` into stage buffer `buf`, completing on
// `bar`: input rows [h0 - 3, h0 + rows + 3) x columns [w0 - 3, w0 - 3 +
// row_px) x channels [c0, c0 + 32), laid out [row][pixel][channel]; pixels
// outside the image and channels >= C land as zeros.
template <typename T>
__device__ __forceinline__ void issue_fwd_item(T* buf, uint64_t* bar, const CUtensorMap* tx,
                                               int64_t item, const FwdPlan& p, int c0) {
  const int b = (int)(item / (p.bands * p.segs));
  const int rem = (int)(item % (p.bands * p.segs));
  const int h0 = (rem / p.segs) * p.rows, w0 = (rem % p.segs) * p.seg;
  hopper::mbar_arrive_expect_tx(
      bar, (uint32_t)((p.rows + 2 * kPad) * p.row_px * kFwdCT * sizeof(T)));
  hopper::tma_load_4d(buf, tx, bar, c0, w0 - kPad, h0 - kPad, b);
}

// Grid (slots, tiles), p.threads threads, p.smem_bytes of dynamic shared
// memory. Thread (r, g) = (threadIdx.x / 8, threadIdx.x % 8) computes
// output row h0 + r of each item, channels c0 + 4g .. c0 + 4g + 3, over
// the kSeg columns w0 .. w0 + kSeg - 1 (those >= W are computed from zeros
// and not stored). tx: x as [B, H, W, C] in boxes of (32, row_px, rows + 6,
// 1). w: [7, 7, C] in w_dtype.
template <typename T, int kSeg>
__global__ void __launch_bounds__(kFwdMaxThreads, 4)
dwconv7x7_fwd_kernel(const __grid_constant__ CUtensorMap tx, const void* __restrict__ w,
                     T* __restrict__ out, int H, int W, int C, int w_dtype, int flip,
                     const FwdPlan p) {
  extern __shared__ unsigned char fwd_smem_raw[];
  T* const smem = hopper::align_smem<T, 128>(fwd_smem_raw);
  __shared__ __align__(16) float sw[kTaps * kFwdCT];
  __shared__ uint64_t full[kFwdMaxStages];
  const int64_t step = gridDim.x;
  const int stages = p.stages;
  const int stage = p.stage_bytes / (int)sizeof(T);
  const int c0 = blockIdx.y * kFwdCT;
  const int g = threadIdx.x % kFwdLanes, r = threadIdx.x / kFwdLanes;
  const int c = c0 + kFwdCV * g;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // items slot, slot + P, ... go to stages 0, 1, ... in turn: item k of this
  // CTA is the (k / stages)-th load into stage k % stages
  int64_t item = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages - 1; ++s) {
      if (item + s * step < p.items) {
        issue_fwd_item<T>(smem + s * stage, &full[s], &tx, item + s * step, p, c0);
      }
    }
  }
  // the tile's weights in fp32 while the first loads land; flip: tap (ky,
  // kx) reads k[6 - ky, 6 - kx], whose index is 48 - tap
  for (int i = threadIdx.x; i < kTaps * kFwdCT; i += blockDim.x) {
    const int tap = i / kFwdCT, ci = c0 + i % kFwdCT;
    sw[i] = ci < C ? weight(w, w_dtype, (int64_t)(flip ? kTaps - 1 - tap : tap) * C + ci) : 0.f;
  }
  __syncthreads();

  for (int k = 0; item < p.items; item += step, ++k) {
    const int st = k % stages;
    if (threadIdx.x == 0) {
      // stage (k - 1) % stages was last read in iteration k - 1, which ended
      // in a barrier; order those reads before the TMA writes
      const int64_t ahead = item + (int64_t)(stages - 1) * step;
      if (ahead < p.items) {
        const int sa = (k + stages - 1) % stages;
        hopper::fence_proxy_async();
        issue_fwd_item<T>(smem + sa * stage, &full[sa], &tx, ahead, p, c0);
      }
    }
    hopper::mbar_wait(&full[st], (k / stages) & 1);

    if (r < p.rows) {
      const int b = (int)(item / (p.bands * p.segs));
      const int rem = (int)(item % (p.bands * p.segs));
      const int h0 = (rem / p.segs) * p.rows, w0 = (rem % p.segs) * p.seg;
      float acc[kSeg][kFwdCV];
#pragma unroll
      for (int o = 0; o < kSeg; ++o)
#pragma unroll
        for (int j = 0; j < kFwdCV; ++j) acc[o][j] = 0.f;
      // tile row r + ky is image row h0 + r + ky - 3; output column o reads
      // tile columns o .. o + 6, so tile column q feeds outputs q - 6 .. q
      const T* tile = smem + st * stage + kFwdCV * g;
#pragma unroll 1
      for (int ky = 0; ky < kK; ++ky) {
        float wk[kK][kFwdCV];
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          vec::load<float, kFwdCV>(wk[kx], sw + (ky * kK + kx) * kFwdCT + kFwdCV * g);
        }
        const T* row = tile + (r + ky) * p.row_px * kFwdCT;
#pragma unroll
        for (int q = 0; q < kSeg + kK - 1; ++q) {
          float xv[kFwdCV];
          load4(xv, row + q * kFwdCT);
#pragma unroll
          for (int kx = 0; kx < kK; ++kx) {
            const int o = q - kx;
            if (o >= 0 && o < kSeg) {
#pragma unroll
              for (int j = 0; j < kFwdCV; ++j) acc[o][j] = fmaf(xv[j], wk[kx][j], acc[o][j]);
            }
          }
        }
      }
      const int oy = h0 + r;
      if (oy < H && c < C) {
        T* dst = out + (((int64_t)b * H + oy) * W + w0) * C + c;
#pragma unroll
        for (int o = 0; o < kSeg; ++o) {
          if (w0 + o < W) vec::store<T, kFwdCV>(dst + (int64_t)o * C, acc[o]);
        }
      }
    }
    __syncthreads();  // every read of stage st is done before it is refilled
  }
}

// ---- the weight gradient ------------------------------------------------------

// The weight gradient's work split (ops/dwconv.py `dw_plan` chooses `seg`
// and the slots, mirroring these constants): bands of kDwRows dy rows, segments of `seg` columns (a
// multiple of 7), tiles of kDwCT channels; item i of the B * bands * segs
// items is (batch i / (bands * segs), band (i / segs) % bands, segment
// i % segs).
constexpr int kDwRows = 8;                    // dy rows of a band: one per lane / 4
constexpr int kDwCV = 4;                      // channels per thread (load4)
constexpr int kDwCT = 4 * kDwCV;              // channels per CTA: lane % 4 picks 4
constexpr int kDwThreads = kK * 32;           // one warp per kernel row ky
constexpr int kDwRowsX = kDwRows + 2 * kPad;  // x rows of a band with the halo

// The shared-memory layout of a stage, taken from the host's `DwPlan`
// (ops/dwconv.py `dw_plan`, its one owner; checked by `dw_plan_holds`): the
// x tile's rows of row_x >= seg + 6 pixels, then the dy tile's rows of
// row_dy >= seg pixels, at x_elems elements from the stage's start; a stage
// of stage_elems elements. row_x and row_dy are odd, so that the rows that
// one load instruction of a warp reads fall in different banks, and each
// tile starts 128-byte aligned, as TMA writes.
struct DwLayout {
  int seg, row_x, row_dy, x_elems, stage_elems;
};

// Issue the TMA loads of item `item` into stage buffer `buf`, completing on
// `bar`: x rows [h0 - 3, h0 + 11) x columns [w0 - 3, w0 - 3 + row_x) and dy
// rows [h0, h0 + 8) x columns [w0, w0 + row_dy) of channels [c0, c0 + 16),
// laid out [row][column][channel]; pixels outside the tensor and channels
// >= C land as zeros. The boxes are wider than the item needs where the
// layout's rows are; compute never reads the extra columns.
template <typename T>
__device__ __forceinline__ void issue_dw_item(T* buf, uint64_t* bar, const CUtensorMap* tx,
                                              const CUtensorMap* tdy, int64_t item, int bands,
                                              int segs, const DwLayout& lay, int c0) {
  const int b = (int)(item / (bands * segs));
  const int rem = (int)(item % (bands * segs));
  const int h0 = (rem / segs) * kDwRows, w0 = (rem % segs) * lay.seg;
  const uint32_t bytes = (kDwRowsX * lay.row_x + kDwRows * lay.row_dy) * kDwCT * sizeof(T);
  hopper::mbar_arrive_expect_tx(bar, bytes);
  hopper::tma_load_4d(buf, tx, bar, c0, w0 - kPad, h0 - kPad, b);
  hopper::tma_load_4d(buf + lay.x_elems, tdy, bar, c0, w0, h0, b);
}

// Grid (P, C / 16 rounded up), kDwThreads threads, kStages stages of
// lay.stage_elems elements of dynamic shared memory (+128 bytes of
// alignment slack). CTA (slot, channel tile) sums the items slot, slot + P,
// ...; thread 0 keeps the next kStages - 1 items loading (TMA, through tx
// and tdy: tensor maps of x and dy as [B, H, W, C] with boxes of
// (16, lay.row_x, 14, 1) and (16, lay.row_dy, 8, 1)) while all
// compute one. Warp ky, lane = 4 r + g: dy row r of the band, channels
// c0 + 4g .. c0 + 4g + 3. part: [P, 49 * C].
template <typename T, int kStages>
__global__ void __launch_bounds__(kDwThreads, 3)
dwconv7x7_dw_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                    float* __restrict__ part, int B, int H, int W, int C, const DwLayout lay) {
  extern __shared__ unsigned char dw_smem_raw[];
  T* const smem = hopper::align_smem<T, 128>(dw_smem_raw);
  __shared__ uint64_t full[kStages];
  const int bands = (H + kDwRows - 1) / kDwRows;
  const int segs = (W + lay.seg - 1) / lay.seg;
  const int64_t items = (int64_t)B * bands * segs;
  const int64_t step = gridDim.x;
  const int stage = lay.stage_elems;
  const int c0 = blockIdx.y * kDwCT;
  const int ky = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane & 3, r = lane >> 2;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  float acc[kK][kDwCV];
#pragma unroll
  for (int kx = 0; kx < kK; ++kx)
#pragma unroll
    for (int j = 0; j < kDwCV; ++j) acc[kx][j] = 0.f;

  // items slot, slot + P, ... go to stages 0, 1, ... in turn: item k of this
  // CTA is the (k / kStages)-th load into stage k % kStages
  int64_t item = blockIdx.x;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < (kStages > 1 ? kStages - 1 : 1); ++s) {
      if (item + s * step < items) {
        issue_dw_item<T>(smem + s * stage, &full[s], &tx, &tdy, item + s * step, bands, segs,
                         lay, c0);
      }
    }
  }
  for (int k = 0; item < items; item += step, ++k) {
    const int st = k % kStages;
    if (kStages > 1 && threadIdx.x == 0) {
      // stage (k - 1) % kStages was last read in iteration k - 1, which
      // ended in a barrier; order those reads before the TMA writes
      const int64_t ahead = item + (kStages - 1) * step;
      if (ahead < items) {
        const int sa = (k + kStages - 1) % kStages;
        hopper::fence_proxy_async();
        issue_dw_item<T>(smem + sa * stage, &full[sa], &tx, &tdy, ahead, bands, segs, lay, c0);
      }
    }
    hopper::mbar_wait(&full[st], (k / kStages) & 1);

    // x row r + ky of the tile is image row h0 + r + ky - 3; dy pixel w needs
    // x tile columns w .. w + 6, and tile column q sits in window slot q % 7
    const T* cur = smem + st * stage;
    const T* xr = cur + (r + ky) * lay.row_x * kDwCT + g * kDwCV;
    const T* dr = cur + lay.x_elems + r * lay.row_dy * kDwCT + g * kDwCV;
    float win[kK][kDwCV];
#pragma unroll
    for (int q = 0; q < kK - 1; ++q) load4(win[q], xr + q * kDwCT);
#pragma unroll 1
    for (int w = 0; w < lay.seg; w += kK) {
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        load4(win[(i + kK - 1) % kK], xr + (w + i + kK - 1) * kDwCT);
        float d[kDwCV];
        load4(d, dr + (w + i) * kDwCT);
#pragma unroll
        for (int kx = 0; kx < kK; ++kx)
#pragma unroll
          for (int j = 0; j < kDwCV; ++j) {
            acc[kx][j] = fmaf(win[(i + kx) % kK][j], d[j], acc[kx][j]);
          }
      }
    }
    __syncthreads();  // every read of stage st is done before it is refilled
    if (kStages == 1 && threadIdx.x == 0 && item + step < items) {
      hopper::fence_proxy_async();
      issue_dw_item<T>(smem, &full[0], &tx, &tdy, item + step, bands, segs, lay, c0);
    }
  }

  // the 8 dy rows of a warp (lane bits 2..4) hold partial sums of the same
  // taps and channels: add them in a fixed order
#pragma unroll
  for (int kx = 0; kx < kK; ++kx)
#pragma unroll
    for (int j = 0; j < kDwCV; ++j) {
      float v = acc[kx][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[kx][j] = v;
    }
  const int c = c0 + g * kDwCV;
  if (r != 0 || c >= C) return;
#pragma unroll
  for (int kx = 0; kx < kK; ++kx) {
    vec::store<float, kDwCV>(part + ((int64_t)blockIdx.x * kTaps + ky * kK + kx) * C + c,
                             acc[kx]);
  }
}

// ---- launches ------------------------------------------------------------------

template <typename T, int kSeg>
int launch_fwd_seg(const CUtensorMap& tx, const void* w, void* out, int H, int W, int C,
                   int w_dtype, int flip, const FwdPlan& p, cudaStream_t stream) {
  static unsigned long long configured = 0;
  const int e = hopper::allow_smem(dwconv7x7_fwd_kernel<T, kSeg>, kFwdSmemMax, configured);
  if (e != 0) return e;
  const dim3 grid((unsigned)p.slots, (unsigned)p.tiles);
  dwconv7x7_fwd_kernel<T, kSeg><<<grid, p.threads, p.smem_bytes, stream>>>(
      tx, w, static_cast<T*>(out), H, W, C, w_dtype, flip, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* out, int B, int H, int W, int C, int w_dtype,
               int flip, const FwdPlan& p, cudaStream_t stream) {
  if (!fwd_plan_holds<T>(p, B, H, W, C)) return (int)cudaErrorInvalidValue;
  // x as a [B, H, W, C] tensor map (dims innermost first), read in boxes of
  // 32 channels x a tile row x the tile's rows
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)W * C * sizeof(T),
                                 (cuuint64_t)H * W * C * sizeof(T)};
  const cuuint32_t box[4] = {kFwdCT, (cuuint32_t)p.row_px, (cuuint32_t)(p.rows + 2 * kPad), 1};
  CUtensorMap tx;
  const int e = hopper::encode<4>(&tx, type, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  switch (p.seg) {
    case 7: return launch_fwd_seg<T, 7>(tx, w, out, H, W, C, w_dtype, flip, p, stream);
    default: return launch_fwd_seg<T, 14>(tx, w, out, H, W, C, w_dtype, flip, p, stream);
  }
}

// the dynamic shared memory the dw kernel may take: 227 KB a CTA, less its
// static barriers
constexpr int kDwSmemMax = 232448 - 1024;

// The weight gradient's work split and shared-memory layout, computed on the
// host by ops/dwconv.py `dw_plan` (its `DwPlan`, field by field) and checked
// by `dw_plan_holds` before a launch.
struct DwPlan {
  int seg;          // columns a segment, a multiple of 7
  int segs;         // ceil(W / seg)
  int bands;        // ceil(H / 8)
  int tiles;        // channel tiles of 16: the grid's y
  int items;        // B * bands * segs
  int slots;        // CTAs a channel tile (the grid's x), one partial row each
  int stages;       // ring stages, 1 to 4
  int row_x;        // pixels a row of the x tile: odd, >= seg + 6
  int row_dy;       // pixels a row of the dy tile: odd, >= seg
  int x_bytes;      // the x tile of a stage, rounded to 128; the dy tile follows
  int stage_bytes;
  int smem_bytes;   // dynamic shared memory: stages x stage_bytes + 128
};

// the host's layout must hold the tiles the boxes write, 128-byte aligned,
// in the shared memory the launch asks for
template <typename T>
bool dw_plan_holds(const DwPlan& p, int B, int H, int W, int C) {
  const int64_t tile_x = (int64_t)kDwRowsX * p.row_x * kDwCT * sizeof(T);
  const int64_t tile_dy = (int64_t)kDwRows * p.row_dy * kDwCT * sizeof(T);
  return p.seg > 0 && p.seg % kK == 0 && p.segs == (W + p.seg - 1) / p.seg &&
         p.bands == (H + kDwRows - 1) / kDwRows && p.tiles == (C + kDwCT - 1) / kDwCT &&
         (int64_t)B * p.bands * p.segs == p.items && p.slots >= 1 && p.slots <= p.items &&
         p.stages >= 1 && p.stages <= 4 && p.row_x >= p.seg + 2 * kPad &&
         p.row_dy >= p.seg && p.row_x <= 256 && p.row_dy <= 256 && p.x_bytes % 128 == 0 &&
         p.stage_bytes % 128 == 0 && p.x_bytes >= tile_x &&
         p.stage_bytes - p.x_bytes >= tile_dy &&
         p.smem_bytes >= (int64_t)p.stages * p.stage_bytes + 128 && p.smem_bytes <= kDwSmemMax;
}

template <typename T, int kStages>
int launch_dw_stages(const CUtensorMap& tx, const CUtensorMap& tdy, float* part, int B, int H,
                     int W, int C, const DwLayout& lay, const DwPlan& p, cudaStream_t stream) {
  static unsigned long long configured = 0;
  const int e = hopper::allow_smem(dwconv7x7_dw_kernel<T, kStages>, kDwSmemMax, configured);
  if (e != 0) return e;
  const dim3 grid((unsigned)p.slots, (unsigned)p.tiles);
  dwconv7x7_dw_kernel<T, kStages><<<grid, kDwThreads, p.smem_bytes, stream>>>(
      tx, tdy, part, B, H, W, C, lay);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, float* part, void* dw, int B, int H, int W, int C,
              int w_dtype, const DwPlan& p, cudaStream_t stream) {
  if (!dw_plan_holds<T>(p, B, H, W, C)) return (int)cudaErrorInvalidValue;
  const DwLayout lay{p.seg, p.row_x, p.row_dy, p.x_bytes / (int)sizeof(T),
                     p.stage_bytes / (int)sizeof(T)};
  // x and dy as [B, H, W, C] tensor maps (dims innermost first), read in
  // boxes of 16 channels x a tile row x the tile's rows
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)W * C * sizeof(T),
                                 (cuuint64_t)H * W * C * sizeof(T)};
  const cuuint32_t box_x[4] = {kDwCT, (cuuint32_t)p.row_x, kDwRowsX, 1};
  const cuuint32_t box_dy[4] = {kDwCT, (cuuint32_t)p.row_dy, kDwRows, 1};
  CUtensorMap tx, tdy;
  int e = hopper::encode<4>(&tx, type, x, dims, strides, box_x, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0) e = hopper::encode<4>(&tdy, type, dy, dims, strides, box_dy, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  switch (p.stages) {
    case 1: e = launch_dw_stages<T, 1>(tx, tdy, part, B, H, W, C, lay, p, stream); break;
    case 2: e = launch_dw_stages<T, 2>(tx, tdy, part, B, H, W, C, lay, p, stream); break;
    case 3: e = launch_dw_stages<T, 3>(tx, tdy, part, B, H, W, C, lay, p, stream); break;
    default: e = launch_dw_stages<T, 4>(tx, tdy, part, B, H, W, C, lay, p, stream); break;
  }
  if (e != 0) return e;
  vec::sum_partials(part, dw, w_dtype, p.slots, (int64_t)kTaps * C, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// What a forward call passes besides its tensors and stream, described once
// per shape by ops/dwconv.py `_fwd_launch` (its `_FwdLaunch` mirrors this
// layout field by field and is checked against dwconv7x7_fwd_launch_bytes at
// load).
struct FwdLaunch {
  int B;
  int H;
  int W;
  int C;
  int flip;     // 1: k flipped in both spatial axes (the input gradient)
  int x_dtype;  // x and out: 0 fp32, 1 bf16
  int w_dtype;  // k: 0 fp32, 1 bf16
  int device;   // the tensors' device, made current for the launch
  FwdPlan plan;
};

// The same for the weight gradient (ops/dwconv.py `_dw_launch`, `_DwLaunch`).
struct DwLaunch {
  int B;
  int H;
  int W;
  int C;
  int x_dtype;  // x and dy: 0 fp32, 1 bf16
  int w_dtype;  // dw: 0 fp32, 1 bf16
  int device;
  DwPlan plan;
};

size_t dwconv7x7_fwd_launch_bytes() { return sizeof(FwdLaunch); }
size_t dwconv7x7_dw_launch_bytes() { return sizeof(DwLaunch); }

// out = depthwise 7x7 conv of x with k (l->flip = 1: with k flipped in both
// spatial axes, which gives the input gradient when x is the output
// gradient). x, out: [B, H, W, C] contiguous, B * H * W > 0; k: [7, 7, C]
// contiguous; C a multiple of 8. Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for a plan that does not hold the shape).
int dwconv7x7_fwd(const void* x, const void* k, void* out, const FwdLaunch* l, void* stream) {
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l->x_dtype == vec::kBFloat16
      ? launch_fwd<bf16>(x, k, out, l->B, l->H, l->W, l->C, l->w_dtype, l->flip, l->plan, s)
      : launch_fwd<float>(x, k, out, l->B, l->H, l->W, l->C, l->w_dtype, l->flip, l->plan, s);
}

// dw [7, 7, C] (l->w_dtype) = the weight gradient for input x and output
// gradient dy ([B, H, W, C] contiguous, l->x_dtype), by the plan of
// ops/dwconv.py `dw_plan`. part: fp32 scratch of [plan.slots, 49 * C] for
// the slots' partial sums. Returns cudaErrorInvalidValue for a plan that
// does not hold the tiles.
int dwconv7x7_dw(const void* x, const void* dy, float* part, void* dw, const DwLaunch* l,
                 void* stream) {
  const hopper::DeviceGuard guard(l->device);
  if (guard.err != 0) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l->x_dtype == vec::kBFloat16
      ? launch_dw<bf16>(x, dy, part, dw, l->B, l->H, l->W, l->C, l->w_dtype, l->plan, s)
      : launch_dw<float>(x, dy, part, dw, l->B, l->H, l->W, l->C, l->w_dtype, l->plan, s);
}

}  // extern "C"
