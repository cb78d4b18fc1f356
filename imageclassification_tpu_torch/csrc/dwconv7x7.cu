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
// What bounds it on an H100. The forward and dx: operations, 2 * 49 flops
// per output element on the fp32 CUDA cores against 2 bytes read and 2
// written per bf16 element: at 67 TFLOP/s and 3.35 TB/s the flops take about
// 1.2x as long as the bytes. They have no dense tensor-core form (each
// channel has its own 7x7 filter). dw does: per channel it is a 7 x 7
// product with depth B*H*W, A[kx, (b, h', w)] = x[b, h', w + kx],
// B[(b, h', w), ky] = dy[b, h' - ky, w], so at the bf16 tensor-core rate its
// bound is the bytes (x and dy read once). That product is too narrow
// (7 x 7) to fill an m64 tensor-core tile without building shifted copies in
// shared memory; this kernel runs it on the CUDA cores, so it cannot reach
// that bound. So the designs feed the FMAs from registers and
// shared memory, not from device memory. The forward: one CTA per
// (batch, 8x8 output tile, 32 channels) copies its input tile with the 3-pixel
// halo (14x14x32) into shared memory with 16-byte cp.async loads (channels
// contiguous, so neighbouring threads read neighbouring bytes), zero-filling
// the border in the copy itself (source size 0) instead of padding the
// tensor; each thread owns 8 channels of a strip of 4 output pixels, holds
// one 10-pixel input row of the window in registers per kernel row and runs
// the 7 kernel columns over it (fp32 FMAs, 32 accumulators in registers).
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

#include "hopper_common.cuh"
#include "vec_common.cuh"

namespace {

using vec::bf16;

constexpr int kK = 7, kPad = 3, kTaps = kK * kK;
constexpr int kTile = 8;                   // output tile kTile x kTile
constexpr int kIn = kTile + 2 * kPad;      // input tile with the halo, 14
constexpr int kCT = 32;                    // channels per CTA
constexpr int kCV = 8;                     // channels per thread
constexpr int kGroups = kCT / kCV;         // 4 channel groups
constexpr int kStrip = 4;                  // output pixels per thread along w
constexpr int kThreads = kGroups * kTile * (kTile / kStrip);  // 64

// Copy the rows [h0 - 3, h0 + 11) x columns [w0 - 3, w0 + 11) x channels
// [c0, c0 + 32) of image b into s (pixel-major, 32 channels a pixel); pixels
// outside the image and channels >= C become zeros.
template <typename T>
__device__ __forceinline__ void load_halo_tile(T* s, const T* x, int b, int h0, int w0, int c0,
                                               int H, int W, int C) {
  constexpr int kChunk = 16 / sizeof(T);         // channels per 16-byte copy
  constexpr int kChunks = kCT / kChunk;          // copies per pixel
  for (int i = threadIdx.x; i < kIn * kIn * kChunks; i += kThreads) {
    const int p = i / kChunks, ch = i % kChunks;
    const int gy = h0 - kPad + p / kIn, gx = w0 - kPad + p % kIn, c = c0 + ch * kChunk;
    const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
    const T* src = valid ? x + (((int64_t)b * H + gy) * W + gx) * C + c : x;
    vec::cp_async_16(s + p * kCT + ch * kChunk, src, valid);
  }
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads)
dwconv7x7_fwd_kernel(const T* __restrict__ x, const WT* __restrict__ w, T* __restrict__ out,
                     int H, int W, int C, int flip) {
  __shared__ __align__(16) T sx[kIn * kIn * kCT];
  __shared__ __align__(16) float sw[kTaps * kCT];
  const int tiles_w = (W + kTile - 1) / kTile;
  const int h0 = (blockIdx.x / tiles_w) * kTile, w0 = (blockIdx.x % tiles_w) * kTile;
  const int c0 = blockIdx.y * kCT, b = blockIdx.z;
  load_halo_tile<T>(sx, x, b, h0, w0, c0, H, W, C);
  for (int i = threadIdx.x; i < kTaps * kCT; i += kThreads) {
    const int tap = i / kCT, c = c0 + i % kCT;
    // flip: tap (ky, kx) reads k[6 - ky, 6 - kx], whose index is 48 - tap
    sw[i] = c < C ? vec::to_float(w[(int64_t)(flip ? kTaps - 1 - tap : tap) * C + c]) : 0.f;
  }
  vec::cp_async_wait_all();
  __syncthreads();

  const int g = threadIdx.x % kGroups;
  const int strip = (threadIdx.x / kGroups) % (kTile / kStrip);
  const int r = threadIdx.x / (kGroups * (kTile / kStrip));
  const int c = c0 + g * kCV;
  if (c >= C) return;
  float acc[kStrip][kCV];
#pragma unroll
  for (int i = 0; i < kStrip; ++i)
#pragma unroll
    for (int j = 0; j < kCV; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int ky = 0; ky < kK; ++ky) {
    float in[kStrip + kK - 1][kCV];
#pragma unroll
    for (int q = 0; q < kStrip + kK - 1; ++q)
      vec::load<T, kCV>(in[q], sx + ((r + ky) * kIn + strip * kStrip + q) * kCT + g * kCV);
#pragma unroll
    for (int kx = 0; kx < kK; ++kx) {
      float wv[kCV];
      vec::load<float, kCV>(wv, sw + (ky * kK + kx) * kCT + g * kCV);
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
#pragma unroll
        for (int j = 0; j < kCV; ++j) acc[i][j] = fmaf(in[i + kx][j], wv[j], acc[i][j]);
    }
  }
  const int oy = h0 + r;
  if (oy >= H) return;
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    const int ox = w0 + strip * kStrip + i;
    if (ox < W) vec::store<T, kCV>(out + (((int64_t)b * H + oy) * W + ox) * C + c, acc[i]);
  }
}

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

// The shared-memory layout of a stage, computed on the host by
// ops/dwconv.py `dw_plan` (its one owner) and checked in `launch_dw`: the
// x tile's rows of row_x >= seg + 6 pixels, then the dy tile's rows of
// row_dy >= seg pixels, at x_elems elements from the stage's start; a stage
// of stage_elems elements. row_x and row_dy are odd, so that the rows that
// one load instruction of a warp reads fall in different banks, and each
// tile starts 128-byte aligned, as TMA writes.
struct DwLayout {
  int seg, row_x, row_dy, x_elems, stage_elems;
};

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
  T* const smem = reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(dw_smem_raw) + 127) & ~static_cast<uintptr_t>(127));
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

dim3 fwd_grid(int B, int H, int W, int C) {
  return dim3((unsigned)(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile)),
              (unsigned)((C + kCT - 1) / kCT), (unsigned)B);
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* out, int B, int H, int W, int C, int flip,
               int w_dtype, cudaStream_t stream) {
  const dim3 grid = fwd_grid(B, H, W, C);
  if (w_dtype == vec::kBFloat16) {
    dwconv7x7_fwd_kernel<T, bf16><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const bf16*>(w), static_cast<T*>(out), H, W, C,
        flip);
  } else {
    dwconv7x7_fwd_kernel<T, float><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), H, W, C,
        flip);
  }
  return (int)cudaGetLastError();
}

// the dynamic shared memory the dw kernel may take: 227 KB a CTA, less its
// static barriers
constexpr int kDwSmemMax = 232448 - 1024;

template <typename T, int kStages>
int launch_dw_stages(const CUtensorMap& tx, const CUtensorMap& tdy, float* part, int B, int H,
                     int W, int C, const DwLayout& lay, int P, int smem, cudaStream_t stream) {
  // once per device: let the kernel take up to kDwSmemMax bytes
  static unsigned long long configured = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !((configured >> dev) & 1)) {
    e = cudaFuncSetAttribute(dwconv7x7_dw_kernel<T, kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmemMax);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) configured |= 1ull << dev;
  }
  const dim3 grid((unsigned)P, (unsigned)((C + kDwCT - 1) / kDwCT));
  dwconv7x7_dw_kernel<T, kStages><<<grid, kDwThreads, smem, stream>>>(tx, tdy, part, B, H, W, C,
                                                                      lay);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, float* part, void* dw, int B, int H, int W, int C,
              int seg, int row_x, int row_dy, int x_bytes, int stage_bytes, int P, int stages,
              int smem, int w_dtype, cudaStream_t stream) {
  // the host's layout must hold the tiles the boxes write, 128-byte aligned,
  // in the shared memory the launch asks for
  const int64_t tile_x = (int64_t)kDwRowsX * row_x * kDwCT * sizeof(T);
  const int64_t tile_dy = (int64_t)kDwRows * row_dy * kDwCT * sizeof(T);
  if (seg <= 0 || seg % kK != 0 || P <= 0 || row_x < seg + 2 * kPad || row_dy < seg ||
      row_x > 256 || row_dy > 256 || x_bytes % 128 || stage_bytes % 128 || x_bytes < tile_x ||
      stage_bytes - x_bytes < tile_dy || smem < (int64_t)stages * stage_bytes + 128 ||
      smem > kDwSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  const DwLayout lay{seg, row_x, row_dy, x_bytes / (int)sizeof(T),
                     stage_bytes / (int)sizeof(T)};
  // x and dy as [B, H, W, C] tensor maps (dims innermost first), read in
  // boxes of 16 channels x a tile row x the tile's rows
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)W * C * sizeof(T),
                                 (cuuint64_t)H * W * C * sizeof(T)};
  const cuuint32_t box_x[4] = {kDwCT, (cuuint32_t)row_x, kDwRowsX, 1};
  const cuuint32_t box_dy[4] = {kDwCT, (cuuint32_t)row_dy, kDwRows, 1};
  CUtensorMap tx, tdy;
  int e = hopper::encode_4d(&tx, type, x, dims, strides, box_x, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0) e = hopper::encode_4d(&tdy, type, dy, dims, strides, box_dy, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  switch (stages) {
    case 1: e = launch_dw_stages<T, 1>(tx, tdy, part, B, H, W, C, lay, P, smem, stream); break;
    case 2: e = launch_dw_stages<T, 2>(tx, tdy, part, B, H, W, C, lay, P, smem, stream); break;
    case 3: e = launch_dw_stages<T, 3>(tx, tdy, part, B, H, W, C, lay, P, smem, stream); break;
    case 4: e = launch_dw_stages<T, 4>(tx, tdy, part, B, H, W, C, lay, P, smem, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  vec::sum_partials(part, dw, w_dtype, P, (int64_t)kTaps * C, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = depthwise 7x7 conv of x with k (flip = 1: with k flipped in both
// spatial axes, which gives the input gradient when x is the output
// gradient). x, out: [B, H, W, C] contiguous, x_dtype 0 fp32 or 1 bf16;
// k: [7, 7, C] contiguous, w_dtype 0 fp32 or 1 bf16; C a multiple of 8.
// Returns a cudaError_t (0 on success).
int dwconv7x7_fwd(const void* x, const void* k, void* out, int B, int H, int W, int C, int flip,
                  int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == vec::kBFloat16 ? launch_fwd<bf16>(x, k, out, B, H, W, C, flip, w_dtype, s)
                                   : launch_fwd<float>(x, k, out, B, H, W, C, flip, w_dtype, s);
}

// dw [7, 7, C] (w_dtype) = the weight gradient for input x and output
// gradient dy ([B, H, W, C] contiguous, x_dtype), by the work split and
// shared-memory layout of ops/dwconv.py `dw_plan`: segments of `seg`
// columns (a multiple of 7); a stage's x tile of rows of row_x pixels
// (x_bytes, rounded to 128) and then its dy tile of rows of row_dy pixels,
// stage_bytes in all; P slots; `stages` (1 to 4) stages in `smem` bytes of
// dynamic shared memory. part: fp32 scratch of [P, 49 * C] for the P slots'
// partial sums. Returns cudaErrorInvalidValue for a layout that does not
// hold the tiles.
int dwconv7x7_dw(const void* x, const void* dy, float* part, void* dw, int B, int H, int W,
                 int C, int seg, int row_x, int row_dy, int x_bytes, int stage_bytes, int P,
                 int stages, int smem, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == vec::kBFloat16
      ? launch_dw<bf16>(x, dy, part, dw, B, H, W, C, seg, row_x, row_dy, x_bytes, stage_bytes,
                        P, stages, smem, w_dtype, s)
      : launch_dw<float>(x, dy, part, dw, B, H, W, C, seg, row_x, row_dy, x_bytes, stage_bytes,
                         P, stages, smem, w_dtype, s);
}

}  // extern "C"
