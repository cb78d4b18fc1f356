// Helpers shared by the flash-attention kernels. bf16 (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the 64-row bf16 tiles that TMA writes with its
// 128-byte swizzle, the tensor map over a strided [B, N, H, 64] view, the
// wgmma A fragments of a warpgroup's rows of such a tile, and the epilogue
// that stages a warpgroup's 64 x 64 fp32 accumulator as bf16 in such a tile
// and writes it as whole 128-byte rows. fp32 (flash_attention_f32.cu,
// flash_attention_f32_bwd.cu, namespace flash::f32): the layout of the fp32
// tiles that TMA writes, their loads and the tensor map behind them, their
// split into tf32 heads and tails, the tf32 A fragments of a warpgroup's
// rows, the three-pass TF32 products with A from registers, and the grid of
// a persistent launch.
#pragma once

#include "hopper_common.cuh"
#include "mma_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// What a call of an entry point passes besides its tensors and stream,
// described once per shape and layout by ops/flash_attention.py
// `_launch_args` (its `_Launch` mirrors this layout field by field and is
// checked against flash_attention_{fwd,bwd}_launch_bytes at load).
struct FlashLaunch {
  int B;
  int N;
  int H;
  int device;               // the tensors' device, made current for the launch
  long long qkv_stride[3];  // byte strides of q, k and v on H, N, B
  long long o_stride[3];    // of o (the backward's dQ kernel reads it)
  long long do_stride[3];   // of dout (the backward)
  float sm_scale;
};

}  // extern "C"

namespace flash {

typedef __nv_bfloat16 bf16;
using mma::pack_bf16;

constexpr int kHeadDim = 64;
constexpr int kBlock = 64;  // rows of a tile (queries or keys)
constexpr int kTileElems = kBlock * kHeadDim;
constexpr uint32_t kTileBytes = kTileElems * sizeof(bf16);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A tile row is 64 bf16 = 128 bytes = 8 chunks of 16 bytes. In a 1024-byte
// aligned tile, TMA's 128-byte swizzle stores chunk c of row r at chunk
// c ^ (r & 7); this is the element offset of that chunk.
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * kHeadDim + ((chunk ^ (row & 7)) << 3);
}

// The wgmma A fragments (four 16-deep steps along the 64 columns) of this
// warp's 16 rows of a swizzled tile: rows 16wl..16wl+15, the warp's share of
// a warpgroup's 64 (ldmatrix: matrix i of step ks is rows 8(i & 1).. of
// chunk 2ks + i / 2).
__device__ __forceinline__ void load_a_frags(unsigned (&f)[kHeadDim / 16][4], const bf16* tile,
                                             int wl, int lane) {
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    const int row = wl * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    mma::ldmatrix_x4(f[ks], tile + swizzle(row, ks * 2 + (lane >> 4)));
  }
}

// Stage the warpgroup's 64 x 64 accumulator (wgmma layout: warp wl holds rows
// 16wl..16wl+15, this thread rows lane / 4 and lane / 4 + 8) into `tile` as
// bf16, row g times scale[0] and row g + 8 times scale[1].
__device__ __forceinline__ void stage_acc(bf16* tile, const float (&acc)[32],
                                          const float (&scale)[2], int wl, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wl * 16 + (lane >> 2) + r * 8;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      *reinterpret_cast<unsigned*>(tile + swizzle(row, j) + (lane & 3) * 2) =
          pack_bf16(acc[4 * j + 2 * r] * scale[r], acc[4 * j + 2 * r + 1] * scale[r]);
    }
  }
}

// Write a staged tile's rows as rows row0.. of head h of batch b of a
// contiguous [B, N, H, 64] tensor with 16-byte stores, by the warpgroup's 128
// threads (t = thread index in the warpgroup); rows >= N are not written.
__device__ __forceinline__ void write_tile(bf16* out, const bf16* tile, int b, int h, int row0,
                                           int N, int H, int t) {
#pragma unroll
  for (int i = 0; i < (kBlock * 8) / 128; ++i) {
    const int c = t + i * 128;
    const int row = c >> 3, chunk = c & 7;
    const int n = row0 + row;
    if (n < N) {
      *reinterpret_cast<uint4*>(out + (((int64_t)b * N + n) * H + h) * kHeadDim + chunk * 8) =
          *reinterpret_cast<const uint4*>(tile + swizzle(row, chunk));
    }
  }
}

// Host: the tensor map of a [B, N, H, 64] bf16 view with unit stride on the
// last axis and byte strides stride_h, stride_n, stride_b on the others, read
// in 64-row boxes of one (batch, head) with the 128-byte swizzle; rows >= N
// load as zeros. Returns 0 or an error code.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int N, int H,
                       long long stride_h, long long stride_n, long long stride_b) {
  const cuuint64_t dims[4] = {(cuuint64_t)kHeadDim, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)stride_h, (cuuint64_t)stride_n,
                                 (cuuint64_t)stride_b};
  const cuuint32_t box[4] = {(cuuint32_t)kHeadDim, 1, (cuuint32_t)kBlock, 1};
  return hopper::encode<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---- fp32 tiles --------------------------------------------------------------

namespace f32 {

constexpr int kHalf = 32;             // floats of a 128-byte swizzled row
constexpr int kSteps = kHeadDim / 8;  // 8-deep tf32 steps of a product over the head dims
constexpr int kFragRows = 64;         // rows of a tile whose A fragments a warpgroup loads

// A tile of R rows x 64 floats lies as two blocks of R rows x 32 floats
// (head dims 0-31, then 32-63), each 1024-byte aligned and 128-byte swizzled
// as TMA writes it: 16-byte chunk c of row r at chunk c ^ (r & 7). The float
// offset of (row, col < 32) in one block:
__device__ __forceinline__ int swz(int row, int col) {
  return row * kHalf + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// ... and of (row, head dim d) in a tile of R rows
template <int R>
__device__ __forceinline__ int tile_off(int row, int d) {
  return (d >> 5) * (R * kHalf) + swz(row, d & 31);
}

// The descriptor offset (16-byte units) of 8-deep step ks of a K-major tile
// of R rows x 64 head dims: 32 bytes a step inside a block of 32 head dims,
// the second block R * 128 bytes on
template <int R>
__device__ __forceinline__ int step_off(int ks) {
  return (ks >> 2) * (R * kHalf * 4 / 16) + (ks & 3) * 2;
}

// Round `n` floats at `x` to their tf32 heads in place and write the tails
// to `lo` (the same offsets), by kThreadsSplitting threads (this one the
// t-th). A non-finite x keeps a non-finite head, so the tails may round
// by hopper::to_tf32_finite.
template <int kThreadsSplitting>
__device__ __forceinline__ void split(float* x, float* lo, int n, int t) {
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* lo4 = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = t; i < n / 4; i += kThreadsSplitting) {
    const float4 a = x4[i];
    const float4 hi = make_float4(hopper::to_tf32(a.x), hopper::to_tf32(a.y),
                                  hopper::to_tf32(a.z), hopper::to_tf32(a.w));
    lo4[i] = make_float4(hopper::to_tf32_finite(a.x - hi.x), hopper::to_tf32_finite(a.y - hi.y),
                         hopper::to_tf32_finite(a.z - hi.z), hopper::to_tf32_finite(a.w - hi.w));
    x4[i] = hi;
  }
}

// The A fragments of a tile t of 64 rows x 64 head dims as the A of a
// product over the head dims: A(row m, head dim k), this warp's rows 16wl ..
// 16wl + 15, in the m16k8 layout (hopper::wgmma_tf32_rs)
__device__ __forceinline__ void load_item_frags(unsigned (&f)[kSteps][4], const float* t, int wl,
                                                int lane) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      f[ks][v] = __float_as_uint(t[tile_off<kFragRows>(wl * 16 + (lane >> 2) + (v & 1) * 8,
                                                       ks * 8 + (lane & 3) + (v >> 1) * 4)]);
    }
  }
}

// A use of A fragments that a product issued earlier reads: keeps the
// compiler from giving their registers to other values before the wait that
// follows the product
template <int kN>
__device__ __forceinline__ void keep_frags(const unsigned (&f)[kN][4]) {
#pragma unroll
  for (int ks = 0; ks < kN; ++ks) {
    asm volatile("" ::"r"(f[ks][0]), "r"(f[ks][1]), "r"(f[ks][2]), "r"(f[ks][3]));
  }
}

// TMA: rows row0 .. row0 + R - 1 of head h of batch b into a tile of R rows,
// as its two blocks of 32 head dims
template <int R>
__device__ __forceinline__ void load_tile(float* tile, const CUtensorMap* map, uint64_t* bar,
                                          int h, int row0, int b) {
  hopper::tma_load_4d(tile, map, bar, 0, h, row0, b);
  hopper::tma_load_4d(tile + R * kHalf, map, bar, kHalf, h, row0, b);
}

// Issue (without committing) d = A B^T over the 64 head dims in three TF32
// passes, d overwritten: A (64 rows) from registers (load_item_frags, head
// and tail), B the first kCols rows of a K-major tile of kBRows rows x 64
// head dims in shared memory, head and tail. The A tail's pass lo(A) hi(B)
// comes first, then hi(A) lo(B), then hi(A) hi(B); kBTailFirst swaps the
// first two.
template <int kCols, int kBRows, bool kBTailFirst>
__device__ __forceinline__ void product3_rs(float (&d)[kCols / 2], const unsigned (&a)[kSteps][4],
                                            const unsigned (&a_lo)[kSteps][4], const float* b,
                                            const float* b_lo) {
  const uint64_t db = hopper::desc_b128(b, 16, 1024), db_lo = hopper::desc_b128(b_lo, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    hopper::wgmma_tf32_rs<kCols>(d, kBTailFirst ? a[ks] : a_lo[ks],
                                 (kBTailFirst ? db_lo : db) + step_off<kBRows>(ks), ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    hopper::wgmma_tf32_rs<kCols>(d, kBTailFirst ? a_lo[ks] : a[ks],
                                 (kBTailFirst ? db : db_lo) + step_off<kBRows>(ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    hopper::wgmma_tf32_rs<kCols>(d, a[ks], db + step_off<kBRows>(ks), 1);
  }
}

// Issue (without committing) acc(64 x 64) += A B over kKSteps 8-deep steps in
// three TF32 passes, tails first (lo(A) hi(B), hi(A) lo(B), hi(A) hi(B)): A
// from registers (64 rows, one m16k8 fragment a step, head and tail), B (64
// rows x up to 32 columns, K-major, one swizzled block) head and tail in
// shared memory
template <int kKSteps>
__device__ __forceinline__ void product3_rs_block(float (&acc)[32], const unsigned (&a)[4][4],
                                                  const unsigned (&a_lo)[4][4], const float* b,
                                                  const float* b_lo) {
  const uint64_t db = hopper::desc_b128(b, 16, 1024), db_lo = hopper::desc_b128(b_lo, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) hopper::wgmma_tf32_rs<64>(acc, a_lo[ks], db + 2 * ks, 1);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) hopper::wgmma_tf32_rs<64>(acc, a[ks], db_lo + 2 * ks, 1);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) hopper::wgmma_tf32_rs<64>(acc, a[ks], db + 2 * ks, 1);
}

// Host: the tensor map of a [B, N, H, 64] fp32 view with unit stride on the
// last axis and byte strides (H, N, B) `stride`, read in boxes of `rows` rows
// x 32 head dims of one (batch, head) with the 128-byte swizzle; rows >= N
// load as zeros. Returns 0 or an error code.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int N, int H,
                       const long long* stride, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kHeadDim, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)stride[0], (cuuint64_t)stride[1],
                                 (cuuint64_t)stride[2]};
  const cuuint32_t box[4] = {(cuuint32_t)kHalf, 1, (cuuint32_t)rows, 1};
  return hopper::encode<4>(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// Host: the grid of a persistent launch over (batch, head, `rows`-row block)
// items: one CTA an SM, at most one per item.
inline int persistent_grid(const void* kernel, int smem_bytes, int (&cache)[64],
                           const FlashLaunch* l, int rows, int* num_blocks, int* items,
                           int* blocks) {
  *num_blocks = (l->N + rows - 1) / rows;
  const long long n = (long long)*num_blocks * l->B * l->H;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int n_sms = 0;
  const int err = hopper::prepare_persistent(kernel, smem_bytes, cache, &n_sms);
  if (err != 0) return err;
  *items = (int)n;
  *blocks = (int)(n < n_sms ? n : n_sms);
  return 0;
}

}  // namespace f32

}  // namespace flash
