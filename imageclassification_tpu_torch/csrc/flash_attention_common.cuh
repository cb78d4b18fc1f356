// Helpers shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the 64-row bf16 tiles that TMA writes with its
// 128-byte swizzle, the tensor map over a strided [B, N, H, 64] view, the
// wgmma A fragments of a warpgroup's rows of such a tile, and the epilogue
// that stages a warpgroup's 64 x 64 fp32 accumulator as bf16 in such a tile
// and writes it as whole 128-byte rows.
#pragma once

#include "hopper_common.cuh"
#include "mma_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace flash

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
