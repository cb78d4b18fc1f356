// Helpers shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): 64 x 64 bf16 tiles in shared memory with a
// 128-byte-row XOR swizzle, cp.async loads that zero-fill rows past the end,
// and the tile products built on the ldmatrix / m16n8k16 helpers of
// mma_common.cuh.
#pragma once

#include "mma_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_16816;
using mma::pack_bf16;

constexpr int kHeadDim = 64;
constexpr int kBlock = 64;  // rows of a tile (queries or keys)
constexpr int kWarps = 4;   // each warp owns 16 rows of the CTA's tile
constexpr int kThreads = kWarps * 32;
constexpr int kTileElems = kBlock * kHeadDim;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A tile row is 64 bf16 = 128 bytes = 8 chunks of 16 bytes. Chunk c of row r
// is stored at chunk c ^ (r & 7): the 8 row addresses that ldmatrix takes for
// one 8x8 matrix then fall in 8 different 16-byte bank groups.
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * kHeadDim + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy rows [n0, n0 + 64) of one (batch, head) slice into a swizzled tile;
// rows >= N become zeros. 512 chunks of 16 bytes, 4 per thread.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, int64_t stride_n,
                                          int n0, int N, int tid) {
#pragma unroll
  for (int i = 0; i < (kBlock * 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c >> 3, chunk = c & 7;
    const int n = n0 + row;
    const bool valid = n < N;
    const bf16* src = valid ? base + (int64_t)n * stride_n + chunk * 8 : base;
    cp_async_16(tile + swizzle(row, chunk), src, valid);
  }
}

// The A fragments (16 rows x 64 columns, four 16-column steps) of the warp's
// 16 rows of a swizzled tile.
__device__ __forceinline__ void load_a_frags(unsigned (&frag)[kHeadDim / 16][4],
                                             const bf16* tile, int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int chunk = ks * 2 + (lane >> 4);
    ldmatrix_x4(frag[ks], tile + swizzle(row, chunk));
  }
}

// acc(16 x 64) = A(16 x 64) * T^T for a 64 x 64 tile T in shared memory:
// the product of the warp's rows with every row of T (Q K^T, K Q^T, dO V^T).
__device__ __forceinline__ void mma_a_tileT(float (&acc)[kBlock / 8][4],
                                            const unsigned (&a)[kHeadDim / 16][4],
                                            const bf16* tile, int lane) {
#pragma unroll
  for (int j = 0; j < kBlock / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < kBlock / 16; ++np) {
      unsigned f[4];
      const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int chunk = ks * 2 + ((lane >> 3) & 1);
      ldmatrix_x4(f, tile + swizzle(row, chunk));
      mma_16816(acc[2 * np], a[ks], f[0], f[1]);
      mma_16816(acc[2 * np + 1], a[ks], f[2], f[3]);
    }
  }
}

// acc(16 x 64) += C(16 x 64) * T for a 64 x 64 tile T in shared memory, C
// given as fp32 accumulator fragments (rounded to bf16 here): the C fragments
// of columns 16kk .. 16kk+15 are the A fragment of the 16-deep step kk
// (P V, P^T dO, dS K, dS^T Q).
__device__ __forceinline__ void mma_c_tile(float (&acc)[kHeadDim / 8][4],
                                           const float (&c)[kBlock / 8][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    const unsigned a[4] = {
        pack_bf16(c[2 * kk][0], c[2 * kk][1]), pack_bf16(c[2 * kk][2], c[2 * kk][3]),
        pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
        pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kHeadDim / 16; ++dp) {
      unsigned f[4];
      const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int chunk = dp * 2 + (lane >> 4);
      ldmatrix_x4_trans(f, tile + swizzle(row, chunk));
      mma_16816(acc[2 * dp], a, f[0], f[1]);
      mma_16816(acc[2 * dp + 1], a, f[2], f[3]);
    }
  }
}

// Write the warp's 16 x 64 accumulator as bf16 rows of a contiguous
// [B, N, H, 64] tensor, this thread's row g = lane / 4 times scale[0] and row
// g + 8 times scale[1]; rows >= N are not written.
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[kHeadDim / 8][4],
                                           const float (&scale)[2], int b, int h, int row0,
                                           int N, int H, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = row0 + (lane >> 2) + i * 8;
    if (n >= N) continue;
    bf16* dst = out + (((int64_t)b * N + n) * H + h) * kHeadDim + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      *reinterpret_cast<unsigned*>(dst + j * 8) =
          pack_bf16(acc[j][2 * i] * scale[i], acc[j][2 * i + 1] * scale[i]);
    }
  }
}

}  // namespace flash
