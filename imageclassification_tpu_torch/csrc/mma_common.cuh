// Building blocks shared by the kernels that multiply bf16 tiles
// (flash_attention_common.cuh, conv1x1_bn.cu): ldmatrix fragment loads from
// shared memory (in the m16n8k16 layout that wgmma's register A takes), and
// the packing of two floats into a bf16 pair.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two floats to a bf16 pair; `lo` lands in the low 16 bits (lower column).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

}  // namespace mma
