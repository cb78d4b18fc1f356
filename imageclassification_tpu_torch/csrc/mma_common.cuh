// Tensor-core building blocks shared by the kernels that multiply bf16
// tiles (flash_attention_common.cuh, conv1x1_bn.cu): ldmatrix fragment loads
// from shared memory, the m16n8k16 bf16 product with fp32 accumulators, and
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

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a(16x16, row) * b(16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair; `lo` lands in the low 16 bits (lower column).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

}  // namespace mma
