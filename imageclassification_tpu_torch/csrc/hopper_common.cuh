// Hopper (sm_90a) building blocks for kernels fed by the Tensor Memory
// Accelerator (flash_attention_fwd.cu, flash_attention_bwd.cu, dwconv7x7.cu,
// layernorm.cu, conv1x1_bn.cu, flash_attention_f32_bwd.cu) and multiplying on
// warpgroup tensor cores (the flash-attention kernels, conv1x1_bn.cu):
// mbarriers, named barriers, TMA tile loads and stores and 1-d bulk copies,
// wgmma descriptors, bf16 products (m64n128k16, m64n64k16 and m64n16k16 with
// A in shared memory or in registers) and tf32 products (m64n32k8 and
// m64n8k8 with A in shared memory; m64n64k8, m64n32k8 and m64n8k8 with A in
// registers), register reallocation between warpgroups, the host-side
// encoding of a tensor map through the driver entry point (so nothing links
// -lcuda), and the host side of a launch: the device made current for it,
// its dynamic shared memory allowed, the set-up of a persistent grid.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// order this thread's shared-memory accesses before later ones of the async
// proxy (TMA writes into the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `raw` (a shared-memory array) advanced to the next multiple of kAlign
// bytes of the shared address space. Pointer arithmetic on the array, not a
// round trip through an integer: the compiler then still knows the result
// points to shared memory and emits LDS/STS for it, not the slower generic
// loads and stores.
template <typename T, int kAlign>
__device__ __forceinline__ T* align_smem(unsigned char* raw) {
  const uint32_t pad = (kAlign - (smem_addr(raw) & (kAlign - 1))) & (kAlign - 1);
  return reinterpret_cast<T*>(raw + pad);
}

// ---- named barriers --------------------------------------------------------

// wait until `threads` threads (whole warps) have reached barrier `id` (1-15;
// 0 is __syncthreads)
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// count this thread's warp at barrier `id` without waiting: the threads that
// wait there (named_barrier_sync with the same total) see its earlier
// shared-memory writes
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- register reallocation -------------------------------------------------

// Between warpgroups of a CTA: every warp of a warpgroup lowers (or raises) its
// registers a thread to kRegs (a multiple of 8 in [24, 256]); a raise waits
// until lowered registers are free.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- TMA -------------------------------------------------------------------

// Copy the box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory; completion is counted in bytes on `bar`. Out-of-bounds
// elements are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The same for a 2-d tensor map: the box at (c0, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Copy a box of shared memory at `src` to the box at (c0, c1) of a 2-d
// tensor map; elements outside the tensor are not written. The copy joins
// this thread's current bulk group (bulk_commit closes it). The shared
// memory must not be written again before bulk_wait_read says the group
// has read it, and the writes of other threads must be ordered before the
// copy by fence_proxy_async and a barrier.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `bytes` (a multiple of 16) of contiguous global memory at `src` into
// shared memory at `dst`, both 16-byte aligned; completion is counted in
// bytes on `bar`. A 1-d bulk copy: no tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a bf16 tile in shared memory laid out by TMA's 128-byte
// swizzle (rows of 128 bytes, 1024-byte aligned 8-row atoms): start address,
// leading and stride byte offsets (16-byte units), layout type 1 = 128B.
__device__ __forceinline__ uint64_t desc_b128(const void* tile, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = (smem_addr(tile) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across the
// asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d(64 x N, fp32) (+)= a(64 x 16, bf16) * b(16 x N, bf16). The warpgroup's
// warp w holds rows 16w..16w+15 of d: d[4j + e] at column 8j + 2(lane % 4) +
// (e & 1), row lane / 4 + 8(e >> 1), as mma.sync m16n8k16 lays them out.
// kTransB = 0: b is stored K-major (N rows of K contiguous values); 1:
// MN-major (K rows of N contiguous values). scale_d = 0 overwrites d.

// N = 128, 64 or 16, a in shared memory (K-major) through its descriptor
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_m64k16_ss(float (&d)[N / 2], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  static_assert(N == 128 || N == 64 || N == 16, "m64n128k16, m64n64k16 and m64n16k16 only");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
}

// N = 128, 64 or 16, a in registers: the warp's m16k16 A fragment, laid out as
// for mma.sync. The registers of `a` must keep their values until the
// product is waited for.
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[N / 2], const unsigned (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  static_assert(N == 128 || N == 64 || N == 16, "m64n128k16, m64n64k16 and m64n16k16 only");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
}

// ---- wgmma, tf32 -------------------------------------------------------------

// An fp32 value rounded to the nearest tf32 (10 mantissa bits, the low 13 bits
// of the word zero), as a tf32 operand of wgmma takes it.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The same rounding in two integer operations, where cvt.rna's expansion
// takes four (its NaN test and select): exact for finite x, but a non-finite
// x may come out as anything, even zero (the GPU's NaN 0x7fffffff carries into
// the sign bit). So it rounds only values whose non-finite case reaches the
// result another way: a tail x - to_tf32(x) (where x is not finite, neither is
// its head), and softmax probabilities whose row sum is taken from them
// unrounded.
__device__ __forceinline__ float to_tf32_finite(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// d(64 x N, fp32) (+)= a(64 x 8, tf32) * b(8 x N, tf32). The tf32 forms take
// both operands K-major only (no transpose): in shared memory as rows of K
// contiguous values, here 128-byte swizzled rows of 32 floats (desc_b128; a
// step of 8 along K is 32 bytes). The accumulator lies as the bf16 forms';
// an A fragment in registers is the warp's m16k8 slice as mma.sync
// m16n8k8.tf32 lays it out: a[0] at row lane / 4, column lane % 4, a[1] 8
// rows below, a[2] 4 columns right, a[3] both. scale_d = 0 overwrites d.

// N = 32 or 8, a in shared memory through its descriptor
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 8, "m64n32k8 and m64n8k8 only");
  if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// N = 64, 32 or 8, a in registers (tf32 words); they must keep their values
// until the product is waited for
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const unsigned (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 32 || N == 8, "m64n64k8, m64n32k8 and m64n8k8 only");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded; null if absent
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
        ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A tensor map of rank R (2 to 5) of `type` over `base` with dims[0]
// contiguous and the byte strides of dims 1..R-1, read or written in boxes of
// box[0..R-1] elements with the given swizzle; out-of-bounds elements load as
// zeros. Returns 0 or an error code.
template <int R>
inline int encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                  const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                  const cuuint32_t (&box)[R], CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  // the encoding needs a current context on this thread. The runtime makes
  // the primary context current lazily, and a thread that has only asked
  // for the device it already has (torch's autograd threads) may not have
  // one yet: cudaSetDevice makes it current, once per thread and device
  static thread_local int bound = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != bound) {
    e = cudaSetDevice(dev);
    if (e == cudaSuccess) bound = dev;
  }
  if (e != cudaSuccess) return (int)e;
  cuuint32_t elem_strides[R];
  for (int i = 0; i < R; ++i) elem_strides[i] = 1;
  CUresult r = fn(map, type, R, const_cast<void*>(base), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Once per device for each kernel (`cache`, indexed by device, zeros at
// first): allow `kernel` `smem_bytes` of dynamic shared memory and read the
// device's SM count, which sizes a persistent grid. Returns 0 or an error
// code.
inline int prepare_persistent(const void* kernel, int smem_bytes, int (&cache)[64],
                              int* n_sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int n = dev < 64 ? cache[dev] : 0;
  if (n == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) cache[dev] = n;
  }
  *n_sms = n;
  return 0;
}

// Makes `device` current for the launches of an entry point and restores
// the caller's device after them: torch's current device may be another than
// the tensors'. Costs a cudaGetDevice when it is already current.
struct DeviceGuard {
  int prev = -1;
  int err = 0;
  explicit DeviceGuard(int device) {
    err = (int)cudaGetDevice(&prev);
    if (err == 0 && prev != device) {
      err = (int)cudaSetDevice(device);
    } else {
      prev = -1;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Once per device for each kernel (a bit per device in `configured`): let
// it take up to `bytes` of dynamic shared memory. Returns 0 or an error code.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, unsigned long long& configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !((configured >> dev) & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) configured |= 1ull << dev;
  }
  return 0;
}

}  // namespace hopper
