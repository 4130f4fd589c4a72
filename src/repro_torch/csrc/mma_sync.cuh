// Warp-level bf16 tensor-core products (mma.sync.m16n8k16 with fp32
// accumulators), their ldmatrix operand loads from shared memory, and the
// quad reductions over an accumulator row. Shared by flash_attention.cu
// (its mma.sync kernel and the Hopper kernel's epilogue) and
// flash_attention_bwd.cu.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4 g + t; an accumulator
// c[4] holds (row g, cols 2t, 2t+1) in c[0], c[1] and (row g + 8, the same
// cols) in c[2], c[3]; an A fragment a[4] holds (row g, cols 2t..), (row
// g + 8, cols 2t..), (row g, cols 2t + 8..), (row g + 8, cols 2t + 8..),
// two bf16 each. So two accumulators side by side (cols 0-7 and 8-15),
// rounded to bf16, are the A fragment of the next product's k16 step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed on the way to registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x (ex2.approx.ftz: one MUFU op; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^2x + 1) from one ex2 and a fast division: within
// ~2e-7 of tanhf absolutely (what a soft cap c tanh(s / c) needs), about a
// fifth of its instructions; +-1 past |x| ~ 44
__device__ __forceinline__ float tanh_ex2(float x) {
  return 1.f - __fdividef(2.f, ex2(x * 2.8853900817779268f) + 1.f);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
