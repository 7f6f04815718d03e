// Scalar device helpers of the flash-attention kernels (both directions):
// ex2, shared addresses and bf16 packing.  The wgmma, TMA and mbarrier
// helpers are in hopper.cuh.  Each source includes its own copy (an
// anonymous namespace: no symbol is exported).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to bf16 (to nearest even), ``lo`` in the low half (the
// lower column), by one packed conversion
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

}  // namespace
