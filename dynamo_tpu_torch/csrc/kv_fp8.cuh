// e4m3 K/V pages upcast to bf16 in shared memory: the producer step of the
// fp8 forms of the attention kernels (csrc/paged_splitkv.cuh for decode and
// verify, csrc/paged_attn_tc.cuh for flash, csrc/mla_decode.cu).
//
// The TPU kernels read an fp8 cache by upcasting each e4m3 page right after
// its DMA (dynamo_tpu/ops/pallas_decode.py:165-168, :278-281, :492-493,
// dynamo_tpu/ops/pallas_attention.py:100-102). Here a kernel's cp.async
// ring holds e4m3 tiles (half the bytes of a bf16 tile); once a tile has
// landed, every thread converts its 16-byte chunks into the bf16 tile the
// products read, each chunk to the two swizzled 16-byte places the bf16
// ring would have copied it to. The products, the softmax and the merge
// stay as they are, and every e4m3 value (subnormals and zeros included)
// is a bf16 value, so a kernel's fp8 form over an e4m3 cache computes bit
// for bit what its bf16 form computes over the cache upcast to bf16.
//
// The conversion: cvt.rn.f16x2.e4m3x2 (Hopper converts e4m3 pairs in
// hardware), then f16 -> f32 -> bf16, exact at each step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

// internal linkage: several kernel libraries include this header
namespace kv_fp8 {
namespace {

// two e4m3 (the first in the low byte) -> bf16x2 (the first in the low half)
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
  const float2 f = __half22float2(__half2(hr));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// 16 e4m3 at `src` (16-byte aligned shared memory) -> elements 0-7 as bf16
// at `lo`, 8-15 at `hi` (each 16-byte aligned)
__device__ __forceinline__ void upcast16(const unsigned char* src,
                                         unsigned char* lo,
                                         unsigned char* hi) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  uint4 a, b;
  a.x = e4m3x2_to_bf16x2(v.x);
  a.y = e4m3x2_to_bf16x2(v.x >> 16);
  a.z = e4m3x2_to_bf16x2(v.y);
  a.w = e4m3x2_to_bf16x2(v.y >> 16);
  b.x = e4m3x2_to_bf16x2(v.z);
  b.y = e4m3x2_to_bf16x2(v.z >> 16);
  b.z = e4m3x2_to_bf16x2(v.w);
  b.w = e4m3x2_to_bf16x2(v.w >> 16);
  *reinterpret_cast<uint4*>(lo) = a;
  *reinterpret_cast<uint4*>(hi) = b;
}

}  // namespace
}  // namespace kv_fp8
