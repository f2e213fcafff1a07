// Float32 products on Hopper's tensor cores at float32 accuracy (3xTF32),
// and the vector loads around them: shared by the chunked WKV
// (csrc/wkv.cu) and its backward (csrc/wkv_bwd.cu).
//
// x = hi + lo in TF32: hi is x rounded to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite float (half an ulp of TF32 added to the
// bit pattern's magnitude, then the 13 low bits cleared: two integer
// operations at the full rate, where the conversion instruction is not);
// lo is x - hi (exact) truncated to TF32, as the tensor cores would read it.
// a b = al bh + ah bl (a correction accumulator) + ah bh (the main one),
// each float32, al bl dropped (~2^-21 relative); an operand that is exact
// in TF32 (a bf16 value) has lo = 0, and its correction term is skipped.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator-(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// Four consecutive elements as float32; 16- or 8-byte loads when `vec`.
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]),
                     __bfloat162float(p[2]), __bfloat162float(p[3]));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ float4& at4(float* p) {
  return *reinterpret_cast<float4*>(p);
}

constexpr uint32_t kTf32 = 0xffffe000u;
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & kTf32;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32;
}

// d += a b, one m16n8k8 TF32 product (float32 accumulation).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d + e += a b by the 3xTF32 split: the main term ah bh into d, the two
// corrections al bh + ah bl into e, so that each accumulator is its own
// chain.  kExactA: a is exact in TF32 (al = 0, not read); kExactB: b is (a
// bf16 value), so b needs no split.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], float (&e)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0 = 0u, h1, l1 = 0u;
  if constexpr (kExactB) {
    h0 = __float_as_uint(b0);
    h1 = __float_as_uint(b1);
  } else {
    split(b0, h0, l0);
    split(b1, h1, l1);
  }
  if constexpr (!kExactA) mma(e, al, h0, h1);
  if constexpr (!kExactB) mma(e, ah, l0, l1);
  mma(d, ah, h0, h1);
}

// d + e += a b with b already split (bh + bl).
__device__ __forceinline__ void mma3s(float (&d)[4], float (&e)[4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t h0,
                                      uint32_t h1, uint32_t l0, uint32_t l1) {
  mma(e, al, h0, h1);
  mma(e, ah, l0, l1);
  mma(d, ah, h0, h1);
}

__device__ __forceinline__ void zero(float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
}

}  // namespace tf32
