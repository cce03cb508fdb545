// Shared pieces of the optimizer kernels for Hopper (sm_90a):
// adam_bf16_fused.cu (the fused Adam update over stored moments) and
// adam8_fused.cu (the int8 blockwise Adam update).
//
// Bit-exactness. Each kernel is held bit for bit (moments) against the plain
// PyTorch chain it replaces, which rounds after every operation. nvcc
// contracts a*b + c into one fma by default, which rounds once instead of
// twice, so the moment math here is written with the explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which the
// compiler never contracts. The global flags stay as the splash kernels need
// them.
//
// The counter hash and the bf16 stochastic-rounding (SR) store are those of
// scal_sdt_tpu_torch/ops/sr.py (and of the JAX package's ema.py), in
// uint32 registers: h = murmur3_fmix(i * 2654435761 + seed) with
// seed = step * 0x9E3779B9 ^ salt (computed on the host), i the element index
// within the leaf; the high 16 bits of h are added to the fp32 pattern, which
// is then truncated to its high half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssdt {

// Storage dtypes, as the Python wrappers encode them.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float load_as_float(const void* p, int dtype, long long i) {
  switch (dtype) {
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kF16:
      return __half2float(static_cast<const __half*>(p)[i]);
    default:
      return static_cast<const float*>(p)[i];
  }
}

// Round-to-nearest-even store (torch's .to(dtype), JAX's astype).
__device__ __forceinline__ void store_rn(void* p, int dtype, long long i, float x) {
  switch (dtype) {
    case kBF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
      break;
    case kF16:
      static_cast<__half*>(p)[i] = __float2half_rn(x);
      break;
    default:
      static_cast<float*>(p)[i] = x;
  }
}

// murmur3 finalizer (full avalanche).
__device__ __forceinline__ uint32_t murmur_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t cheap_dither_u32(uint32_t i, uint32_t seed) {
  return murmur_mix(i * 2654435761u + seed);
}

// fp32 -> bf16 bit pattern by adding the high 16 dither bits to the fp32
// pattern and truncating: unbiased, and exact on values bf16 already holds.
__device__ __forceinline__ uint16_t sr_bf16_bits(float x, uint32_t i, uint32_t seed) {
  const uint32_t bits = __float_as_uint(x) + (cheap_dither_u32(i, seed) >> 16);
  return static_cast<uint16_t>(bits >> 16);
}

// The SR store as the plain chain does it: SR to bf16, then (for an fp16
// nu) a round-to-nearest cast of that bf16 value.
__device__ __forceinline__ void store_sr(void* p, int dtype, long long i, float x,
                                         uint32_t seed) {
  const uint16_t b = sr_bf16_bits(x, static_cast<uint32_t>(i), seed);
  if (dtype == kBF16) {
    static_cast<uint16_t*>(p)[i] = b;
  } else {
    store_rn(p, dtype, i, __uint_as_float(static_cast<uint32_t>(b) << 16));
  }
}

// Adam's moment updates, each operation rounded on its own, in the order of
// the plain chains: b1*m + (1-b1)*g and b2*v + (1-b2)*(g*g).
__device__ __forceinline__ float adam_mu(float m, float g, float b1, float omb1) {
  return __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
}

__device__ __forceinline__ float adam_nu(float v, float g, float b2, float omb2) {
  return __fadd_rn(__fmul_rn(b2, v), __fmul_rn(omb2, __fmul_rn(g, g)));
}

// The bias-corrected step, in one of the two forms the callers use:
// recip: (m * c1) / (sqrt(v * c2) + eps), c = 1 / bias correction;
// else:  (m / c1) / (sqrt(v / c2) + eps), c = bias correction.
__device__ __forceinline__ float adam_step(float m, float v, float c1, float c2, float eps,
                                           bool recip) {
  const float mh = recip ? __fmul_rn(m, c1) : __fdiv_rn(m, c1);
  const float vh = recip ? __fmul_rn(v, c2) : __fdiv_rn(v, c2);
  return __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), eps));
}

}  // namespace ssdt
