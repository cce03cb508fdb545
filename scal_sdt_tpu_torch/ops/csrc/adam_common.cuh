// Shared pieces of the optimizer kernels for Hopper (sm_90a):
// adam_bf16_fused.cu (the fused Adam update over stored moments) and
// adam8_fused.cu (the int8 blockwise Adam update).
//
// Bit-exactness. Each kernel is held bit for bit (moments, masters) against
// the plain PyTorch chain it replaces, which rounds after every operation.
// nvcc contracts a*b + c into one fma by default, which rounds once instead
// of twice, so the math here is written with the explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which the
// compiler never contracts. The global flags stay as the splash kernels need
// them.
//
// The counter hash and the bf16 stochastic-rounding (SR) store are those of
// scal_sdt_tpu_torch/ops/sr.py (and of the JAX package's ema.py), in
// uint32 registers: h = murmur3_fmix(i * 2654435761 + seed) with
// seed = step * 0x9E3779B9 ^ salt, i the element index within the leaf; the
// high 16 bits of h are added to the fp32 pattern, which is then truncated
// to its high half.
//
// 16-byte accesses. A thread moves eight consecutive elements of a tensor at
// a time: one 16-byte access for a 2-byte dtype, two for fp32 (Raw8). The
// kernels pick, per chunk of a leaf, the first element at which every
// tensor they touch is 16-byte aligned; the elements before it and the
// ragged end run one at a time in the same kernel.
//
// The epilogue. After Adam, the grouped kernels apply the update to the
// master in place, rounded exactly as the plain chain rounds it:
//   u = round_U(out)                                         (the step, in U)
//   u = round_U(u + round_U(round_P(p * wd_P)))              (decay, wd > 0)
//   u = round_U(u * step_U)                                  (the schedule)
//   p = SR_bf16(p + u) for bf16 masters, round_P(p + round_P(u)) otherwise,
// with U the update's dtype (fp32 for AdamW, the gradient's for AdamW8bit),
// P the master's, wd_P = round_P(wd) and step_U = round_U(-lr * schedule)
// computed on the host for each group; under XLA rounding (fp32 masters and updates) the
// decay is one fma, u = fma(p, wd_P, u). The update-only entries store
// round_out(out).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssdt {

// Storage dtypes, as the Python wrappers encode them.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ int dsize(int dtype) { return dtype == kF32 ? 4 : 2; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) { return __uint_as_float(b << 16); }

__device__ __forceinline__ uint16_t bf16_rn_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

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

// x rounded to nearest even in `dtype`, back in fp32.
__device__ __forceinline__ float round_to(int dtype, float x) {
  switch (dtype) {
    case kBF16:
      return __bfloat162float(__float2bfloat16_rn(x));
    case kF16:
      return __half2float(__float2half_rn(x));
    default:
      return x;
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

// The SR store of nu as the plain chain does it: SR to bf16, then (for an
// fp16 nu) a round-to-nearest cast of that bf16 value.
__device__ __forceinline__ float sr_value(int dtype, float x, uint32_t i, uint32_t seed) {
  const float b = bf16_bits_to_float(sr_bf16_bits(x, i, seed));
  return dtype == kBF16 ? b : round_to(dtype, b);
}

// ---- eight consecutive elements of one tensor ------------------------------

struct Raw8 {
  uint4 lo, hi;  // hi holds elements 4-7 of an fp32 tensor only
};

// Elements i..i+7 of `base` (16-byte aligned at i).
__device__ __forceinline__ Raw8 load8(const char* base, int dtype, long long i) {
  Raw8 r;
  const uint4* q = reinterpret_cast<const uint4*>(base + i * dsize(dtype));
  r.lo = q[0];
  r.hi = dtype == kF32 ? q[1] : make_uint4(0, 0, 0, 0);
  return r;
}

__device__ __forceinline__ void unpack8(const Raw8& r, int dtype, float (&x)[8]) {
  const uint32_t w[8] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w, r.hi.x, r.hi.y, r.hi.z, r.hi.w};
  if (dtype == kF32) {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __uint_as_float(w[k]);
  } else if (dtype == kBF16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = bf16_bits_to_float(w[k] & 0xFFFFu);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[k] & 0xFFFFu)));
      x[2 * k + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[k] >> 16)));
    }
  }
}

// Store eight 2-byte patterns (element k in half k of the words).
__device__ __forceinline__ void store8_bits16(char* base, long long i, const uint16_t (&b)[8]) {
  uint4 v;
  v.x = b[0] | (static_cast<uint32_t>(b[1]) << 16);
  v.y = b[2] | (static_cast<uint32_t>(b[3]) << 16);
  v.z = b[4] | (static_cast<uint32_t>(b[5]) << 16);
  v.w = b[6] | (static_cast<uint32_t>(b[7]) << 16);
  *reinterpret_cast<uint4*>(base + i * 2) = v;
}

// Round-to-nearest store of elements i..i+7.
__device__ __forceinline__ void store8_rn(char* base, int dtype, long long i,
                                          const float (&x)[8]) {
  if (dtype == kF32) {
    uint4* q = reinterpret_cast<uint4*>(base + i * 4);
    q[0] = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
    q[1] = make_uint4(__float_as_uint(x[4]), __float_as_uint(x[5]), __float_as_uint(x[6]),
                      __float_as_uint(x[7]));
    return;
  }
  uint16_t b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    b[k] = dtype == kBF16 ? bf16_rn_bits(x[k]) : __half_as_ushort(__float2half_rn(x[k]));
  store8_bits16(base, i, b);
}

// ---- Adam --------------------------------------------------------------------

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

// Adam as XLA fuses plain optax.scale_by_adam (the moment-dtype-less path,
// under the JAX trainer's jit): 1-b1 and 1-b2 (omb1, omb2) rounded to the
// gradient's dtype on the host, g*g rounded to it here; each moment's two
// products and sum contracted into one fma, the one XLA's CPU backend
// contracts (the moment's product for a 2-byte gradient, whose own product is
// then exact, the gradient's for an fp32 one); and the two divisions by the
// bias corrections folded into one, m / (c1 * (sqrt(v / c2) + eps)), as XLA's
// simplifier folds (a / b) / c.
__device__ __forceinline__ float xla_mu(float m, float g, float b1, float omb1, int g_dtype) {
  return g_dtype == kF32 ? __fmaf_rn(omb1, g, __fmul_rn(b1, m))
                         : __fmaf_rn(b1, m, __fmul_rn(omb1, g));
}

__device__ __forceinline__ float xla_nu(float v, float g, float b2, float omb2, int g_dtype) {
  const float gg = __fmul_rn(g, g);
  return g_dtype == kF32 ? __fmaf_rn(omb2, gg, __fmul_rn(b2, v))
                         : __fmaf_rn(b2, v, __fmul_rn(omb2, round_to(g_dtype, gg)));
}

__device__ __forceinline__ float xla_step(float m, float v, float c1, float c2, float eps) {
  return __fdiv_rn(m, __fmul_rn(c1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps)));
}

// ---- epilogues -----------------------------------------------------------------
//
// An epilogue takes Adam's step `out` of element i and stores what the
// entry point returns. prefetch8 issues its loads for i..i+7 before the
// Adam math, finish8 / finish1 consume them.

// The update-only entries: the step rounded to the output dtype.
struct WriteUpdate {
  char* out;
  int dtype;

  __device__ __forceinline__ bool aligned(long long i) const { return aligned16(out + i * dsize(dtype)); }
  __device__ __forceinline__ Raw8 prefetch8(long long) const { return Raw8{}; }
  __device__ __forceinline__ void finish8(long long i, const Raw8&, const float (&o)[8]) const {
    store8_rn(out, dtype, i, o);
  }
  __device__ __forceinline__ void finish1(long long i, float o) const { store_rn(out, dtype, i, o); }
};

// The scalars of the master apply: the dtypes and fma_decay are a launch's,
// the rest a param group's (adam_bf16_fused.cu's AdamGroup) or, in
// adam8_fused.cu, a launch's.
struct ApplyArgs {
  int p_dtype, u_dtype, has_wd;
  int fma_decay;      // the decay as one fma, u + p * wd (XLA's contraction)
  float wd_p;         // weight decay rounded to the master's dtype
  float step_u;       // -lr * schedule(count), rounded to the update's dtype
  uint32_t step_mix;  // step * 0x9E3779B9; a leaf's seed is step_mix ^ its salt
};

// The grouped entries: decay, schedule, then the master apply in place.
struct ApplyToMaster {
  char* p;
  ApplyArgs a;
  uint32_t seed;

  __device__ __forceinline__ float update(float out, float pv) const {
    float u = round_to(a.u_dtype, out);
    if (a.has_wd && a.fma_decay)
      u = round_to(a.u_dtype, __fmaf_rn(pv, a.wd_p, u));
    else if (a.has_wd)
      u = round_to(a.u_dtype,
                   __fadd_rn(u, round_to(a.u_dtype, round_to(a.p_dtype, __fmul_rn(pv, a.wd_p)))));
    return round_to(a.u_dtype, __fmul_rn(u, a.step_u));
  }
  // The new master value (its bf16 pattern's value for SR).
  __device__ __forceinline__ float apply(float pv, float u, long long i) const {
    if (a.p_dtype == kBF16) return bf16_bits_to_float(sr_bf16_bits(__fadd_rn(pv, u), (uint32_t)i, seed));
    return round_to(a.p_dtype, __fadd_rn(pv, round_to(a.p_dtype, u)));
  }

  __device__ __forceinline__ bool aligned(long long i) const { return aligned16(p + i * dsize(a.p_dtype)); }
  __device__ __forceinline__ Raw8 prefetch8(long long i) const { return load8(p, a.p_dtype, i); }
  __device__ __forceinline__ void finish8(long long i, const Raw8& raw, const float (&o)[8]) const {
    float pv[8];
    unpack8(raw, a.p_dtype, pv);
#pragma unroll
    for (int k = 0; k < 8; ++k) pv[k] = apply(pv[k], update(o[k], pv[k]), i + k);
    store8_rn(p, a.p_dtype, i, pv);  // exact: each value is already in the master's dtype
  }
  __device__ __forceinline__ void finish1(long long i, float o) const {
    const float pv = load_as_float(p, a.p_dtype, i);
    store_rn(p, a.p_dtype, i, apply(pv, update(o, pv), i));
  }
};

// ---- grouped launches ------------------------------------------------------------

// A chunk of a grouped launch: one CTA updates chunk `chunk` of leaf `leaf`.
struct Chunk {
  int leaf, chunk;
};

}  // namespace ssdt
