// Shared pieces of the splash-attention kernels for Hopper (sm_90a).
//
// Replaces the TPU splash kernels that scal_sdt_tpu/ops/splash.py builds
// through jax.experimental.pallas.ops.tpu.splash_attention (forward, and the
// separate dq and dkv backward passes). Same contract: non-causal attention
// over (B, H, L, D) bf16 views, q already scaled by D^-0.5 and rounded to
// bf16 by the caller, fp32 running max/sum, logsumexp saved for the backward.
//
// All three kernels (splash_fwd.cu, splash_bwd.cu) share one design, built
// from splash_hopper.cuh: a producer warp TMA-loads chunk-major tiles into a
// ring of shared-memory stages under mbarriers, and consumer warpgroups of 64
// rows run every product as an asynchronous wgmma (wgmma.cuh), keep scores,
// probabilities and accumulators in registers, and take turns at issuing so
// one group's exponentials and fp32 work run under another's products.
//
// What bounds them on an H100: at the main path's lengths (L >= 1024) each
// kernel does far more work per byte than the 295 flop/byte ridge, so HBM is
// not the limit. The tensor cores (989 TFLOP/s bf16) and the exponential
// unit (16 MUFU.EX2 results per clock per SM: one exponential per score) set
// the floor between them: 4 D tensor-core flops per exponential in the
// forward, 6 D in dq, 8 D in dkv, so at D = 40 the forward's floor is the
// exponentials and at D = 64 it is close to both. One FFMA per score folds
// log2 e into the exponent.
//
// Layout: each operand is a (B, H, L, D) view with a unit stride over D and
// 16-byte strides elsewhere (ops/splash.py `tma_geometry`: the head-split
// views of ops/attention.py need no copy). A compiled instance DP (a multiple
// of 16) serves every D in (DP - 16, DP] (and D = 104..112, 136..144 on 128,
// 160): a tile's chunks past D arrive as zeros by TMA's out-of-bounds fill,
// products run over DP, columns past D are never stored. Rows past L arrive
// as zeros, keys past Lk are masked, rows past L are never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssdt {

using bf16 = __nv_bfloat16;

// Error code for a head dim without a compiled instance (cudaError_t is >= 0).
constexpr int kErrHeadDim = -1;

constexpr float kLog2e = 1.4426950408889634f;

// (batch, head, row) strides in elements of one (B, H, L, D) view.
struct Strides {
  long long b, h, l;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as bf16x2, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace ssdt

// The padded head dims with a compiled instance. D (a multiple of 8, at most
// 160) runs on the smallest DP >= D.
#define SSDT_FOR_EACH_DP(X) X(16) X(32) X(48) X(64) X(80) X(96) X(128) X(160)

inline int ssdt_padded_dim(int D) {
  const int dp = (D + 15) / 16 * 16;
  return dp == 112 ? 128 : (dp == 144 ? 160 : dp);
}
