// Shared pieces of the splash-attention kernels for Hopper (sm_90a).
//
// Replaces the TPU splash kernels that scal_sdt_tpu/ops/splash.py builds
// through jax.experimental.pallas.ops.tpu.splash_attention (forward, and the
// separate dq and dkv backward passes). Same contract: non-causal attention
// over (B, H, L, D) bf16 views, q already scaled by D^-0.5 and rounded to
// bf16 by the caller, fp32 running max/sum, logsumexp saved for the backward.
//
// Design (first, simple version): one CTA of 4 warps owns a 64-row tile; each
// warp owns 16 of those rows end to end, so after a tile is staged in shared
// memory the warps only synchronise among themselves. Products run on the
// tensor cores through WMMA (bf16 in, fp32 accumulate, 16x16x16 fragments);
// the softmax runs in fp32 on the CUDA cores out of shared memory.
//
// What bounds it on an H100: at L=4096, D=40 the forward is 4*L^2*D flops per
// head against 4*L*D*2 bytes of I/O, far above the 295 flop/byte ridge, so the
// bound is the tensor-core rate; the design keeps the L x L scores in shared
// memory and never in HBM, which is what the TPU kernel was for. It stays far
// from that bound: WMMA fragments bounce through shared memory each tile and
// nothing overlaps the loads with the products (wgmma/TMA are later work).
//
// Layout: q/k/v/o/do/dq/dk/dv are addressed through (batch, head, row)
// strides in elements with a unit stride over D, so the head-split views of
// ops/attention.py need no copy. D is kept unpadded in HBM and zero-filled up
// to DP (a multiple of 16) in shared memory; rows past L are zero-filled on
// load, masked in the softmax and never written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace ssdt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kRows = 64;         // rows of the tile a CTA owns
constexpr int kInner = 64;        // rows of each tile the inner loop walks
constexpr int kThreads = 128;     // 4 warps x 16 rows
constexpr int kLdS = kInner + 4;  // fp32 score tiles (ldm multiple of 4)
constexpr int kLdP = kInner + 8;  // bf16 probability tiles (ldm multiple of 8)

// Error code for a head dim without a compiled instance (cudaError_t is >= 0).
constexpr int kErrHeadDim = -1;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// (batch, head, row) strides in elements of one (B, H, L, D) view.
struct Strides {
  long long b, h, l;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;     // forward output (read by dq for delta)
  const bf16* dout;  // dO
  bf16* out;         // fwd: O; dq: dq; dkv: dk
  bf16* out2;        // dkv: dv
  float* lse;        // (B, H, Lq) fp32, written by fwd
  float* delta;      // (B, H, Lq) fp32, rowsum(dO * O), written by dq
  int B, H, Lq, Lk, D;
  Strides sq, sk, sv, so, sdo, sout, sout2;
};

template <int DP>
struct Dims {
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  static constexpr int ld = DP + 8;    // bf16 tile row stride
  static constexpr int ldo = DP + 4;   // fp32 staging row stride
  static constexpr int frags = DP / 16;
  static constexpr int chunks = DP / 8;  // 16-byte chunks per row
};

__device__ __forceinline__ const bf16* head_ptr(const bf16* p, Strides s, int b, int h) {
  return p + b * s.b + h * s.h;
}
__device__ __forceinline__ bf16* head_ptr(bf16* p, Strides s, int b, int h) {
  return p + b * s.b + h * s.h;
}

// Stage rows [row0, row0 + kRows) of one head into shared memory, zero-filling
// rows >= nrows and columns >= D (D % 8 == 0, checked by the caller).
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long sl,
                                          int row0, int nrows, int D) {
  constexpr int LD = Dims<DP>::ld, CH = Dims<DP>::chunks;
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < D)
      val = __ldg(reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * sl + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// One warp: C[16 x 64] (fp32) = A[16 x DP] * B^T, with A and B[64 x DP] both
// row-major bf16 tiles in shared memory.
template <int DP>
__device__ __forceinline__ void warp_abt(float* C, int ldc, const bf16* A, const bf16* B) {
  constexpr int LD = Dims<DP>::ld;
  FragC acc[kInner / 16];
#pragma unroll
  for (int n = 0; n < kInner / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk * 16, LD);
#pragma unroll
    for (int n = 0; n < kInner / 16; ++n) {
      FragBT b;
      wmma::load_matrix_sync(b, B + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kInner / 16; ++n)
    wmma::store_matrix_sync(C + n * 16, acc[n], ldc, wmma::mem_row_major);
}

// One warp: acc[16 x DP] += A[16 x 64] * B[64 x DP]; A is a bf16 tile with
// row stride kLdP, B a row-major bf16 tile with row stride Dims<DP>::ld.
template <int DP>
__device__ __forceinline__ void warp_ab_acc(FragC (&acc)[DP / 16], const bf16* A, const bf16* B) {
  constexpr int LD = Dims<DP>::ld;
#pragma unroll
  for (int kk = 0; kk < kInner / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk * 16, kLdP);
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      FragB b;
      wmma::load_matrix_sync(b, B + kk * 16 * LD + n * 16, LD);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// One warp: write its 16 rows of an fp32 tile (row stride Dims<DP>::ldo) to a
// bf16 (B, H, L, D) view, multiplying row r by row_scale[r] when given.
template <int DP>
__device__ __forceinline__ void warp_write_rows(const float* tile, const float* row_scale,
                                                bf16* dst, long long sl, int row0,
                                                int nrows, int D) {
  constexpr int LDO = Dims<DP>::ldo, CH = Dims<DP>::chunks;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i - r * CH) * 8;
    if (row0 + r >= nrows || c >= D) continue;
    const float s = row_scale ? row_scale[r] : 1.f;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16(tile[r * LDO + c + j] * s);
    *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * sl + c) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// One warp: stage its register accumulators (16 x DP) in shared memory and
// write them as bf16 rows.
template <int DP>
__device__ __forceinline__ void warp_store_acc(float* stage, FragC (&acc)[DP / 16], bf16* dst,
                                               long long sl, int row0, int nrows, int D) {
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], Dims<DP>::ldo, wmma::mem_row_major);
  __syncwarp();
  warp_write_rows<DP>(stage, nullptr, dst, sl, row0, nrows, D);
  __syncwarp();
}

}  // namespace ssdt

// The padded head dims with a compiled instance. D (a multiple of 8, at most
// 160) runs on the smallest DP >= D.
#define SSDT_FOR_EACH_DP(X) X(16) X(32) X(48) X(64) X(80) X(96) X(128) X(160)

inline int ssdt_padded_dim(int D) {
  const int dp = (D + 15) / 16 * 16;
  return dp == 112 ? 128 : (dp == 144 ? 160 : dp);
}
