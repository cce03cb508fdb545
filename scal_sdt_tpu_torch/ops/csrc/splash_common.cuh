// Shared pieces of the splash-attention kernels for Hopper (sm_90a).
//
// Replaces the TPU splash kernels that scal_sdt_tpu/ops/splash.py builds
// through jax.experimental.pallas.ops.tpu.splash_attention (forward, and the
// separate dq and dkv backward passes). Same contract: non-causal attention
// over (B, H, L, D) bf16 views, q already scaled by D^-0.5 and rounded to
// bf16 by the caller, fp32 running max/sum, logsumexp saved for the backward.
//
// The forward (splash_fwd.cu) runs on register-resident tiles, the pieces
// below: every product is `mma.sync.m16n8k16` (bf16 in, fp32 accumulate;
// one `m16n8k8` step where D % 16 == 8, so D = 40 runs unpadded) with
// operands read from shared memory by `ldmatrix` (`.trans` where the
// operand is K-major). Scores, probabilities and the output accumulators
// stay in registers; the accumulators of two adjacent n8 tiles of m16n8k16
// are laid out as one k16 A fragment of the next product, so P goes from
// registers straight into it. Tiles of the walked operand come in by
// 16-byte `cp.async` copies into a ring of stages, so the next tile's load
// overlaps this tile's products. A warp owns 16 rows, a CTA 128. The
// backward (splash_bwd.cu) takes from here only the contract, the head-dim
// instances and the small helpers; its tiles, loads and products are
// Hopper's own (splash_hopper.cuh: TMA, mbarriers, wgmma).
//
// What bounds the forward on an H100: at L = 4096 it is far above the 295
// flop/byte ridge, so HBM is not the limit. At D = 40 it does 4*D = 160
// tensor-core flops per exponential, and the exponential unit (16 results
// per clock per SM) is slower than the tensor cores: it is the forward's
// floor. The design spends one FFMA per score on the exponent (log2 e
// folded in), and the exponentials of one warp overlap the products of
// others.
//
// Layout: q/k/v/o are addressed through (batch, head, row) strides in
// elements with a unit stride over D, so the head-split views of
// ops/attention.py need no copy. A compiled instance DP (a multiple of 16)
// serves every D in (DP - 16, DP] (and D = 104..112, 136..144 on 128, 160).
// The forward keeps D unpadded: in shared memory a row holds DP/8 16-byte
// chunks, padded to an odd count, so the 8 rows one `ldmatrix` reads fall in
// 8 different bank groups, and chunks past D are neither loaded nor read.
// Rows past L are zero-filled on load, masked in the softmax and never
// written.

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

// The forward's arguments.
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;    // O
  float* lse;   // (B, H, Lq) fp32
  int B, H, Lq, Lk, D;
  Strides sq, sk, sv, so;
};

__device__ __forceinline__ const bf16* head_ptr(const bf16* p, Strides s, int b, int h) {
  return p + b * s.b + h * s.h;
}
__device__ __forceinline__ bf16* head_ptr(bf16* p, Strides s, int b, int h) {
  return p + b * s.b + h * s.h;
}

// ---------------------------------------------------------------------------
// Register tiles

constexpr int kWarpRows = 16;  // rows each warp owns (one m16 tile)

// Row stride in elements of a bf16 tile in shared memory: DP/8 16-byte
// chunks, made odd.
template <int DP>
struct Tile {
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  static constexpr int chunks = DP / 8;
  static constexpr int ld = (chunks | 1) * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + ROWS) of one head into a shared tile (row stride
// Tile<DP>::ld) with the THREADS threads of the CTA; rows >= nrows are
// zero-filled, chunks past D are skipped (never read).
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long sl,
                                                int row0, int nrows, int D) {
  constexpr int CH = Tile<DP>::chunks, LD = Tile<DP>::ld;
  const int dch = D >> 3;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    if (c >= dch) continue;
    const bool in = row0 + r < nrows;
    const bf16* p = src + (long long)(in ? row0 + r : 0) * sl + c * 8;
    cp_async16(smem_addr(dst + r * LD + c * 8), p, in ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// c[16x8] += a[16x16] * b[16x8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[16x8] += a[16x8] * b[8x8].
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

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

// One warp: A fragments of its 16 rows of a shared tile (row stride
// Tile<DP>::ld), one per k16 step over the head dim; where D % 16 == 8 the
// last step holds a k8 fragment in its first two registers.
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DP / 16][4], const bf16* rows, int D) {
  constexpr int LD = Tile<DP>::ld;
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_addr(rows + (lane & 15) * LD);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 + 16 <= D)
      ldsm_x4(f[kk], base + 2 * (kk * 16 + (lane >> 4) * 8));
    else if (kk * 16 + 8 <= D)
      ldsm_x2(f[kk][0], f[kk][1], base + 2 * kk * 16);
  }
}

// One warp: acc[n] (n8 tile n of 16 walked rows, N = 4 or 8 tiles) +=
// A[16 x D] * W^T, with W the walked rows of a shared tile (row stride
// Tile<DP>::ld, rows w0 ...) and A in k16 fragments from load_a_frags.
template <int DP, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const uint32_t (&a)[DP / 16][4],
                                        const bf16* w, int D) {
  constexpr int LD = Tile<DP>::ld;
  static_assert(N % 4 == 0, "quads of n8 tiles");
  const int lane = threadIdx.x & 31;
  // x4 over two n8 tiles x k16: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
  // (n 8-15, k 0-7), (n 8-15, k 8-15).
  const uint32_t pair = smem_addr(w + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  // k8 step: one matrix per n8 tile, (n 0-7, k 0-7) ... of 4 tiles.
  const uint32_t single = smem_addr(w + (lane & 31) * LD);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 + 16 <= D) {
#pragma unroll
      for (int n = 0; n < N; n += 2) {
        uint32_t b[4];
        ldsm_x4(b, pair + 2 * (n * 8 * LD + kk * 16));
        mma_k16(acc[n], a[kk], b[0], b[1]);
        mma_k16(acc[n + 1], a[kk], b[2], b[3]);
      }
    } else if (kk * 16 + 8 <= D) {
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        uint32_t b[4];
        ldsm_x4(b, single + 2 * (n * 8 * LD + kk * 16));
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_k8(acc[n + i], a[kk][0], a[kk][1], b[i]);
      }
    }
  }
}

// One warp: acc[n] (n8 tile n of the head dim) += P[16 x 16] * W[16 x D],
// with P one k16 A fragment (built from two score tiles) and W 16 walked rows
// of a shared tile (row stride Tile<DP>::ld) read by ldmatrix.trans.
template <int DP>
__device__ __forceinline__ void mma_pw(float (&acc)[DP / 8][4], const uint32_t (&p)[4],
                                       const bf16* w, int D) {
  constexpr int LD = Tile<DP>::ld;
  const int lane = threadIdx.x & 31;
  // x4: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
  const uint32_t base = smem_addr(w + (lane & 15) * LD + (lane >> 4) * 8);
#pragma unroll
  for (int n = 0; n < DP / 8; n += 2) {
    if (n * 8 + 16 <= D) {
      uint32_t b[4];
      ldsm_x4_t(b, base + 2 * n * 8);
      mma_k16(acc[n], p, b[0], b[1]);
      mma_k16(acc[n + 1], p, b[2], b[3]);
    } else if (n * 8 + 8 <= D) {
      uint32_t b0, b1;
      ldsm_x2_t(b0, b1, base + 2 * n * 8);  // lanes 0-15 give the addresses
      mma_k16(acc[n], p, b0, b1);
    }
  }
}

// One warp: its 16 rows of fp32 accumulators (n8 tiles over the head dim),
// times row_scale for rows g and g + 8, as bf16 into its 16 rows of a shared
// tile, then to rows row0.. of a (B, H, L, D) view with 16-byte stores (rows
// past nrows skipped). The shared rows must be the warp's own.
template <int DP>
__device__ __forceinline__ void warp_store_rows(const float (&acc)[DP / 8][4], float scale0,
                                                float scale1, bf16* stage, bf16* dst,
                                                long long sl, int row0, int nrows, int D) {
  constexpr int LD = Tile<DP>::ld, CH = Tile<DP>::chunks;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    if (n * 8 >= D) continue;
    *reinterpret_cast<uint32_t*>(stage + g * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * scale0, acc[n][1] * scale0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * scale1, acc[n][3] * scale1);
  }
  __syncwarp();
  const int dch = D >> 3;
  for (int i = lane; i < kWarpRows * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    if (c >= dch || row0 + r >= nrows) continue;
    *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * sl + c * 8) =
        *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, size_t smem, int rows, int rows_per_cta, int threads,
                  const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, a.B * a.H);
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ssdt

// The padded head dims with a compiled instance. D (a multiple of 8, at most
// 160) runs on the smallest DP >= D.
#define SSDT_FOR_EACH_DP(X) X(16) X(32) X(48) X(64) X(80) X(96) X(128) X(160)

inline int ssdt_padded_dim(int D) {
  const int dp = (D + 15) / 16 * 16;
  return dp == 112 ? 128 : (dp == 144 ? 160 : dp);
}
