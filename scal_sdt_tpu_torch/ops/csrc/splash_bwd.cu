// Splash-attention backward for Hopper, as two kernels with no atomics,
// matching the split (non-fused) backward of the TPU version
// (scal_sdt_tpu/ops/splash.py sets use_fused_bwd_kernel=False):
//
// * dq  replaces `_splash_attention_bwd_dq`: one CTA per (head, 64 query
//   rows) walks every KV tile: S = q k^T, P = exp(S - lse), dP = dO v^T,
//   dS = P * (dP - delta), dq += dS k (accumulated in registers). It also
//   computes delta = rowsum(dO * O) for its rows and stores it for dkv.
//   Still the first design (splash_common.cuh): WMMA fragments through
//   shared memory, synchronous tile loads.
// * dkv replaces `_splash_attention_bwd_dkv`, on the register-tile design
//   (splash_common.cuh): one CTA per (head, 64 or 128 key rows), 16 key rows
//   per warp (DkvShape). A warp keeps its k and v rows as A fragments in
//   registers (up to DP = 96; wider instances reload them from the warp's own
//   shared rows per step, so that dK / dV fit). q / dO tiles of 64 queries,
//   with their lse and delta, come by cp.async double buffering. Per step of
//   32 (or 16) queries: S^T = k q^T and dP^T = v dO^T (mma.sync, q and dO by
//   ldmatrix), P^T = exp2(S^T log2 e - lse log2 e) and dS^T = P^T (dP^T -
//   delta) in registers, rounded to bf16 in registers as the A operands of
//   dV += P^T dO and dK += dS^T q (dO, q by ldmatrix.trans). dK and dV stay
//   fp32 in registers and are written once. Only the last query tile masks
//   queries past Lq.
//
//   What bounds it: 8 D tensor-core flops per exponential put its floor on
//   the tensor cores, but it runs far above it, bound by the latency of its
//   dependent mma chains: measured on an H100, its time falls with every warp
//   more per SM, so the shapes trade tile rows for CTAs per SM within the
//   registers; every warp also reads each q / dO tile from shared memory
//   twice (plain and transposed).
//
// dkv reads the delta that dq wrote, so the two launch in that order on one
// stream. Gradients are with respect to the pre-scaled q the forward saw;
// the caller's autograd applies the scale's chain rule.

#include <mma.h>

#include "splash_common.cuh"

namespace ssdt {

// ---------------------------------------------------------------------------
// dq: WMMA tiles through shared memory

namespace wmma = nvcuda::wmma;

constexpr int kRows = 64;         // rows of the tile a CTA owns
constexpr int kInner = 64;        // rows of each tile the inner loop walks
constexpr int kThreads = 128;     // 4 warps x 16 rows
constexpr int kLdS = kInner + 4;  // fp32 score tiles (ldm multiple of 4)
constexpr int kLdP = kInner + 8;  // bf16 probability tiles (ldm multiple of 8)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DP>
struct Dims {
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  static constexpr int ld = DP + 8;    // bf16 tile row stride
  static constexpr int ldo = DP + 4;   // fp32 staging row stride
  static constexpr int frags = DP / 16;
  static constexpr int chunks = DP / 8;  // 16-byte chunks per row
};

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

// One warp: stage its register accumulators (16 x DP) in shared memory and
// write them as bf16 rows of a (B, H, L, D) view.
template <int DP>
__device__ __forceinline__ void warp_store_acc(float* stage, FragC (&acc)[DP / 16], bf16* dst,
                                               long long sl, int row0, int nrows, int D) {
  constexpr int LDO = Dims<DP>::ldo, CH = Dims<DP>::chunks;
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], LDO, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i - r * CH) * 8;
    if (row0 + r >= nrows || c >= D) continue;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16(stage[r * LDO + c + j]);
    *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * sl + c) =
        *reinterpret_cast<const uint4*>(vals);
  }
  __syncwarp();
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  const size_t tiles = (size_t)(4 * kRows * Dims<DP>::ld + kRows * kLdP) * sizeof(bf16) +
                       (size_t)(2 * kRows * kLdS + 2 * kRows) * sizeof(float);
  const size_t stage = (size_t)kRows * Dims<DP>::ldo * sizeof(float);
  return tiles > stage ? tiles : stage;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) splash_dq_kernel(Args a) {
  constexpr int LD = Dims<DP>::ld;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kRows * LD;
  bf16* sK = sDO + kRows * LD;
  bf16* sV = sK + kRows * LD;
  bf16* sDS = sV + kRows * LD;
  float* sS = reinterpret_cast<float*>(sDS + kRows * kLdP);
  float* sDP = sS + kRows * kLdS;
  float* sLse = sDP + kRows * kLdS;
  float* sDelta = sLse + kRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kRows;
  const bf16* k = head_ptr(a.k, a.sk, b, h);
  const bf16* v = head_ptr(a.v, a.sv, b, h);
  const bf16* o = head_ptr(a.o, a.so, b, h);

  load_rows<DP>(sQ, head_ptr(a.q, a.sq, b, h), a.sq.l, q0, a.Lq, a.D);
  load_rows<DP>(sDO, head_ptr(a.dout, a.sdo, b, h), a.sdo.l, q0, a.Lq, a.D);
  __syncthreads();

  const int r0 = warp * 16;
  const int row = r0 + (lane >> 1), half = lane & 1;
  const int grow = q0 + row;
  {
    // delta = rowsum(dO * O) in fp32 over the bf16 values, as the TPU kernel.
    float d = 0.f;
    if (grow < a.Lq) {
      const bf16* orow = o + (long long)grow * a.so.l;
      for (int c = half; c < a.D; c += 2)
        d += __bfloat162float(sDO[row * LD + c]) * __bfloat162float(orow[c]);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sDelta[row] = d;
      sLse[row] = grow < a.Lq ? a.lse[(long long)bh * a.Lq + grow] : 0.f;
      if (grow < a.Lq) a.delta[(long long)bh * a.Lq + grow] = d;
    }
  }
  __syncwarp();
  const float lse = sLse[row], delta = sDelta[row];

  FragC acc[Dims<DP>::frags];
#pragma unroll
  for (int n = 0; n < Dims<DP>::frags; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int k0 = 0; k0 < a.Lk; k0 += kInner) {
    __syncthreads();
    load_rows<DP>(sK, k, a.sk.l, k0, a.Lk, a.D);
    load_rows<DP>(sV, v, a.sv.l, k0, a.Lk, a.D);
    __syncthreads();

    warp_abt<DP>(sS + r0 * kLdS, kLdS, sQ + r0 * LD, sK);
    warp_abt<DP>(sDP + r0 * kLdS, kLdS, sDO + r0 * LD, sV);
    __syncwarp();

    // Rows past Lq hold q = dO = 0 and lse = delta = 0, so their dS is 0.
    const float* srow = sS + row * kLdS + half * 32;
    const float* dprow = sDP + row * kLdS + half * 32;
    bf16* dsrow = sDS + row * kLdP + half * 32;
    const int valid = a.Lk - k0 - half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      float ds = 0.f;
      if (c < valid) ds = __expf(srow[c] - lse) * (dprow[c] - delta);
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_ab_acc<DP>(acc, sDS + r0 * kLdP, sK);
  }

  __syncthreads();  // all warps are done with the tiles; reuse smem as staging
  float* stage = reinterpret_cast<float*>(smem) + r0 * Dims<DP>::ldo;
  warp_store_acc<DP>(stage, acc, head_ptr(a.out, a.sout, b, h), a.sout.l, q0 + r0, a.Lq, a.D);
}

// ---------------------------------------------------------------------------
// dkv: register tiles

// Launch shape of each instance, chosen on an H100 by time and by the
// ptxas report (no spill up to DP = 128): the kernel is latency-bound, so the
// narrow instances take CTAs of 4 warps, as many per SM as their registers
// allow, and every instance up to DP = 96 walks 32 queries per inner step
// for more independent products per warp.
template <int DP>
struct DkvShape {
  static constexpr int warps = DP <= 64 ? 4 : 8;  // 16 key rows each
  static constexpr int step = DP <= 96 ? 32 : 16;  // queries of one inner step
  static constexpr int min_blocks = DP <= 48 ? 3 : (DP <= 64 ? 2 : 1);  // CTAs per SM
  static constexpr bool frags_in_regs = DP <= 96;  // k / v A fragments
  static constexpr int threads = warps * 32, rows = warps * kWarpRows;
};

template <int DP>
constexpr size_t dkv_smem_bytes() {
  // k and v rows of the CTA; per buffer a q and a dO tile, then lse and delta
  return (size_t)(2 * DkvShape<DP>::rows + 2 * 2 * kWalk) * Tile<DP>::ld * sizeof(bf16) +
         (size_t)2 * 2 * kWalk * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(DkvShape<DP>::threads, DkvShape<DP>::min_blocks)
    splash_dkv_kernel(Args a) {
  using Shape = DkvShape<DP>;
  constexpr int kDkvThreads = Shape::threads, kDkvRows = Shape::rows, kDkvStep = Shape::step;
  constexpr int LD = Tile<DP>::ld, NT = DP / 8;
  constexpr int kTileElems = kWalk * LD;
  constexpr int SN = kDkvStep / 8;  // n8 query tiles of one step
  constexpr bool kFragsInRegs = Shape::frags_in_regs;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kDkvRows * LD;
  bf16* sQD = sV + kDkvRows * LD;  // buffer s: q at 2s, dO at 2s + 1
  float* sRow = reinterpret_cast<float*>(sQD + 2 * 2 * kTileElems);  // lse, delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kDkvRows;
  const int D = a.D, Lq = a.Lq;
  const bf16* q = head_ptr(a.q, a.sq, b, h);
  const bf16* dout = head_ptr(a.dout, a.sdo, b, h);
  const float* lse_g = a.lse + (long long)bh * Lq;
  const float* delta_g = a.delta + (long long)bh * Lq;
  const int ntiles = (Lq + kWalk - 1) / kWalk;

  auto load_q = [&](int j) {
    const int s = j & 1;
    bf16* dst = sQD + s * 2 * kTileElems;
    load_tile_async<kWalk, DP, kDkvThreads>(dst, q, a.sq.l, j * kWalk, Lq, D);
    load_tile_async<kWalk, DP, kDkvThreads>(dst + kTileElems, dout, a.sdo.l, j * kWalk, Lq, D);
    for (int i = threadIdx.x; i < 2 * kWalk; i += kDkvThreads) {
      const int which = i / kWalk;  // 0: lse, 1: delta
      load_rowvec_async(sRow + (2 * s + which) * kWalk, which ? delta_g : lse_g, j * kWalk, Lq,
                        i % kWalk);
    }
  };
  load_tile_async<kDkvRows, DP, kDkvThreads>(sK, head_ptr(a.k, a.sk, b, h), a.sk.l, k0, a.Lk, D);
  load_tile_async<kDkvRows, DP, kDkvThreads>(sV, head_ptr(a.v, a.sv, b, h), a.sv.l, k0, a.Lk, D);
  load_q(0);
  cp_async_commit();

  bf16* myK = sK + warp * kWarpRows * LD;
  bf16* myV = sV + warp * kWarpRows * LD;
  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();  // tile j landed for this thread
    __syncthreads();     // ... for all; the other buffer is free
    if (j + 1 < ntiles) load_q(j + 1);
    cp_async_commit();
    if (kFragsInRegs && j == 0) {
      load_a_frags<DP>(kf, myK, D);
      load_a_frags<DP>(vf, myV, D);
    }

    const int s = j & 1;
    const bf16* tQ = sQD + s * 2 * kTileElems;
    const bf16* tDO = tQ + kTileElems;
    const float* lse = sRow + 2 * s * kWalk;
    const float* delta = lse + kWalk;
    const int qbase = j * kWalk;
    const bool tail = qbase + kWalk > Lq;  // mask queries past Lq
#pragma unroll 1
    for (int c = 0; c < kWalk; c += kDkvStep) {
      if (!kFragsInRegs) {
        load_a_frags<DP>(kf, myK, D);
        load_a_frags<DP>(vf, myV, D);
      }
      // Keys g, g + 8 of the warp's 16 (rows) x queries c + 8 n + 2t, +1.
      float st[SN][4], dpt[SN][4];
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      mma_abt<DP, SN>(st, kf, tQ + c * LD, D);
      mma_abt<DP, SN>(dpt, vf, tDO + c * LD, D);

      uint32_t pa[SN / 2][4], da[SN / 2][4];  // P^T, dS^T as k16 A fragments
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        const int qi = c + n * 8 + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(lse + qi);
        const float2 dl = *reinterpret_cast<const float2*>(delta + qi);
        const float n0 = -ls.x * kLog2e, n1 = -ls.y * kLog2e;
        float p0 = exp2_approx(fmaf(st[n][0], kLog2e, n0));
        float p1 = exp2_approx(fmaf(st[n][1], kLog2e, n1));
        float p2 = exp2_approx(fmaf(st[n][2], kLog2e, n0));
        float p3 = exp2_approx(fmaf(st[n][3], kLog2e, n1));
        if (tail) {
          if (qbase + qi >= Lq) p0 = p2 = 0.f;
          if (qbase + qi + 1 >= Lq) p1 = p3 = 0.f;
        }
        // n8 tile n: the low (n even) or high half of k16 step n / 2.
        pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
        da[n / 2][(n & 1) * 2] = pack_bf16(p0 * (dpt[n][0] - dl.x), p1 * (dpt[n][1] - dl.y));
        da[n / 2][(n & 1) * 2 + 1] =
            pack_bf16(p2 * (dpt[n][2] - dl.x), p3 * (dpt[n][3] - dl.y));
      }
#pragma unroll
      for (int kk = 0; kk < SN / 2; ++kk) {
        mma_pw<DP>(dv, pa[kk], tDO + (c + kk * 16) * LD, D);
        mma_pw<DP>(dk, da[kk], tQ + (c + kk * 16) * LD, D);
      }
    }
  }

  // Key rows past Lk (k = v = 0) are never written.
  const int row0 = k0 + warp * kWarpRows;
  warp_store_rows<DP>(dk, 1.f, 1.f, myK, head_ptr(a.out, a.sout, b, h), a.sout.l, row0, a.Lk, D);
  warp_store_rows<DP>(dv, 1.f, 1.f, myV, head_ptr(a.out2, a.sout2, b, h), a.sout2.l, row0, a.Lk,
                      D);
}

inline Args bwd_args(const void* q, const void* k, const void* v, const void* dout, int B, int H,
                     int Lq, int Lk, int D) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.B = B, a.H = H, a.Lq = Lq, a.Lk = Lk, a.D = D;
  return a;
}

}  // namespace ssdt

extern "C" {

// strides: 18 values, (batch, head, row) for q, k, v, o, dO, dq, in elements.
int ssdt_splash_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                   const long long* strides, void* stream) {
  using namespace ssdt;
  Args a = bwd_args(q, k, v, dout, B, H, Lq, Lk, D);
  a.o = static_cast<const bf16*>(o);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<float*>(delta);
  a.out = static_cast<bf16*>(dq);
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.so = {strides[9], strides[10], strides[11]};
  a.sdo = {strides[12], strides[13], strides[14]};
  a.sout = {strides[15], strides[16], strides[17]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ssdt_padded_dim(D)) {
#define SSDT_CASE(DP) \
  case DP:            \
    return launch_kernel(splash_dq_kernel<DP>, dq_smem_bytes<DP>(), Lq, kRows, kThreads, a, s);
    SSDT_FOR_EACH_DP(SSDT_CASE)
#undef SSDT_CASE
    default:
      return kErrHeadDim;
  }
}

// strides: 18 values, (batch, head, row) for q, k, v, dO, dk, dv, in elements.
int ssdt_splash_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Lq,
                    int Lk, int D, const long long* strides, void* stream) {
  using namespace ssdt;
  Args a = bwd_args(q, k, v, dout, B, H, Lq, Lk, D);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.out = static_cast<bf16*>(dk);
  a.out2 = static_cast<bf16*>(dv);
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.sdo = {strides[9], strides[10], strides[11]};
  a.sout = {strides[12], strides[13], strides[14]};
  a.sout2 = {strides[15], strides[16], strides[17]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ssdt_padded_dim(D)) {
#define SSDT_CASE(DP)                                                                   \
  case DP:                                                                              \
    return launch_kernel(splash_dkv_kernel<DP>, dkv_smem_bytes<DP>(), Lk, DkvShape<DP>::rows, \
                         DkvShape<DP>::threads, a, s);
    SSDT_FOR_EACH_DP(SSDT_CASE)
#undef SSDT_CASE
    default:
      return kErrHeadDim;
  }
}

}  // extern "C"
