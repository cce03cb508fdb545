// Splash-attention backward for Hopper, as two kernels with no atomics,
// matching the split (non-fused) backward of the TPU version
// (scal_sdt_tpu/ops/splash.py sets use_fused_bwd_kernel=False). Both are on
// the register-tile design of splash_common.cuh: a CTA holds rows of one
// operand, 16 per warp, and walks the other through cp.async buffers.
//
// * dq replaces `_splash_attention_bwd_dq` (`_flash_attention_dq_kernel`):
//   one CTA per (head, DqShape::rows query rows). A warp first sums delta =
//   rowsum(dO * O) of its rows (dO from shared memory, O by 16-byte loads)
//   and stores it for dkv; then it keeps its q and dO rows as A fragments
//   and its lse and delta in registers. K / V tiles (DqShape::keys keys)
//   stream through a cp.async ring. Per tile: S = q k^T (mma.sync, k by
//   ldmatrix) and P = exp2(S log2 e - lse log2 e) over the whole tile; then
//   per 16 keys dP = dO v^T (v by ldmatrix) and dS = P (dP - delta) in
//   registers, rounded to bf16 in registers as the A operand of dq += dS k
//   (k by ldmatrix.trans from the same shared tile). Only P lives across
//   the tile, so at D = 40 a 64-key tile fits beside the fragments in the
//   registers of 16 warps per SM. dq stays fp32 in registers and is written
//   once. Only the last KV tile masks keys past Lk.
// * dkv replaces `_splash_attention_bwd_dkv`: one CTA per (head, 64 or 128
//   key rows), 16 key rows per warp (DkvShape). A warp keeps its k and v rows
//   as A fragments in registers (up to DP = 96; wider instances reload them
//   from the warp's own shared rows per step, so that dK / dV fit). q / dO
//   tiles of 64 queries, with their lse and delta, come by cp.async double
//   buffering. Per step of 32 (or 16) queries: S^T = k q^T and dP^T = v dO^T
//   (q and dO by ldmatrix), P^T = exp2(S^T log2 e - lse log2 e) and dS^T =
//   P^T (dP^T - delta) in registers, rounded to bf16 in registers as the A
//   operands of dV += P^T dO and dK += dS^T q (dO, q by ldmatrix.trans). dK
//   and dV stay fp32 in registers and are written once. Only the last query
//   tile masks queries past Lq.
//
// What bounds them: 6 D (dq) and 8 D (dkv) tensor-core flops per
// exponential put their floor on the tensor cores, but they run far above
// it, bound by the latency of their dependent mma chains: measured on an
// H100, their time falls with every warp more per SM, so the shapes trade
// tile rows for CTAs per SM within the registers. Every warp also reads each
// walked tile from shared memory twice (plain and transposed).
//
// dkv reads the delta that dq wrote, so the two launch in that order on one
// stream. Gradients are with respect to the pre-scaled q the forward saw;
// the caller's autograd applies the scale's chain rule.

#include "splash_common.cuh"

namespace ssdt {

// ---------------------------------------------------------------------------
// dq: register tiles

// Launch shape of each instance, chosen on an H100 by time and by the ptxas
// report (no spill up to DP = 160; scripts/sweep_dq_shapes.py): warps per
// CTA (16 query rows each), keys per KV tile, keys per dP / dS step, stages
// of the KV ring and the CTAs per SM the registers must allow. The kernel is
// latency-bound, so warps per SM matter most: up to DP = 64, 16 warps in
// 128 registers each; at DP = 48 only 16-key steps keep a 64-key tile in
// them. At DP = 80 such CTAs spill, so 3 CTAs of 4 warps.
template <int DP>
struct DqShape {
  static constexpr int warps = DP <= 64 ? 8 : 4;
  static constexpr int keys = DP <= 48 ? 64 : 32;
  static constexpr int step = 16;
  static constexpr int stages = 3;
  static constexpr int min_blocks = DP <= 64 ? 2 : (DP <= 80 ? 3 : (DP <= 96 ? 2 : 1));
  static constexpr int threads = warps * 32, rows = warps * kWarpRows;
};

template <int DP>
constexpr size_t dq_smem_bytes() {
  using Shape = DqShape<DP>;
  // q and dO rows of the CTA, then the ring: stage s holds K at 2s, V at 2s + 1
  return (size_t)(2 * Shape::rows + Shape::stages * 2 * Shape::keys) * Tile<DP>::ld *
         sizeof(bf16);
}

// acc + x . y over 8 bf16 pairs, in order (each product is exact in fp32).
__device__ __forceinline__ float dot8_bf16(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xs[i]), b = __bfloat1622float2(ys[i]);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::threads, DqShape<DP>::min_blocks)
    splash_dq_kernel(Args a) {
  using Shape = DqShape<DP>;
  constexpr int kThreads = Shape::threads, kRows = Shape::rows, kKeys = Shape::keys;
  constexpr int kStages = Shape::stages, kStep = Shape::step;
  constexpr int LD = Tile<DP>::ld, NT = DP / 8, SN = kKeys / 8;
  constexpr int kTileElems = kKeys * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kRows * LD;
  bf16* sKV = sDO + kRows * LD;  // stage s: K at 2s, V at 2s + 1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kRows;
  const int D = a.D, Lq = a.Lq, Lk = a.Lk;
  const bf16* k = head_ptr(a.k, a.sk, b, h);
  const bf16* v = head_ptr(a.v, a.sv, b, h);
  const int ntiles = (Lk + kKeys - 1) / kKeys;

  auto load_kv = [&](int j) {
    bf16* dst = sKV + (j % kStages) * 2 * kTileElems;
    load_tile_async<kKeys, DP, kThreads>(dst, k, a.sk.l, j * kKeys, Lk, D);
    load_tile_async<kKeys, DP, kThreads>(dst + kTileElems, v, a.sv.l, j * kKeys, Lk, D);
  };
  load_tile_async<kRows, DP, kThreads>(sQ, head_ptr(a.q, a.sq, b, h), a.sq.l, q0, Lq, D);
  load_tile_async<kRows, DP, kThreads>(sDO, head_ptr(a.dout, a.sdo, b, h), a.sdo.l, q0, Lq, D);
  load_kv(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  const int r0 = q0 + warp * kWarpRows;  // the warp's first query row
  bf16* myQ = sQ + warp * kWarpRows * LD;
  const bf16* myDO = sDO + warp * kWarpRows * LD;
  // Rows g and g + 8 of the warp's 16: -lse log2 e and delta. Rows past Lq
  // hold q = dO = 0 and lse = delta = 0, so their dS is 0.
  const float* lse = a.lse + (long long)bh * Lq;
  const float nl0 = r0 + g < Lq ? -lse[r0 + g] * kLog2e : 0.f;
  const float nl1 = r0 + g + 8 < Lq ? -lse[r0 + g + 8] * kLog2e : 0.f;

  cp_async_wait<kStages - 2>();  // q and dO (and KV tile 0) landed for this thread
  __syncthreads();               // ... for all
  float dl0, dl1;
  {
    // delta = rowsum(dO * O) in fp32 over the bf16 values: lanes 2r and
    // 2r + 1 take row r, each summing its 8-element chunks (c = its parity,
    // c + 2, ...) in order; then the pair adds its two sums.
    const int row = lane >> 1, half = lane & 1, grow = r0 + row;
    float d = 0.f;
    if (grow < Lq) {
      const bf16* orow = head_ptr(a.o, a.so, b, h) + (long long)grow * a.so.l;
      for (int c = half; c < (D >> 3); c += 2)
        d = dot8_bf16(*reinterpret_cast<const uint4*>(orow + c * 8),
                      *reinterpret_cast<const uint4*>(myDO + row * LD + c * 8), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0 && grow < Lq) a.delta[(long long)bh * Lq + grow] = d;
    dl0 = __shfl_sync(0xffffffffu, d, 2 * g);
    dl1 = __shfl_sync(0xffffffffu, d, 2 * g + 16);
  }
  uint32_t qf[DP / 16][4], df[DP / 16][4];
  load_a_frags<DP>(qf, myQ, D);
  load_a_frags<DP>(df, myDO, D);

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j landed for this thread
    __syncthreads();               // ... for all; tile j - 1's slot is free
    if (j + kStages - 1 < ntiles) load_kv(j + kStages - 1);
    cp_async_commit();

    const bf16* sK = sKV + (j % kStages) * 2 * kTileElems;
    const bf16* sV = sK + kTileElems;
    // P over the whole tile: query rows g, g + 8 of the warp's 16 x keys
    // 8 n + 2t, +1.
    float p[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    mma_abt<DP, SN>(p, qf, sK, D);

    const int k0 = j * kKeys;
    if (k0 + kKeys > Lk) {  // the last tile: keys past Lk get P = 0
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        const int col = k0 + n * 8 + 2 * t;
        if (col >= Lk) p[n][0] = p[n][2] = -INFINITY;
        if (col + 1 >= Lk) p[n][1] = p[n][3] = -INFINITY;
      }
    }
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      p[n][0] = exp2_approx(fmaf(p[n][0], kLog2e, nl0));
      p[n][1] = exp2_approx(fmaf(p[n][1], kLog2e, nl0));
      p[n][2] = exp2_approx(fmaf(p[n][2], kLog2e, nl1));
      p[n][3] = exp2_approx(fmaf(p[n][3], kLog2e, nl1));
    }

    // dP, dS and dq += dS k one step of kStep keys at a time, so that only
    // P stays live over the whole tile.
#pragma unroll
    for (int c = 0; c < kKeys; c += kStep) {
      float dp[kStep / 8][4] = {};
      mma_abt<DP, kStep / 8>(dp, df, sV + c * LD, D);
      uint32_t ds[kStep / 16][4];  // dS as k16 A fragments over the step's keys
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n) {
        const float(&pn)[4] = p[c / 8 + n];
        // n8 tile n: the low (n even) or high half of k16 step n / 2.
        ds[n / 2][(n & 1) * 2] = pack_bf16(pn[0] * (dp[n][0] - dl0), pn[1] * (dp[n][1] - dl0));
        ds[n / 2][(n & 1) * 2 + 1] =
            pack_bf16(pn[2] * (dp[n][2] - dl1), pn[3] * (dp[n][3] - dl1));
      }
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        mma_pw<DP>(dq, ds[kk], sK + (c + kk * 16) * LD, D);
    }
  }

  // Query rows past Lq are never written; the warp's own q rows stage dq.
  __syncwarp();
  warp_store_rows<DP>(dq, 1.f, 1.f, myQ, head_ptr(a.out, a.sout, b, h), a.sout.l, r0, Lq, D);
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
#define SSDT_CASE(DP)                                                                          \
  case DP:                                                                                     \
    return launch_kernel(splash_dq_kernel<DP>, dq_smem_bytes<DP>(), Lq, DqShape<DP>::rows, \
                         DqShape<DP>::threads, a, s);
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
