// Splash-attention backward for Hopper (sm_90a), as two kernels with no
// atomics, matching the split (non-fused) backward of the TPU version
// (scal_sdt_tpu/ops/splash.py sets use_fused_bwd_kernel=False):
//
// * dq replaces `_splash_attention_bwd_dq` (`_flash_attention_dq_kernel`);
// * dkv replaces `_splash_attention_bwd_dkv` (`_flash_attention_dkv_kernel`).
//
// Both are warp-specialised, as the forward (splash_fwd.cu) is. One producer
// warp (of a producer warpgroup that hands its registers to the consumers by
// setmaxnreg) loads every tile by TMA into chunk-major shared tiles
// (splash_hopper.cuh) and signals it on an mbarrier; consumer warpgroups of
// 64 rows run every product as an asynchronous warpgroup wgmma (wgmma.cuh),
// keep their accumulators in registers, and free a ring stage by an mbarrier
// arrival.
//
// * dq: one CTA per (head, DqShape::rows query rows). The CTA's q and dO
//   rows arrive once; each consumer first sums delta = rowsum(dO * O) of its
//   rows (dO from shared memory, O by 16-byte loads) and stores it for dkv.
//   K / V tiles of 64 keys stream through a ring of stages. Per tile: S =
//   q k^T and dP = dO v^T (both operands from shared memory, both issued
//   before a wait), P = exp2(S log2 e - lse log2 e) in registers while dP
//   runs, dS = P (dP - delta) rounded to bf16 in registers as the A operand
//   of dq += dS k (k read MN-major from the same shared tile). dq stays fp32
//   in registers and is written once.
// * dkv: one CTA per (head, DkvShape::rows key rows); its k and v rows
//   arrive once (and, up to DP = 80, stay in registers as A fragments).
//   q / dO tiles stream through the ring with their -lse log2 e and delta,
//   which the producer warp writes beside them (-inf and 0 past Lq, so no
//   query past Lq counts and no lse or delta past Lq is read). Per tile:
//   S^T = k q^T and dP^T = v dO^T, P^T in registers while dP^T runs, dS^T =
//   P^T (dP^T - delta), then dV += P^T dO and dK += dS^T q in one group (dO,
//   q read MN-major). The two consumers take turns at issuing (Turns), so
//   one's exponentials run under the other's products. dK and dV stay fp32
//   in registers and are written once.
//
// What bounds them: 6 D (dq) and 8 D (dkv) tensor-core flops per
// exponential put the floor on the tensor cores at D = 64 (at D = 40 the
// exponentials and the fp32 work per score come close). The design this
// replaces (mma.sync fragments, cp.async, ldmatrix reads of every walked
// tile by every warp) ran at 16-22% of that floor, bound by the latency of its
// dependent mma chains. Here a product is one wgmma per k16 step for a
// whole warpgroup, read straight from shared memory; a warpgroup's
// exponentials overlap its own dP product and the other warpgroups'
// products; no thread spends registers or instructions on loads. What
// holds them above the floor now: the exponentials and fp32 work that
// neither overlap fully, and shared-memory reads of the score products
// (both operands at N = 64). Measured slower on an H100 and not kept: the
// next tile's score products issued before this tile's last product lands
// (it frees each ring stage a tile later), and dkv query tiles of 32 (128
// spill above DP = 48).
//
// Head dims off 16 run on the DP = round-up(D, 16) instance: the tile's
// chunks past D arrive as zeros by TMA's out-of-bounds fill (nothing extra
// is read from memory), products run over DP, columns past D are never
// stored. Rows past L arrive as zeros; keys past Lk are masked in dq,
// queries past Lq in dkv (a zero key scores 0, not -inf).
//
// dkv reads the delta that dq wrote, so the two launch in that order on one
// stream. Gradients are with respect to the pre-scaled q the forward saw;
// the caller's autograd applies the scale's chain rule.

#include "splash_hopper.cuh"

namespace ssdt {

// Launch shape of each instance, chosen on an H100 by time and by the
// ptxas report (scripts/sweep_dq_shapes.py): consumer warpgroups, keys per
// K/V tile, stages of the ring. Three consumers of 64 query rows where
// their 160 registers hold dq, the S and dP tiles and dS (DP <= 80); two
// above. Turns at issuing (as dkv takes them) measured no faster here, so
// dq takes none. q and dO stay in shared memory:
// held in registers (OperandA<..., true>) they gave a wrong dq on an H100 at
// DP = 64 with 64-key tiles (1.09 relative), though a right one at DP = 48
// and 80 and with 128-key tiles, for 6% at most; the cause is not found.
template <int DP>
struct DqShape {
  static constexpr int consumers = DP <= 80 ? 3 : 2, keys = 64, stages = 3;
  static constexpr int rows = consumers * kGroupRows, threads = (consumers + 1) * 128;
};

// Two consumers of 64 key rows up to DP = 96; above, where dK and dV alone
// take DP registers a thread, one consumer, and at DP = 160 query tiles of
// 32. `a_regs`: k and v, the A operands of S^T and dP^T, held in registers
// as k16 fragments (loaded once) instead of read from shared memory by
// every product; up to DP = 80, where they fit beside dK and dV. Two
// consumers take turns at issuing their products (Turns).
template <int DP>
struct DkvShape {
  static constexpr int consumers = DP <= 96 ? 2 : 1, queries = DP <= 128 ? 64 : 32;
  static constexpr int stages = DP <= 96 ? 3 : 2;
  static constexpr bool a_regs = DP <= 80;
  static constexpr int rows = consumers * kGroupRows, threads = (consumers + 1) * 128;
};

struct BwdArgs {
  const bf16* o;     // dq: the forward output, for delta
  const float* lse;  // (B, H, Lq) fp32 logsumexp of the forward
  float* delta;      // (B, H, Lq) fp32 rowsum(dO * O): written by dq, read by dkv
  bf16* out;         // dq: dq; dkv: dk
  bf16* out2;        // dkv: dv
  int H, Lq, Lk, D;
  Strides so, sout, sout2;
};

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

// ---------------------------------------------------------------------------
// dq

template <int DP>
constexpr size_t dq_smem_bytes() {
  using S = DqShape<DP>;
  // q and dO rows of the CTA, then the ring: K and V per stage; barriers
  return (size_t)(2 * S::rows + S::stages * 2 * S::keys) * DP * 2 + (1 + 2 * S::stages) * 8;
}

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::threads, 1)
    splash_dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdo, BwdArgs a) {
  using Shape = DqShape<DP>;
  constexpr int NC = Shape::consumers, QR = Shape::rows, KT = Shape::keys, ST = Shape::stages;
  constexpr uint32_t kRowsBytes = QR * DP * 2, kTileBytes = KT * DP * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sDO = sQ + kRowsBytes;
  unsigned char* sKV = sDO + kRowsBytes;  // stage s: K at 2s, V at 2s + 1
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sKV + ST * 2 * kTileBytes);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * QR;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D;
  const int ntiles = (Lk + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {  // producer
    producer_regs<NC>();
    if (threadIdx.x != NC * 128) return;
    prefetch_maps(mq, mk, mv, mdo);
    mbar_expect_tx(qdo_full, 2 * kRowsBytes);
    tma_load_5d(sQ, &mq, qdo_full, 0, q0, 0, h, b);
    tma_load_5d(sDO, &mdo, qdo_full, 0, q0, 0, h, b);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
      unsigned char* dst = sKV + s * 2 * kTileBytes;
      mbar_expect_tx(&full[s], 2 * kTileBytes);
      tma_load_5d(dst, &mk, &full[s], 0, j * KT, 0, h, b);
      tma_load_5d(dst + kTileBytes, &mv, &full[s], 0, j * KT, 0, h, b);
    }
    return;
  }

  consumer_regs<NC>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * kGroupRows + warp * 16;  // the warp's first row in the CTA's tile
  const unsigned char* myQ = sQ + wg * kGroupRows * 16;
  const unsigned char* myDO = sDO + wg * kGroupRows * 16;

  // -lse log2 e of rows g and g + 8 (0 past Lq: those rows have q = dO = 0,
  // so their dS is 0, and are never stored).
  const float* lse = a.lse + (long long)bh * Lq;
  const int rg = q0 + r0 + g;
  const float nl0 = rg < Lq ? -lse[rg] * kLog2e : 0.f;
  const float nl1 = rg + 8 < Lq ? -lse[rg + 8] * kLog2e : 0.f;

  mbar_wait(qdo_full, 0);
  OperandA<DP, QR, false> qa, doa;
  qa.load(myQ);
  doa.load(myDO);
  float dl0, dl1;
  {
    // delta = rowsum(dO * O) in fp32 over the bf16 values: lanes 2r and
    // 2r + 1 take row r of the warp's 16, each summing its 8-column chunks
    // (c = its parity, c + 2, ...) in order; then the pair adds its sums.
    const int row = lane >> 1, half = lane & 1, grow = q0 + r0 + row;
    float d = 0.f;
    if (grow < Lq) {
      const bf16* orow = a.o + b * a.so.b + h * a.so.h + (long long)grow * a.so.l;
      for (int c = half; c < (D >> 3); c += 2)
        d = dot8_bf16(*reinterpret_cast<const uint4*>(orow + c * 8),
                      *reinterpret_cast<const uint4*>(sDO + (c * QR + r0 + row) * 16), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0 && grow < Lq) a.delta[(long long)bh * Lq + grow] = d;
    dl0 = __shfl_sync(0xffffffffu, d, 2 * g);
    dl1 = __shfl_sync(0xffffffffu, d, 2 * g + 16);
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % ST;
    mbar_wait(&full[s], (j / ST) & 1);
    const unsigned char* sK = sKV + s * 2 * kTileBytes;
    const unsigned char* sV = sK + kTileBytes;

    // S = q k^T and dP = dO v^T: rows g, g + 8 of the warp x keys 8n + 2t, +1.
    float p[KT / 2], dp[KT / 2];
    wgmma_fence();
    qa.template times_bt<KT>(p, sK);
    wgmma_commit();
    doa.template times_bt<KT>(dp, sV);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(p);

    const int k0 = j * KT;
    if (k0 + KT > Lk) {  // the last tile: keys past Lk get P = 0
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int col = k0 + n * 8 + 2 * t;
        if (col >= Lk) p[4 * n] = p[4 * n + 2] = -INFINITY;
        if (col + 1 >= Lk) p[4 * n + 1] = p[4 * n + 3] = -INFINITY;
      }
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      p[4 * n] = exp2_approx(fmaf(p[4 * n], kLog2e, nl0));
      p[4 * n + 1] = exp2_approx(fmaf(p[4 * n + 1], kLog2e, nl0));
      p[4 * n + 2] = exp2_approx(fmaf(p[4 * n + 2], kLog2e, nl1));
      p[4 * n + 3] = exp2_approx(fmaf(p[4 * n + 3], kLog2e, nl1));
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t ds[KT / 16][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
      pack_frag<KT>(ds, n, p[4 * n] * (dp[4 * n] - dl0), p[4 * n + 1] * (dp[4 * n + 1] - dl0),
                    p[4 * n + 2] * (dp[4 * n + 2] - dl1), p[4 * n + 3] * (dp[4 * n + 3] - dl1));

    fence_regs(dq);
    wgmma_fence();
    gemm_pw<DP, KT>(dq, ds, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[s]);
  }

  store_rows<DP>(dq, a.out + b * a.sout.b + h * a.sout.h, a.sout.l, q0 + r0 + g, Lq, D);
}

// ---------------------------------------------------------------------------
// dkv

template <int DP>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  using S = DkvShape<DP>;
  return (size_t)2 * S::queries * DP * 2 + 2 * S::queries * 4;  // q, dO, -lse log2 e, delta
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  using S = DkvShape<DP>;
  return (size_t)2 * S::rows * DP * 2 + S::stages * dkv_stage_bytes<DP>() + (1 + 2 * S::stages) * 8;
}

template <int DP>
__global__ void __launch_bounds__(DkvShape<DP>::threads, 1)
    splash_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo, BwdArgs a) {
  using Shape = DkvShape<DP>;
  constexpr int NC = Shape::consumers, KR = Shape::rows, QT = Shape::queries;
  constexpr int ST = Shape::stages;
  constexpr uint32_t kRowsBytes = KR * DP * 2, kTileBytes = QT * DP * 2;
  constexpr uint32_t kStageBytes = dkv_stage_bytes<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = sK + kRowsBytes;
  unsigned char* sStages = sV + kRowsBytes;  // per stage: q, dO, -lse log2 e, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sStages + ST * kStageBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * KR;
  const int Lq = a.Lq;
  const int ntiles = (Lq + QT - 1) / QT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes: row values, then the TMA
      mbar_init(&empty[s], NC * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {  // producer
    producer_regs<NC>();
    if ((threadIdx.x >> 5) != NC * 4) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      prefetch_maps(mq, mk, mv, mdo);
      mbar_expect_tx(kv_full, 2 * kRowsBytes);
      tma_load_5d(sK, &mk, kv_full, 0, k0, 0, h, b);
      tma_load_5d(sV, &mv, kv_full, 0, k0, 0, h, b);
    }
    const float* lse = a.lse + (long long)bh * Lq;
    const float* delta = a.delta + (long long)bh * Lq;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
      unsigned char* st = sStages + s * kStageBytes;
      float* nl = reinterpret_cast<float*>(st + 2 * kTileBytes);
      float* dl = nl + QT;
      for (int i = lane; i < QT; i += 32) {
        const int row = j * QT + i;
        nl[i] = row < Lq ? -lse[row] * kLog2e : -INFINITY;
        dl[i] = row < Lq ? delta[row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_5d(st, &mq, &full[s], 0, j * QT, 0, h, b);
        tma_load_5d(st + kTileBytes, &mdo, &full[s], 0, j * QT, 0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  consumer_regs<NC>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* myK = sK + wg * kGroupRows * 16;
  const unsigned char* myV = sV + wg * kGroupRows * 16;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  OperandA<DP, KR, Shape::a_regs> ka, va;
  ka.load(myK);
  va.load(myV);
  const Turns<NC> turns(wg);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % ST;
    mbar_wait(&full[s], (j / ST) & 1);
    const unsigned char* sQ = sStages + s * kStageBytes;
    const unsigned char* sDO = sQ + kTileBytes;
    const float* nl = reinterpret_cast<const float*>(sQ + 2 * kTileBytes);
    const float* dl = nl + QT;

    // S^T = k q^T and dP^T = v dO^T: keys g, g + 8 of the warp x queries
    // 8n + 2t, +1.
    float st[QT / 2], dpt[QT / 2];
    turns.take();
    wgmma_fence();
    ka.template times_bt<QT>(st, sQ);
    wgmma_commit();
    va.template times_bt<QT>(dpt, sDO);
    wgmma_commit();
    turns.pass(false);
    wgmma_wait<1>();
    fence_regs(st);

    uint32_t pa[QT / 16][4];  // P^T as k16 A fragments over the tile's queries
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(nl + n * 8 + 2 * t);
      st[4 * n] = exp2_approx(fmaf(st[4 * n], kLog2e, l.x));
      st[4 * n + 1] = exp2_approx(fmaf(st[4 * n + 1], kLog2e, l.y));
      st[4 * n + 2] = exp2_approx(fmaf(st[4 * n + 2], kLog2e, l.x));
      st[4 * n + 3] = exp2_approx(fmaf(st[4 * n + 3], kLog2e, l.y));
      pack_frag<QT>(pa, n, st[4 * n], st[4 * n + 1], st[4 * n + 2], st[4 * n + 3]);
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t da[QT / 16][4];  // dS^T likewise
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(dl + n * 8 + 2 * t);
      pack_frag<QT>(da, n, st[4 * n] * (dpt[4 * n] - d.x), st[4 * n + 1] * (dpt[4 * n + 1] - d.y),
                    st[4 * n + 2] * (dpt[4 * n + 2] - d.x),
                    st[4 * n + 3] * (dpt[4 * n + 3] - d.y));
    }

    // dV += P^T dO and dK += dS^T q.
    fence_regs(dv);
    fence_regs(dk);
    turns.take();
    wgmma_fence();
    gemm_pw<DP, QT>(dv, pa, sDO);
    gemm_pw<DP, QT>(dk, da, sQ);
    wgmma_commit();
    turns.pass(j == ntiles - 1);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[s]);
  }

  // Key rows past Lk (k = v = 0) are never written.
  const int row = k0 + wg * kGroupRows + warp * 16 + g;
  store_rows<DP>(dk, a.out + b * a.sout.b + h * a.sout.h, a.sout.l, row, a.Lk, a.D);
  store_rows<DP>(dv, a.out2 + b * a.sout2.b + h * a.sout2.h, a.sout2.l, row, a.Lk, a.D);
}

// ---------------------------------------------------------------------------
// Launch

struct Maps {
  CUtensorMap q, k, v, dout;
};

// Encode the four tile maps (geo: 9 values per map, q k v dO): q and dO
// with boxes of `q_rows` rows, k and v of `k_rows`.
template <int DP>
bool encode_maps(Maps& m, const void* const* ptrs, const long long* geo, int q_rows,
                 int k_rows) {
  return encode_tile_map(&m.q, ptrs[0], geo, q_rows, DP / 8) &&
         encode_tile_map(&m.k, ptrs[1], geo + 9, k_rows, DP / 8) &&
         encode_tile_map(&m.v, ptrs[2], geo + 18, k_rows, DP / 8) &&
         encode_tile_map(&m.dout, ptrs[3], geo + 27, q_rows, DP / 8);
}

// ptrs: q, k, v, dO; q_rows, k_rows: their boxes' rows.
template <int DP, int NC, typename Kernel>
int launch_bwd(Kernel kernel, size_t smem, int rows, int rows_per_cta, int threads, int BH,
               const void* const* ptrs, const long long* geo, int q_rows, int k_rows,
               const BwdArgs& a, cudaStream_t stream) {
  int err = ready_kernel<NC>(kernel, smem);
  if (err != 0) return err;
  Maps m;
  if (!encode_maps<DP>(m, ptrs, geo, q_rows, k_rows)) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, BH);
  kernel<<<grid, threads, smem, stream>>>(m.q, m.k, m.v, m.dout, a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const void* const* ptrs, const long long* geo, const BwdArgs& a, int BH,
              cudaStream_t s) {
  using S = DqShape<DP>;
  return launch_bwd<DP, S::consumers>(splash_dq_kernel<DP>, dq_smem_bytes<DP>(), a.Lq, S::rows,
                                      S::threads, BH, ptrs, geo, S::rows, S::keys, a, s);
}

template <int DP>
int launch_dkv(const void* const* ptrs, const long long* geo, const BwdArgs& a, int BH,
               cudaStream_t s) {
  using S = DkvShape<DP>;
  return launch_bwd<DP, S::consumers>(splash_dkv_kernel<DP>, dkv_smem_bytes<DP>(), a.Lk,
                                      S::rows, S::threads, BH, ptrs, geo, S::queries, S::rows,
                                      a, s);
}

}  // namespace ssdt

extern "C" {

// strides: 6 values, (batch, head, row) for o and dq, in elements.
// geo: 36 values, tma_geometry of q, k, v, dO (ops/splash.py).
int ssdt_splash_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                   const long long* strides, const long long* geo, void* stream) {
  using namespace ssdt;
  BwdArgs a{};
  a.o = static_cast<const bf16*>(o);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.out = static_cast<bf16*>(dq);
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.D = D;
  a.so = {strides[0], strides[1], strides[2]};
  a.sout = {strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {q, k, v, dout};
  switch (ssdt_padded_dim(D)) {
#define SSDT_CASE(DP) \
  case DP:            \
    return launch_dq<DP>(ptrs, geo, a, B * H, s);
    SSDT_FOR_EACH_DP(SSDT_CASE)
#undef SSDT_CASE
    default:
      return kErrHeadDim;
  }
}

// strides: 6 values, (batch, head, row) for dk and dv, in elements.
// geo: 36 values, tma_geometry of q, k, v, dO (ops/splash.py).
int ssdt_splash_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Lq,
                    int Lk, int D, const long long* strides, const long long* geo, void* stream) {
  using namespace ssdt;
  BwdArgs a{};
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.out = static_cast<bf16*>(dk);
  a.out2 = static_cast<bf16*>(dv);
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.D = D;
  a.sout = {strides[0], strides[1], strides[2]};
  a.sout2 = {strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {q, k, v, dout};
  switch (ssdt_padded_dim(D)) {
#define SSDT_CASE(DP) \
  case DP:            \
    return launch_dkv<DP>(ptrs, geo, a, B * H, s);
    SSDT_FOR_EACH_DP(SSDT_CASE)
#undef SSDT_CASE
    default:
      return kErrHeadDim;
  }
}

}  // extern "C"
