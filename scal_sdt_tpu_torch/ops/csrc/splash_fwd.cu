// Splash-attention forward for Hopper (sm_90a): O = softmax(q k^T) v and the
// logsumexp residual. Replaces the TPU forward kernel
// (splash_attention_kernel.py `_splash_attention_forward`, reached from
// scal_sdt_tpu/ops/splash.py `splash_attention` and, with keys past the valid
// length masked, `splash_attention_padded`).
//
// Design: warp-specialised, as the backward (splash_bwd.cu). One CTA per
// (head, FwdShape::rows query rows). One producer warp, of a producer
// warpgroup that hands its registers to the consumers by setmaxnreg,
// TMA-loads each consumer's 64 query rows once, then K and V tiles of
// FwdShape::keys rows through a ring of stages, each a chunk-major box
// (splash_hopper.cuh) under a full and an empty mbarrier. Consumer
// warpgroups of 64 query rows, per tile: S = q k^T as one wgmma per k16 step
// over the head dim, both operands read from shared memory; keys past Lk
// masked to -inf on the last tile (a zero key would score 0); the online
// softmax on the accumulator fragment (row max and sum over a quad's lanes,
// p = exp2(S log2 e - m log2 e) as one FFMA and one MUFU.EX2 per score); P
// rounded to bf16 in registers as the A operand of O += P v, v read MN-major
// from the same tile; O stays fp32 in registers, rescaled by each tile's
// change of the row max. A group issues S of tile j together with P v of
// tile j - 1, so its exponentials of tile j run under its own product of
// tile j - 1, and the consumers take turns at issuing (Turns), so one
// group's exponentials also run under the others' products.
// Epilogue: O / l rounded to bf16 into the group's own q rows of shared
// memory and written by one TMA store (rows past Lq and columns past D are
// not written); lse = m + log l per row. One CTA owns each output row, so a
// second launch gives the same bits (on one card: the launch shape, and
// with it the order of the sums, follows the card's SM count).
//
// What bounds it: B*H*Lq*Lk exponentials at 16 per clock per SM against
// 4 D tensor-core flops per score. At D <= 48 the exponential unit is the
// floor; at D = 64 the two are close. The design keeps both busy at once:
// no consumer waits for loads (TMA, a ring of stages), and exponentials
// overlap products within a group (early issue) and across groups (turns).
// On an H100 that reaches 43-50% of the floor at the main path's long
// forms. What holds it there: the FFMA, max, sum and bf16 packing of every
// score on the CUDA cores beside the exponential, and one CTA per SM, so a
// grid's last wave idles SMs (the narrow shape trims that at grids of 1-2
// waves). Measured slower on an H100 and not kept: each tile's two
// products issued in turn, no turns between consumers, two stages.

#include "splash_hopper.cuh"

namespace ssdt {

// Consumer warpgroups of each instance's two launch shapes, chosen on an
// H100 by time and by the ptxas report (scripts/sweep_dq_shapes.py): wide,
// the most consumers whose registers hold their tiles without a spill, and
// narrow, one fewer. A wide CTA's rows cost 10-20% less each, but where its
// grid's last wave would leave most SMs idle the narrow grid ends first
// (launch_fwd picks).
template <int DP>
struct FwdConsumers {
  static constexpr int wide = DP == 64 ? 4 : (DP <= 80 ? 3 : 2), narrow = wide - 1;
};

// A launch shape: NC consumer warpgroups of 64 query rows; keys per K/V
// tile, 128 up to DP = 64 where a consumer thread's registers hold O (DP / 2
// fp32), S (keys / 2) and P (keys / 4) with 32 to spare, else 64; stages of
// the ring.
template <int DP, int NC>
struct FwdShape {
  static constexpr int consumers = NC;
  static constexpr int keys = DP <= 64 && DP / 2 + 128 <= Regs<NC>::consumer ? 128 : 64;
  static constexpr int stages = DP <= 64 ? 4 : 3;
  static constexpr int rows = consumers * kGroupRows, threads = (consumers + 1) * 128;
};

struct FwdArgs {
  float* lse;  // (B, H, Lq) fp32
  int H, Lq, Lk;
};

template <int DP, int NC>
constexpr size_t fwd_smem_bytes() {
  using S = FwdShape<DP, NC>;
  // each consumer's q rows (its O tile at the end), then the ring: K and V
  // per stage; barriers
  return (size_t)(S::rows + S::stages * 2 * S::keys) * DP * 2 +
         (S::consumers + 2 * S::stages) * 8;
}

// The running softmax of one consumer thread's rows g and g + 8: the row
// max (natural units) and this lane's part of the row sum.
struct RowSoftmax {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // A tile's scores s (keys k0.., rows g, g + 8 x keys 8n + 2t, +1) to
  // p = exp2(s log2 e - m log2 e) in place, m the new running max; keys past
  // Lk count as -inf. a0, a1: the factor on what was summed before.
  template <int KT>
  __device__ __forceinline__ void step(float (&s)[KT / 2], int k0, int Lk, float& a0, float& a1) {
    const int t = threadIdx.x & 3;
    if (k0 + KT > Lk) {  // the last tile
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int col = k0 + n * 8 + 2 * t;
        if (col >= Lk) s[4 * n] = s[4 * n + 2] = -INFINITY;
        if (col + 1 >= Lk) s[4 * n + 1] = s[4 * n + 3] = -INFINITY;
      }
    }
    // The row max is finite: key k0 < Lk is in every tile.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    a0 = exp2_approx((m0 - mx0) * kLog2e);  // 0 on the first tile
    a1 = exp2_approx((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    const float nm0 = -mx0 * kLog2e, nm1 = -mx1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      s[4 * n] = exp2_approx(fmaf(s[4 * n], kLog2e, nm0));
      s[4 * n + 1] = exp2_approx(fmaf(s[4 * n + 1], kLog2e, nm0));
      s[4 * n + 2] = exp2_approx(fmaf(s[4 * n + 2], kLog2e, nm1));
      s[4 * n + 3] = exp2_approx(fmaf(s[4 * n + 3], kLog2e, nm1));
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  }
};

// O *= the tile's factors, then P (the tile's probabilities) packed as bf16
// k16 fragments over its keys.
template <int DP, int KT>
__device__ __forceinline__ void rescale_and_pack(float (&o)[DP / 2], uint32_t (&pf)[KT / 16][4],
                                                 const float (&p)[KT / 2], float a0, float a1) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    o[4 * n] *= a0;
    o[4 * n + 1] *= a0;
    o[4 * n + 2] *= a1;
    o[4 * n + 3] *= a1;
  }
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
    pack_frag<KT>(pf, n, p[4 * n], p[4 * n + 1], p[4 * n + 2], p[4 * n + 3]);
}

template <int DP, int NC>
__global__ void __launch_bounds__(FwdShape<DP, NC>::threads, 1)
    splash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mo, FwdArgs a) {
  using Shape = FwdShape<DP, NC>;
  constexpr int KT = Shape::keys, ST = Shape::stages;
  constexpr uint32_t kGroupBytes = kGroupRows * DP * 2, kTileBytes = KT * DP * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;                    // consumer w's q rows at w * kGroupBytes
  unsigned char* sKV = sQ + NC * kGroupBytes;  // stage s: K at 2s, V at 2s + 1
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + ST * 2 * kTileBytes);
  uint64_t* full = q_full + NC;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * Shape::rows;
  const int Lk = a.Lk;
  const int ntiles = (Lk + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int w = 0; w < NC; ++w) mbar_init(&q_full[w], 1);
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
    prefetch_maps(mq, mk, mv, mo);
    for (int w = 0; w < NC; ++w) {
      mbar_expect_tx(&q_full[w], kGroupBytes);
      tma_load_5d(sQ + w * kGroupBytes, &mq, &q_full[w], 0, q0 + w * kGroupRows, 0, h, b);
    }
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
  unsigned char* myQ = sQ + wg * kGroupBytes;
  OperandA<DP, kGroupRows, false> qa;
  qa.load(myQ);
  auto tile = [&](int j) { return sKV + (j % ST) * 2 * kTileBytes; };  // K; V at + kTileBytes

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float s[KT / 2];         // S of a tile, then its probabilities
  uint32_t pf[KT / 16][4];  // P as k16 A fragments over the tile's keys
  RowSoftmax sm;
  float a0, a1;
  const Turns<NC> turns(wg);
  mbar_wait(&q_full[wg], 0);

  // Tile 0: S alone. Tiles 1..: S of tile j with P v of tile j - 1; the
  // last turn: P v of the last tile alone.
  mbar_wait(&full[0], 0);
  turns.take();
  wgmma_fence();
  qa.template times_bt<KT>(s, tile(0));
  wgmma_commit();
  turns.pass(false);
  wgmma_wait<0>();
  fence_regs(s);
  sm.step<KT>(s, 0, Lk, a0, a1);
  rescale_and_pack<DP, KT>(o, pf, s, a0, a1);
  for (int j = 1; j < ntiles; ++j) {
    mbar_wait(&full[j % ST], (j / ST) & 1);
    fence_regs(o);
    turns.take();
    wgmma_fence();
    qa.template times_bt<KT>(s, tile(j));
    wgmma_commit();
    gemm_pw<DP, KT>(o, pf, tile(j - 1) + kTileBytes);
    wgmma_commit();
    turns.pass(false);
    wgmma_wait<1>();
    fence_regs(s);
    sm.step<KT>(s, j * KT, Lk, a0, a1);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[(j - 1) % ST]);
    rescale_and_pack<DP, KT>(o, pf, s, a0, a1);
  }
  fence_regs(o);
  turns.take();
  wgmma_fence();
  gemm_pw<DP, KT>(o, pf, tile(ntiles - 1) + kTileBytes);
  wgmma_commit();
  turns.pass(true);
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(&empty[(ntiles - 1) % ST]);

  float l0 = sm.l0, l1 = sm.l1;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // l >= 1: the row max contributes exp(0).
  const int r = warp * 16 + g, row = q0 + wg * kGroupRows + r;
  if (t == 0) {
    float* lse = a.lse + (long long)bh * a.Lq;
    if (row < a.Lq) lse[row] = sm.m0 + logf(l0);
    if (row + 8 < a.Lq) lse[row + 8] = sm.m1 + logf(l1);
  }
  // O / l as bf16 over the group's q rows (their products are done), then
  // one TMA store of the group's 64 rows.
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  named_bar_sync(NC + 1 + wg, 128);
  unsigned char* out = myQ + r * 16 + 4 * t;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(out + n * kGroupRows * 16) =
        pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(out + n * kGroupRows * 16 + 128) =
        pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  fence_async_smem();
  named_bar_sync(NC + 1 + wg, 128);
  if (tid == 0) {
    tma_store_5d(&mo, myQ, 0, q0 + wg * kGroupRows, 0, h, b);
    tma_store_wait_read();
  }
}

// geo: 36 values, the tile maps' geometry of q, k, v and o; ptrs: the same.
template <int DP, int NC>
int launch_shape(const void* const* ptrs, const long long* geo, const FwdArgs& a, int BH,
                 cudaStream_t stream) {
  using S = FwdShape<DP, NC>;
  const size_t smem = fwd_smem_bytes<DP, NC>();
  int err = ready_kernel<NC>(splash_fwd_kernel<DP, NC>, smem);
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mo;
  if (!(encode_tile_map(&mq, ptrs[0], geo, kGroupRows, DP / 8) &&
        encode_tile_map(&mk, ptrs[1], geo + 9, S::keys, DP / 8) &&
        encode_tile_map(&mv, ptrs[2], geo + 18, S::keys, DP / 8) &&
        encode_tile_map(&mo, ptrs[3], geo + 27, kGroupRows, DP / 8)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Lq + S::rows - 1) / S::rows, BH);
  splash_fwd_kernel<DP, NC><<<grid, S::threads, smem, stream>>>(mq, mk, mv, mo, a);
  return (int)cudaGetLastError();
}

// The rows a grid of CTAs of `rows` query rows gives each SM in turn: waves
// over `sms` SMs times the rows of a CTA (its time, up to a cost per row).
inline long long rows_per_sm(int Lq, int BH, int rows, int sms) {
  const long long ctas = (long long)((Lq + rows - 1) / rows) * BH;
  return (ctas + sms - 1) / sms * rows;
}

// The launch shape whose grid ends first, a narrow CTA's row taken as 15%
// dearer than a wide one's (measured on an H100 at DP = 48-80).
template <int DP>
int launch_fwd(const void* const* ptrs, const long long* geo, const FwdArgs& a, int BH,
               cudaStream_t stream) {
  using C = FwdConsumers<DP>;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (100 * rows_per_sm(a.Lq, BH, FwdShape<DP, C::wide>::rows, sms) >
      115 * rows_per_sm(a.Lq, BH, FwdShape<DP, C::narrow>::rows, sms))
    return launch_shape<DP, C::narrow>(ptrs, geo, a, BH, stream);
  return launch_shape<DP, C::wide>(ptrs, geo, a, BH, stream);
}

}  // namespace ssdt

extern "C" {

// geo: 36 values, tma_geometry of q, k, v and o (ops/splash.py).
int ssdt_splash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                    int H, int Lq, int Lk, int D, const long long* geo, void* stream) {
  using namespace ssdt;
  FwdArgs a{};
  a.lse = static_cast<float*>(lse);
  a.H = H, a.Lq = Lq, a.Lk = Lk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {q, k, v, o};
  switch (ssdt_padded_dim(D)) {
#define SSDT_CASE(DP) \
  case DP:            \
    return launch_fwd<DP>(ptrs, geo, a, B * H, s);
    SSDT_FOR_EACH_DP(SSDT_CASE)
#undef SSDT_CASE
    default:
      return kErrHeadDim;
  }
}

const char* ssdt_error_string(int err) {
  if (err == ssdt::kErrHeadDim) return "head dim has no compiled splash instance";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
