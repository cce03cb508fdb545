// Splash-attention forward for Hopper: O = softmax(q k^T) v and the
// logsumexp residual. Replaces the TPU forward kernel
// (splash_attention_kernel.py `_splash_attention_forward`, reached from
// scal_sdt_tpu/ops/splash.py `splash_attention`).
//
// Design (register tiles, see splash_common.cuh): grid (ceil(Lq / 128),
// B * H); 8 warps, each owning 16 query rows end to end, 2 CTAs per SM up to
// DP = 80. A warp loads its q fragments once and keeps them in registers.
// K / V tiles of 64 keys (32 at DP = 80, where a 64-key score tile does not
// fit in 128 registers beside the accumulators) stream through a 3-stage
// cp.async ring. Per tile and warp: S = q k^T as n8 accumulator tiles; the
// online softmax in registers (row max and sum over the 4 lanes of a quad by
// shuffles, p = exp2(S * log2 e - m * log2 e), one FFMA and one MUFU.EX2 per
// score); P rounded to bf16 in registers is the A operand of O += P v, whose
// fp32 accumulator stays in registers. Only the last KV tile masks keys past
// Lk. Epilogue: O / l staged as bf16 in the warp's own q rows of shared
// memory, then 16-byte stores; lse per row.
//
// What bounds it: at D = 40 the exponential unit (B*H*Lq*Lk exponentials at
// 16 per clock per SM) above the tensor cores; at D = 80 the tensor cores.
// Each warp issues its exponentials and its products in turn, so the two
// overlap only across warps; the 16 warps per SM are what hides that.

#include "splash_common.cuh"

namespace ssdt {

constexpr int kFwdWarps = 8;  // 16 query rows each
constexpr int kFwdThreads = kFwdWarps * 32, kFwdRows = kFwdWarps * kWarpRows;
constexpr int kFwdStages = 3;

// CTAs per SM the registers must allow (no spill: see the ptxas report), and
// keys per KV tile.
template <int DP>
struct FwdShape {
  static constexpr int min_blocks = DP <= 80 ? 2 : 1;
  static constexpr int keys = DP == 80 ? 32 : 64;
};

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(kFwdRows + kFwdStages * 2 * FwdShape<DP>::keys) * Tile<DP>::ld * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kFwdThreads, FwdShape<DP>::min_blocks)
    splash_fwd_kernel(Args a) {
  constexpr int LD = Tile<DP>::ld, NT = DP / 8;
  constexpr int kKeys = FwdShape<DP>::keys;
  constexpr int kTileElems = kKeys * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + kFwdRows * LD;  // stage s: K at 2s, V at 2s + 1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kFwdRows;
  const int D = a.D, Lk = a.Lk;
  const bf16* k = head_ptr(a.k, a.sk, b, h);
  const bf16* v = head_ptr(a.v, a.sv, b, h);
  const int ntiles = (Lk + kKeys - 1) / kKeys;

  auto load_kv = [&](int j) {
    bf16* dst = sKV + (j % kFwdStages) * 2 * kTileElems;
    load_tile_async<kKeys, DP, kFwdThreads>(dst, k, a.sk.l, j * kKeys, Lk, D);
    load_tile_async<kKeys, DP, kFwdThreads>(dst + kTileElems, v, a.sv.l, j * kKeys, Lk, D);
  };
  load_tile_async<kFwdRows, DP, kFwdThreads>(sQ, head_ptr(a.q, a.sq, b, h), a.sq.l, q0, a.Lq, D);
  load_kv(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kFwdStages - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  bf16* myQ = sQ + warp * kWarpRows * LD;
  uint32_t qf[DP / 16][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Rows g and g + 8 of the warp's 16: running max (natural units) and this
  // lane's part of the running sum.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kFwdStages - 2>();  // tile j (and q) landed for this thread
    __syncthreads();                  // ... for all; tile j - 1's slot is free
    if (j + kFwdStages - 1 < ntiles) load_kv(j + kFwdStages - 1);
    cp_async_commit();
    if (j == 0) load_a_frags<DP>(qf, myQ, D);

    const bf16* sK = sKV + (j % kFwdStages) * 2 * kTileElems;
    const bf16* sV = sK + kTileElems;
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_abt<DP, kKeys / 8>(s, qf, sK, D);

    const int k0 = j * kKeys;
    if (k0 + kKeys > Lk) {  // the last tile: mask keys past Lk
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const int col = k0 + n * 8 + 2 * t;
        if (col >= Lk) s[n][0] = s[n][2] = -INFINITY;
        if (col + 1 >= Lk) s[n][1] = s[n][3] = -INFINITY;
      }
    }

    // Online softmax. The row max is finite: key k0 < Lk is in every tile.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2_approx((m0 - mx0) * kLog2e);  // 0 on the first tile
    const float alpha1 = exp2_approx((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    const float nm0 = -mx0 * kLog2e, nm1 = -mx1 * kLog2e;
    uint32_t pf[kKeys / 16][4];  // P as k16 A fragments over the tile's keys
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      const float p0 = exp2_approx(fmaf(s[n][0], kLog2e, nm0));
      const float p1 = exp2_approx(fmaf(s[n][1], kLog2e, nm0));
      const float p2 = exp2_approx(fmaf(s[n][2], kLog2e, nm1));
      const float p3 = exp2_approx(fmaf(s[n][3], kLog2e, nm1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      // n8 tile n holds keys 8n..8n+7: the low (n even) or high half of k16 step n/2.
      pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) mma_pw<DP>(o, pf[kk], sV + kk * 16 * LD, D);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // l >= 1: the row max contributes exp(0).
  const int row = q0 + warp * kWarpRows + (lane >> 2);
  if (t == 0) {
    float* lse = a.lse + (long long)bh * a.Lq;
    if (row < a.Lq) lse[row] = m0 + logf(l0);
    if (row + 8 < a.Lq) lse[row + 8] = m1 + logf(l1);
  }
  warp_store_rows<DP>(o, 1.f / l0, 1.f / l1, myQ, head_ptr(a.out, a.so, b, h), a.so.l,
                      q0 + warp * kWarpRows, a.Lq, D);
}

}  // namespace ssdt

extern "C" {

// strides: 12 values, (batch, head, row) for q, k, v, o, in elements.
int ssdt_splash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                    int H, int Lq, int Lk, int D, const long long* strides, void* stream) {
  using namespace ssdt;
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B, a.H = H, a.Lq = Lq, a.Lk = Lk, a.D = D;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.so = {strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ssdt_padded_dim(D)) {
#define SSDT_CASE(DP)                                                                         \
  case DP:                                                                                    \
    return launch_kernel(splash_fwd_kernel<DP>, fwd_smem_bytes<DP>(), Lq, kFwdRows, \
                         kFwdThreads, a, s);
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
