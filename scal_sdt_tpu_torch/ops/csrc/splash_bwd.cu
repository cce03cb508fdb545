// Splash-attention backward for Hopper, as two kernels with no atomics,
// matching the split (non-fused) backward of the TPU version
// (scal_sdt_tpu/ops/splash.py sets use_fused_bwd_kernel=False):
//
// * dq  replaces `_splash_attention_bwd_dq`: one CTA per (head, 64 query
//   rows) walks every KV tile: S = q k^T, P = exp(S - lse), dP = dO v^T,
//   dS = P * (dP - delta), dq += dS k (accumulated in registers). It also
//   computes delta = rowsum(dO * O) for its rows and stores it for dkv.
// * dkv replaces `_splash_attention_bwd_dkv`: one CTA per (head, 64 key rows)
//   walks every query tile with the transposed products: S^T = k q^T,
//   P^T, dP^T = v dO^T, dS^T; dv += P^T dO and dk += dS^T q.
//
// dkv reads the delta that dq wrote, so the two launch in that order on one
// stream. Gradients are with respect to the pre-scaled q the forward saw;
// the caller's autograd applies the scale's chain rule. See
// splash_common.cuh for the tile design and what bounds it.

#include "splash_common.cuh"

namespace ssdt {

template <int DP>
constexpr size_t dq_smem_bytes() {
  const size_t tiles = (size_t)(4 * kRows * Dims<DP>::ld + kRows * kLdP) * sizeof(bf16) +
                       (size_t)(2 * kRows * kLdS + 2 * kRows) * sizeof(float);
  const size_t stage = (size_t)kRows * Dims<DP>::ldo * sizeof(float);
  return tiles > stage ? tiles : stage;
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  const size_t tiles = (size_t)(4 * kRows * Dims<DP>::ld + 2 * kRows * kLdP) * sizeof(bf16) +
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

template <int DP>
__global__ void __launch_bounds__(kThreads) splash_dkv_kernel(Args a) {
  constexpr int LD = Dims<DP>::ld;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;
  bf16* sDO = sQ + kRows * LD;
  bf16* sPT = sDO + kRows * LD;
  bf16* sDST = sPT + kRows * kLdP;
  float* sST = reinterpret_cast<float*>(sDST + kRows * kLdP);
  float* sDPT = sST + kRows * kLdS;
  float* sLse = sDPT + kRows * kLdS;
  float* sDelta = sLse + kRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kRows;
  const bf16* q = head_ptr(a.q, a.sq, b, h);
  const bf16* dout = head_ptr(a.dout, a.sdo, b, h);

  load_rows<DP>(sK, head_ptr(a.k, a.sk, b, h), a.sk.l, k0, a.Lk, a.D);
  load_rows<DP>(sV, head_ptr(a.v, a.sv, b, h), a.sv.l, k0, a.Lk, a.D);

  // The warp's 16 key rows; lane pair (2r, 2r+1) takes key row r, each lane
  // one half of the 64 query columns.
  const int r0 = warp * 16;
  const int row = r0 + (lane >> 1), half = lane & 1;

  FragC dk[Dims<DP>::frags], dv[Dims<DP>::frags];
#pragma unroll
  for (int n = 0; n < Dims<DP>::frags; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }

  for (int q0 = 0; q0 < a.Lq; q0 += kInner) {
    __syncthreads();
    load_rows<DP>(sQ, q, a.sq.l, q0, a.Lq, a.D);
    load_rows<DP>(sDO, dout, a.sdo.l, q0, a.Lq, a.D);
    if (threadIdx.x < kInner) {
      const int gq = q0 + threadIdx.x;
      const bool in = gq < a.Lq;
      // lse = +inf masks query rows past Lq: exp(S - inf) = 0.
      sLse[threadIdx.x] = in ? a.lse[(long long)bh * a.Lq + gq] : INFINITY;
      sDelta[threadIdx.x] = in ? a.delta[(long long)bh * a.Lq + gq] : 0.f;
    }
    __syncthreads();

    warp_abt<DP>(sST + r0 * kLdS, kLdS, sK + r0 * LD, sQ);
    warp_abt<DP>(sDPT + r0 * kLdS, kLdS, sV + r0 * LD, sDO);
    __syncwarp();

    // Key rows past Lk hold k = v = 0; their dk / dv rows are never written.
    const float* strow = sST + row * kLdS + half * 32;
    const float* dptrow = sDPT + row * kLdS + half * 32;
    bf16* ptrow = sPT + row * kLdP + half * 32;
    bf16* dstrow = sDST + row * kLdP + half * 32;
    const float* lse = sLse + half * 32;
    const float* delta = sDelta + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = __expf(strow[c] - lse[c]);
      ptrow[c] = __float2bfloat16(p);
      dstrow[c] = __float2bfloat16(p * (dptrow[c] - delta[c]));
    }
    __syncwarp();
    warp_ab_acc<DP>(dv, sPT + r0 * kLdP, sDO);
    warp_ab_acc<DP>(dk, sDST + r0 * kLdP, sQ);
  }

  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem) + r0 * Dims<DP>::ldo;
  warp_store_acc<DP>(stage, dk, head_ptr(a.out, a.sout, b, h), a.sout.l, k0 + r0, a.Lk, a.D);
  warp_store_acc<DP>(stage, dv, head_ptr(a.out2, a.sout2, b, h), a.sout2.l, k0 + r0, a.Lk, a.D);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int rows, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + kRows - 1) / kRows, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
    return launch(splash_dq_kernel<DP>, dq_smem_bytes<DP>(), Lq, a, s);
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
#define SSDT_CASE(DP) \
  case DP:            \
    return launch(splash_dkv_kernel<DP>, dkv_smem_bytes<DP>(), Lk, a, s);
    SSDT_FOR_EACH_DP(SSDT_CASE)
#undef SSDT_CASE
    default:
      return kErrHeadDim;
  }
}

}  // extern "C"
