// Splash-attention forward for Hopper: O = softmax(q k^T) v and the
// logsumexp residual. Replaces the TPU forward kernel
// (splash_attention_kernel.py `_splash_attention_forward`, reached from
// scal_sdt_tpu/ops/splash.py `splash_attention`). See splash_common.cuh for
// the design and what bounds it.
//
// Grid: (ceil(Lq / 64), B * H). Each CTA walks all KV tiles of its head with an
// online softmax: per tile, S = q k^T on the tensor cores into shared memory,
// fp32 running max / sum per row, P = exp(S - m) rounded to bf16, and the fp32
// accumulator O (kept in shared memory, rescaled per row) += P v.

#include "splash_common.cuh"

namespace ssdt {

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(3 * kRows * Dims<DP>::ld + kRows * kLdP) * sizeof(bf16) +
         (size_t)(kRows * kLdS + kRows * Dims<DP>::ldo + 2 * kRows) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) splash_fwd_kernel(Args a) {
  constexpr int LD = Dims<DP>::ld, LDO = Dims<DP>::ldo;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * LD;
  bf16* sV = sK + kRows * LD;
  bf16* sP = sV + kRows * LD;
  float* sS = reinterpret_cast<float*>(sP + kRows * kLdP);
  float* sO = sS + kRows * kLdS;
  float* sM = sO + kRows * LDO;
  float* sL = sM + kRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kRows;
  const bf16* q = head_ptr(a.q, a.sq, b, h);
  const bf16* k = head_ptr(a.k, a.sk, b, h);
  const bf16* v = head_ptr(a.v, a.sv, b, h);

  load_rows<DP>(sQ, q, a.sq.l, q0, a.Lq, a.D);
  for (int i = threadIdx.x; i < kRows * LDO; i += kThreads) sO[i] = 0.f;
  if (threadIdx.x < kRows) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }

  // The warp's 16 rows; in the softmax, lane pair (2r, 2r+1) takes row r,
  // each lane one half of the 64 columns.
  const int r0 = warp * 16;
  const int row = r0 + (lane >> 1), half = lane & 1;

  for (int k0 = 0; k0 < a.Lk; k0 += kInner) {
    __syncthreads();  // every warp is done with the previous sK / sV
    load_rows<DP>(sK, k, a.sk.l, k0, a.Lk, a.D);
    load_rows<DP>(sV, v, a.sv.l, k0, a.Lk, a.D);
    __syncthreads();

    warp_abt<DP>(sS + r0 * kLdS, kLdS, sQ + r0 * LD, sK);
    __syncwarp();

    const float* srow = sS + row * kLdS + half * 32;
    const int valid = a.Lk - k0 - half * 32;  // unmasked columns of this half
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c)
      if (c < valid) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    // Finite: column k0 < Lk is always valid, and rows past Lq hold zeros.
    const float m_old = sM[row];
    const float m_new = fmaxf(m_old, mx);
    const float alpha = __expf(m_old - m_new);  // 0 on the first tile

    bf16* prow = sP + row * kLdP + half * 32;
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = c < valid ? __expf(srow[c] - m_new) : 0.f;
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* orow = sO + row * LDO;
    for (int c = half; c < DP; c += 2) orow[c] *= alpha;
    __syncwarp();  // both lanes of the pair have read sM[row]
    if (half == 0) {
      sM[row] = m_new;
      sL[row] = sL[row] * alpha + sum;
    }
    __syncwarp();

    FragC acc[Dims<DP>::frags];
#pragma unroll
    for (int n = 0; n < Dims<DP>::frags; ++n)
      wmma::load_matrix_sync(acc[n], sO + r0 * LDO + n * 16, LDO, wmma::mem_row_major);
    warp_ab_acc<DP>(acc, sP + r0 * kLdP, sV);
#pragma unroll
    for (int n = 0; n < Dims<DP>::frags; ++n)
      wmma::store_matrix_sync(sO + r0 * LDO + n * 16, acc[n], LDO, wmma::mem_row_major);
  }
  __syncwarp();

  // O = acc / l; l >= 1 because the row max contributes exp(0).
  float lse_val = 0.f;
  if (lane < 16) {
    const float l = sL[r0 + lane];
    lse_val = sM[r0 + lane] + logf(l);
    sL[r0 + lane] = 1.f / l;  // from here on, the row scale of the output
  }
  __syncwarp();
  warp_write_rows<DP>(sO + r0 * LDO, sL + r0, head_ptr(a.out, a.so, b, h), a.so.l,
                      q0 + r0, a.Lq, a.D);
  if (lane < 16 && q0 + r0 + lane < a.Lq) a.lse[(long long)bh * a.Lq + q0 + r0 + lane] = lse_val;
}

template <int DP>
int launch_fwd(const Args& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(splash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lq + kRows - 1) / kRows, a.B * a.H);
  splash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
#define SSDT_CASE(DP) \
  case DP:            \
    return launch_fwd<DP>(a, s);
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
