// Fused int8 blockwise Adam update, for Hopper (sm_90a).
//
// Replaces the TPU kernel of scal_sdt_tpu/ops/adam8_fused.py (_kernel, reached
// by adam8_fused_update): per 256-element block of a leaf's (lead, minor)
// view, dequantize the int8 mu and nu (one fp32 absmax scale per block),
// update both moments in fp32, write mu*inv_bc1 / (sqrt(nu*inv_bc2) + eps)
// in the gradient's dtype, and requantize both moments: scale = absmax/127,
// payload = clip(round_half_even(val / safe), -127, 127) with safe = scale
// where scale > 0, else 1. The gradient comes in unpadded; columns past
// minor in the ragged last block count as zero gradient, so the padded tail
// of the state stays exactly zero from a zero start.
//
// Design (first, simple version): one warp per (row, block). Lane l owns
// columns l, l+32, ..., l+224 of the block, so every load and store of the
// warp is contiguous; the absmax is a warp shuffle reduction, so nothing
// touches shared memory and no block waits on another. The TPU kernel's
// lane-padded scale panels existed for the TPU's DMA and VMEM tiling and
// have no counterpart here: each warp reads and writes its two scales
// directly. The state is updated in place: a warp reads its whole block
// before it writes it.
//
// What bounds it on an H100: bytes. Per element it reads a bf16 gradient and
// two int8 payloads and writes them back with a bf16 output (8 bytes, plus
// 16 bytes of scales per 256 elements), for ~25 flops: far below the
// ~295 flop/byte ridge. Byte-wide loads per lane (32 bytes per warp access)
// keep this version below the memory rate; wider loads are later work.

#include "adam_common.cuh"

namespace ssdt {

constexpr int kBlock = 256;               // quantization block
constexpr int kPerLane = kBlock / 32;     // elements of a block per lane
constexpr int kWarpsPerCta = 8;

struct Adam8Args {
  const void* g;          // (lead, minor), g_dtype
  int8_t* mu_q;           // (lead, nb * 256), updated in place
  float* mu_s;            // (lead, nb), updated in place
  int8_t* nu_q;
  float* nu_s;
  void* out;              // (lead, minor), g_dtype
  int lead, minor, nb, g_dtype;
  float b1, b2, omb1, omb2, eps, inv_bc1, inv_bc2;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Requantize one moment's block: each lane holds kPerLane values.
__device__ __forceinline__ void quantize_block(const float (&val)[kPerLane], int8_t* q,
                                               float* s, int lane) {
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) amax = fmaxf(amax, fabsf(val[k]));
  amax = warp_max(amax);
  const float scale = __fdiv_rn(amax, 127.f);
  const float safe = scale > 0.f ? scale : 1.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const float r = rintf(__fdiv_rn(val[k], safe));
    q[lane + 32 * k] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (lane == 0) *s = scale;
}

__global__ void __launch_bounds__(kWarpsPerCta * 32) adam8_fused_kernel(const Adam8Args a) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (w >= (long long)a.lead * a.nb) return;
  const long long row = w / a.nb;
  const int j = (int)(w % a.nb);
  const long long qoff = (row * a.nb + j) * kBlock;  // block start in the payloads
  const long long soff = row * a.nb + j;
  const float mu_scale = a.mu_s[soff], nu_scale = a.nu_s[soff];

  float mu[kPerLane], nu[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int col = j * kBlock + lane + 32 * k;
    const float g = col < a.minor ? load_as_float(a.g, a.g_dtype, row * a.minor + col) : 0.f;
    const float m0 = __fmul_rn(static_cast<float>(a.mu_q[qoff + lane + 32 * k]), mu_scale);
    const float v0 = __fmul_rn(static_cast<float>(a.nu_q[qoff + lane + 32 * k]), nu_scale);
    mu[k] = adam_mu(m0, g, a.b1, a.omb1);
    nu[k] = adam_nu(v0, g, a.b2, a.omb2);
    if (col < a.minor)
      store_rn(a.out, a.g_dtype, row * a.minor + col,
               adam_step(mu[k], nu[k], a.inv_bc1, a.inv_bc2, a.eps, true));
  }
  quantize_block(mu, a.mu_q + qoff, a.mu_s + soff, lane);
  quantize_block(nu, a.nu_q + qoff, a.nu_s + soff, lane);
}

}  // namespace ssdt

extern "C" {

// g_dtype: 0 fp32, 1 bf16, 2 fp16 (the output takes the same dtype). The
// payloads and scales are updated in place.
int ssdt_adam8_fused(const void* g, void* mu_q, void* mu_s, void* nu_q, void* nu_s, void* out,
                     int lead, int minor, int nb, int g_dtype, float b1, float b2, float omb1,
                     float omb2, float eps, float inv_bc1, float inv_bc2, void* stream) {
  using namespace ssdt;
  const long long warps = (long long)lead * nb;
  if (warps <= 0) return 0;
  Adam8Args a{g,
              static_cast<int8_t*>(mu_q),
              static_cast<float*>(mu_s),
              static_cast<int8_t*>(nu_q),
              static_cast<float*>(nu_s),
              out,
              lead, minor, nb, g_dtype, b1, b2, omb1, omb2, eps, inv_bc1, inv_bc2};
  const long long blocks = (warps + kWarpsPerCta - 1) / kWarpsPerCta;
  adam8_fused_kernel<<<(unsigned int)blocks, kWarpsPerCta * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
