// Fused Adam update over stored moments, for Hopper (sm_90a).
//
// Replaces the TPU kernel of lab/micro_bf16_update.py (_kernel, reached by
// adam_bf16_fused_update): one pass over a leaf that reads the gradient and
// both moments in their storage dtype, updates the moments in fp32, writes
// the bias-corrected step in the output dtype and stores the moments back.
// Two switches make it compute each of its callers' chains exactly:
//   recip  -- multiply by 1/bias-correction (the lab kernel, the int8 path's
//             fp32-moment leaves) or divide by it (scale_by_adam_low_memory);
//   sr     -- store nu by the counter-hash stochastic rounding to bf16 (the
//             bf16-nu store of scale_by_adam_low_memory) instead of rounding
//             to nearest (the lab kernel).
// mu is always stored round-to-nearest.
//
// What bounds it on an H100: bytes. Per element it reads g and both moments
// and writes the output and both moments (14 bytes with bf16 g and moments
// and an fp32 output) for ~15 flops, far below the ~295 flop/byte ridge.
// This first version is a grid-stride loop, one element per thread and
// iteration, with the dtypes read at run time (warp-uniform branches); the
// moments are updated in place, each element read and written by the same
// thread.

#include "adam_common.cuh"

namespace ssdt {

struct AdamArgs {
  const void* g;
  void* mu;
  void* nu;
  void* out;
  long long n;
  int g_dtype, mu_dtype, nu_dtype, out_dtype;
  float b1, b2, omb1, omb2, eps, c1, c2;
  int recip, sr;
  uint32_t seed;
};

__global__ void __launch_bounds__(256) adam_bf16_fused_kernel(const AdamArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const float g = load_as_float(a.g, a.g_dtype, i);
    const float m = adam_mu(load_as_float(a.mu, a.mu_dtype, i), g, a.b1, a.omb1);
    const float v = adam_nu(load_as_float(a.nu, a.nu_dtype, i), g, a.b2, a.omb2);
    store_rn(a.out, a.out_dtype, i, adam_step(m, v, a.c1, a.c2, a.eps, a.recip != 0));
    store_rn(a.mu, a.mu_dtype, i, m);
    if (a.sr) {
      store_sr(a.nu, a.nu_dtype, i, v, a.seed);
    } else {
      store_rn(a.nu, a.nu_dtype, i, v);
    }
  }
}

}  // namespace ssdt

extern "C" {

// dtypes: 0 fp32, 1 bf16, 2 fp16. c1, c2: bias corrections (recip = 0) or
// their fp32 reciprocals (recip = 1). seed: step * 0x9E3779B9 ^ salt (sr = 1).
// mu and nu are updated in place.
int ssdt_adam_bf16_fused(const void* g, void* mu, void* nu, void* out, long long n, int g_dtype,
                         int mu_dtype, int nu_dtype, int out_dtype, float b1, float b2,
                         float omb1, float omb2, float eps, float c1, float c2, int recip, int sr,
                         unsigned int seed, void* stream) {
  using namespace ssdt;
  if (n <= 0) return 0;
  AdamArgs a{g, mu, nu, out, n, g_dtype, mu_dtype, nu_dtype, out_dtype,
             b1, b2, omb1, omb2, eps, c1, c2, recip, sr, seed};
  constexpr int kThreadsPerBlock = 256;
  const long long want = (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  adam_bf16_fused_kernel<<<blocks, kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
