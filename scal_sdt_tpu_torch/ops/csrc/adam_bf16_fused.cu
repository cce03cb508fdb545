// Fused Adam update over stored moments, for Hopper (sm_90a).
//
// Replaces the TPU kernel of lab/micro_bf16_update.py (_kernel, reached by
// adam_bf16_fused_update): one pass that reads the gradient and both
// moments in their storage dtypes, updates the moments in fp32 and stores
// them back. Two switches make it compute each of its callers' chains
// exactly:
//   recip  -- multiply by 1/bias-correction (the lab kernel, the int8 path's
//             fp32-moment leaves) or divide by it (scale_by_adam_low_memory);
//   sr     -- store nu by the counter-hash stochastic rounding to bf16 (the
//             bf16-nu store of scale_by_adam_low_memory) instead of rounding
//             to nearest (the lab kernel);
//   xla    -- round as XLA's fusion of plain optax.scale_by_adam does (the
//             moment-dtype-less AdamW / Adam under the JAX trainer's jit:
//             1-b1, 1-b2 and g*g in the gradient's dtype, fmas where XLA
//             contracts, one division by the folded bias corrections; in the
//             grouped entry also the decay as one fma). adam_common.cuh,
//             xla_mu / xla_nu / xla_step.
// mu is always stored round-to-nearest.
//
// Two entry points share one body (adam_chunk):
//   ssdt_adam_bf16_fused  -- one leaf, writes the bias-corrected step in the
//                            output dtype (the port of the TPU kernel);
//   ssdt_adam_bf16_group  -- every leaf of many param groups in one launch,
//                            over a leaf table in device memory; after Adam
//                            it applies the decay and the schedule and writes
//                            the new master in place (adam_common.cuh,
//                            epilogue), so neither the update nor a dither
//                            reaches device memory.
//
// One launch over many groups. A step of a LoRA run updates hundreds of
// param groups of two small factors each (264 in lora.yaml, 986 in
// sdxl_lora.yaml); a launch per group did a few microseconds of work behind
// its own launch and host upload. The per-element chain is the same function
// in every group and differs only in scalars, so the grouped entry splits
// them: what a launch fixes (betas, eps, the dtypes, recip, sr, xla) stays a
// kernel argument, and what a group sets (the bias corrections, the nu
// dither's count, the decay, the schedule's step size, the master dither's
// step) is one AdamGroup record per group in device memory, which each
// CTA's entry in the chunk map names. The host stages the group records each
// step beside the gradients' addresses, in one copy.
//
// What bounds it on an H100: bytes. Per element the grouped form reads g,
// both moments and the master and writes the moments and the master (14
// bytes with bf16 everywhere) for ~20 flops and ~10 integer operations of the
// hash, far below the ~295 flop/byte ridge. So the design is about bytes in
// flight: each thread moves eight elements of every tensor at a time with
// 16-byte accesses (two for fp32), issuing all its loads before the math.
// A CTA owns one chunk of kChunk consecutive elements of one leaf; the
// grouped launch maps CTAs to (leaf, chunk) pairs by a chunk list built once
// on the host, so the 29.5M-element leaf spreads over every SM and a
// 320-element leaf takes one CTA. No atomics: each element is read and
// written by one thread.

#include "adam_common.cuh"

namespace ssdt {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // elements per CTA of the single-leaf entry
// CTAs per SM the grouped kernel's typed instances ask for: the bytes in
// flight of four CTAs (1,024 threads) need its registers at 64 or fewer,
// which the group's scalars, read at run time rather than from the
// launch's constants, would otherwise push past.
constexpr int kGroupMinCtas = 4;

struct AdamHyper {
  float b1, b2, omb1, omb2, eps, c1, c2;
  int recip, sr, xla;
  int g_dtype, mu_dtype, nu_dtype;
};

// A leaf of a grouped launch, as ops/adam_bf16_fused.py packs it (40 bytes).
struct AdamLeaf {
  char* p;
  char* mu;
  char* nu;
  long long n;
  uint32_t nu_salt, master_salt;
};
static_assert(sizeof(AdamLeaf) == 40, "AdamLeaf layout must match ops/adam_bf16_fused.py");

// A CTA's work in the grouped launch: chunk `chunk` of leaf `leaf`, whose
// param group is `group`. The group rides in the chunk map, not in the leaf
// record, so that a CTA reads its leaf's and its group's records at once.
struct __align__(16) AdamChunk {
  int leaf, chunk, group, pad;
};

// The scalars a param group sets at a step, as ops/adam_bf16_fused.py packs
// them (32 bytes).
struct AdamGroup {
  float c1, c2;       // the group's bias corrections, or their reciprocals (recip)
  uint32_t nu_mix;    // count * 0x9E3779B9: nu's SR seed is nu_mix ^ the leaf's salt
  int has_wd;
  float wd_p;         // weight decay rounded to the master's dtype
  float step_u;       // -lr * schedule(count), rounded to the update's dtype
  uint32_t step_mix;  // step * 0x9E3779B9: the master SR's seed is step_mix ^ the salt
  uint32_t pad;
};
static_assert(sizeof(AdamGroup) == 32, "AdamGroup layout must match ops/adam_bf16_fused.py");

__device__ __forceinline__ void adam_core(float g, float m0, float v0, const AdamHyper& h,
                                          float& m, float& v, float& out) {
  if (h.xla) {
    m = xla_mu(m0, g, h.b1, h.omb1, h.g_dtype);
    v = xla_nu(v0, g, h.b2, h.omb2, h.g_dtype);
    out = xla_step(m, v, h.c1, h.c2, h.eps);
    return;
  }
  m = adam_mu(m0, g, h.b1, h.omb1);
  v = adam_nu(v0, g, h.b2, h.omb2);
  out = adam_step(m, v, h.c1, h.c2, h.eps, h.recip != 0);
}

// Elements [s, e) of one leaf. Eight-element groups start at the first index
// at which g, mu, nu and the epilogue's tensor are all 16-byte aligned (the
// same for every chunk, as chunks start at multiples of eight); the up to
// seven elements before the first group and after the last run one per
// thread, as does the whole chunk when no such index exists.
template <class Epi>
__device__ __forceinline__ void adam_chunk(const char* g, char* mu, char* nu, long long s,
                                           long long e, uint32_t nu_seed, const AdamHyper& h,
                                           const Epi& epi) {
  int a = -1;
  for (int c = 0; c < 8 && a < 0; ++c)
    if (aligned16(g + c * dsize(h.g_dtype)) && aligned16(mu + c * dsize(h.mu_dtype)) &&
        aligned16(nu + c * dsize(h.nu_dtype)) && epi.aligned(c))
      a = c;
  long long v0 = e, v1 = e;
  if (a >= 0) {
    v0 = min(e, s + ((a - s) & 7));
    v1 = v0 + ((e - v0) & ~7LL);
  }

  for (long long i = v0 + 8LL * threadIdx.x; i < v1; i += 8LL * blockDim.x) {
    const Raw8 rg = load8(g, h.g_dtype, i);
    const Raw8 rm = load8(mu, h.mu_dtype, i);
    const Raw8 rv = load8(nu, h.nu_dtype, i);
    const Raw8 rp = epi.prefetch8(i);
    float gf[8], m[8], v[8], o[8];
    unpack8(rg, h.g_dtype, gf);
    unpack8(rm, h.mu_dtype, m);
    unpack8(rv, h.nu_dtype, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) adam_core(gf[k], m[k], v[k], h, m[k], v[k], o[k]);
    store8_rn(mu, h.mu_dtype, i, m);
    if (h.sr) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = sr_value(h.nu_dtype, v[k], (uint32_t)(i + k), nu_seed);
    }
    store8_rn(nu, h.nu_dtype, i, v);  // exact after SR: the values are already nu's
    epi.finish8(i, rp, o);
  }

  const long long head = v0 - s, rest = head + (e - v1);
  for (long long t = threadIdx.x; t < rest; t += blockDim.x) {
    const long long i = t < head ? s + t : v1 + (t - head);
    float m, v, o;
    adam_core(load_as_float(g, h.g_dtype, i), load_as_float(mu, h.mu_dtype, i),
              load_as_float(nu, h.nu_dtype, i), h, m, v, o);
    store_rn(mu, h.mu_dtype, i, m);
    store_rn(nu, h.nu_dtype, i, h.sr ? sr_value(h.nu_dtype, v, (uint32_t)i, nu_seed) : v);
    epi.finish1(i, o);
  }
}

// Dtypes fixed at compile time: G, M, V (gradient, mu, nu) and E, U (the
// epilogue's tensor -- output or master -- and the update), each a DType or
// kAny to read it from the arguments. The launchers instantiate the main
// path's combinations, where every dtype switch folds away, and one all-kAny
// instance for the rest.
constexpr int kAny = -1;

template <int G, int M, int V>
__device__ __forceinline__ AdamHyper fixed(AdamHyper h) {
  if (G != kAny) h.g_dtype = G;
  if (M != kAny) h.mu_dtype = M;
  if (V != kAny) h.nu_dtype = V;
  return h;
}

template <int G, int M, int V, int E>
__global__ void __launch_bounds__(kThreads) adam_bf16_fused_kernel(
    const char* g, char* mu, char* nu, long long n, uint32_t nu_seed, const AdamHyper h,
    WriteUpdate epi) {
  if (E != kAny) epi.dtype = E;
  const long long s = (long long)blockIdx.x * kChunk;
  adam_chunk(g, mu, nu, s, min(n, s + kChunk), nu_seed, fixed<G, M, V>(h), epi);
}

// h and a hold what the launch fixes; each CTA fills in its leaf's group's
// scalars, the same for all its threads. The all-kAny instance (the rarer
// dtypes: fp16 moments, say) asks for no occupancy: its dtype switches need
// more registers.
template <int G, int M, int V, int E, int U>
__global__ void __launch_bounds__(kThreads, G == kAny ? 1 : kGroupMinCtas) adam_bf16_group_kernel(
    const AdamLeaf* __restrict__ leaves, const AdamGroup* __restrict__ groups,
    const char* const* __restrict__ grads, const AdamChunk* __restrict__ chunks, long long chunk,
    AdamHyper h, ApplyArgs a) {
  if (E != kAny) a.p_dtype = E;
  if (U != kAny) a.u_dtype = U;
  const AdamChunk c = chunks[blockIdx.x];
  const AdamLeaf L = leaves[c.leaf];
  const AdamGroup grp = groups[c.group];
  h.c1 = grp.c1;
  h.c2 = grp.c2;
  a.has_wd = grp.has_wd;
  a.wd_p = grp.wd_p;
  a.step_u = grp.step_u;
  a.step_mix = grp.step_mix;
  const long long s = (long long)c.chunk * chunk;
  const ApplyToMaster epi{L.p, a, grp.step_mix ^ L.master_salt};
  adam_chunk(grads[c.leaf], L.mu, L.nu, s, min(L.n, s + chunk), grp.nu_mix ^ L.nu_salt,
             fixed<G, M, V>(h), epi);
}

}  // namespace ssdt

extern "C" {

// dtypes: 0 fp32, 1 bf16, 2 fp16. c1, c2: bias corrections (recip = 0) or
// their fp32 reciprocals (recip = 1). seed: step * 0x9E3779B9 ^ salt (sr = 1).
// xla = 1: XLA's rounding of plain scale_by_adam (recip = 0, omb1 and omb2
// rounded to the gradient's dtype). mu and nu are updated in place.
int ssdt_adam_bf16_fused(const void* g, void* mu, void* nu, void* out, long long n, int g_dtype,
                         int mu_dtype, int nu_dtype, int out_dtype, float b1, float b2,
                         float omb1, float omb2, float eps, float c1, float c2, int recip, int sr,
                         int xla, unsigned int seed, void* stream) {
  using namespace ssdt;
  if (n <= 0) return 0;
  const AdamHyper h{b1, b2, omb1, omb2, eps, c1, c2, recip, sr, xla, g_dtype, mu_dtype, nu_dtype};
  const WriteUpdate epi{static_cast<char*>(out), out_dtype};
  const unsigned int blocks = (unsigned int)((n + kChunk - 1) / kChunk);
  auto kernel = adam_bf16_fused_kernel<kAny, kAny, kAny, kAny>;
  if (g_dtype == kBF16 && mu_dtype == kBF16 && nu_dtype == kBF16 && out_dtype == kF32)
    kernel = adam_bf16_fused_kernel<kBF16, kBF16, kBF16, kF32>;  // AdamW, bf16 moments
  else if (g_dtype == kBF16 && mu_dtype == kF32 && nu_dtype == kF32 && out_dtype == kBF16)
    kernel = adam_bf16_fused_kernel<kBF16, kF32, kF32, kBF16>;  // AdamW8bit's small leaves
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(g), static_cast<char*>(mu), static_cast<char*>(nu), n, seed, h,
      epi);
  return (int)cudaGetLastError();
}

// One launch over every leaf of many param groups. leaves: device array of
// AdamLeaf; groups: device array of AdamGroup, one per group; grads: device
// array of the gradients' addresses, one per leaf; chunks: device array of
// nchunks AdamChunk (leaf, chunk, group), chunk = elements per chunk (a
// multiple of 8). The dtypes, betas, eps, recip, sr
// and xla are the launch's; every other scalar is a group's (AdamGroup).
// xla = 1: XLA's rounding of plain scale_by_adam and of the decay (fp32
// masters and updates). Moments and masters are updated in place.
int ssdt_adam_bf16_group(const void* leaves, const void* groups, const void* grads,
                         const void* chunks, int nchunks, long long chunk, int g_dtype,
                         int mu_dtype, int nu_dtype, int p_dtype, int u_dtype, float b1, float b2,
                         float omb1, float omb2, float eps, int recip, int sr, int xla,
                         void* stream) {
  using namespace ssdt;
  if (nchunks <= 0) return 0;
  // c1, c2 and the decay, schedule and seeds come from each leaf's group
  const AdamHyper h{b1, b2, omb1, omb2, eps, 0.f, 0.f, recip, sr, xla, g_dtype, mu_dtype,
                    nu_dtype};
  const ApplyArgs a{p_dtype, u_dtype, 0, xla, 0.f, 0.f, 0u};
  auto kernel = adam_bf16_group_kernel<kAny, kAny, kAny, kAny, kAny>;
  if (g_dtype == kBF16 && mu_dtype == kBF16 && nu_dtype == kBF16 && p_dtype == kBF16 &&
      u_dtype == kF32)
    kernel = adam_bf16_group_kernel<kBF16, kBF16, kBF16, kBF16, kF32>;  // AdamW
  else if (g_dtype == kBF16 && mu_dtype == kF32 && nu_dtype == kF32 && p_dtype == kF32 &&
           u_dtype == kF32)
    kernel = adam_bf16_group_kernel<kBF16, kF32, kF32, kF32, kF32>;  // AdamW, the default
  else if (g_dtype == kBF16 && mu_dtype == kF32 && nu_dtype == kF32 && p_dtype == kBF16 &&
           u_dtype == kBF16)
    kernel = adam_bf16_group_kernel<kBF16, kF32, kF32, kBF16, kBF16>;  // AdamW8bit
  // under gradient accumulation the groups take the fp32 mean of the gradients
  else if (g_dtype == kF32 && mu_dtype == kBF16 && nu_dtype == kBF16 && p_dtype == kBF16 &&
           u_dtype == kF32)
    kernel = adam_bf16_group_kernel<kF32, kBF16, kBF16, kBF16, kF32>;  // AdamW
  else if (g_dtype == kF32 && mu_dtype == kF32 && nu_dtype == kF32 && p_dtype == kBF16 &&
           u_dtype == kF32)
    kernel = adam_bf16_group_kernel<kF32, kF32, kF32, kBF16, kF32>;  // AdamW8bit
  else if (g_dtype == kF32 && mu_dtype == kF32 && nu_dtype == kF32 && p_dtype == kF32 &&
           u_dtype == kF32)
    kernel = adam_bf16_group_kernel<kF32, kF32, kF32, kF32, kF32>;  // AdamW, the default
  kernel<<<(unsigned int)nchunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamLeaf*>(leaves), static_cast<const AdamGroup*>(groups),
      static_cast<const char* const*>(grads), static_cast<const AdamChunk*>(chunks), chunk, h,
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
