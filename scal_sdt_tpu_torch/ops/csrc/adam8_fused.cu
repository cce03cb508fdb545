// Fused int8 blockwise Adam update, for Hopper (sm_90a).
//
// Replaces the TPU kernel of scal_sdt_tpu/ops/adam8_fused.py (_kernel, reached
// by adam8_fused_update): per 256-element block of a leaf's (lead, minor)
// view, dequantize the int8 mu and nu (one fp32 absmax scale per block),
// update both moments in fp32, form mu*inv_bc1 / (sqrt(nu*inv_bc2) + eps) in
// the gradient's dtype, and requantize both moments: scale = absmax/127,
// payload = clip(round_half_even(val / safe), -127, 127) with safe = scale
// where scale > 0, else 1. The gradient comes in unpadded; columns past
// minor in the ragged last block count as zero gradient, so the padded tail
// of the state stays exactly zero from a zero start.
//
// Two entry points share one body (adam8_block):
//   ssdt_adam8_fused  -- one leaf, writes the step in the gradient's dtype
//                        (the port of the TPU kernel);
//   ssdt_adam8_group  -- every int8 leaf of a param group in one launch, over
//                        a leaf table in device memory; after Adam it applies
//                        the decay and the schedule and writes the new master
//                        in place (adam_common.cuh, epilogue). The master's
//                        element (row, col) is element row * minor + col of
//                        the leaf, which keys its dither; padded columns
//                        write no master.
//
// Design: a half-warp owns one block. Lane l of the half holds the 16
// consecutive elements 16l..16l+15: its 16 bytes of each payload are one
// 16-byte access, its bf16 gradient and master two each (four for fp32),
// and the absmax is a 16-lane shuffle. Rows whose gradient or master is not
// 16-byte aligned at the lane's element, and the ragged last block of a row,
// read and write those one element at a time in the same kernel. Nothing
// touches shared memory and no block waits on another. The state is updated
// in place: a half-warp reads its whole block before it writes it. The TPU
// kernel's lane-padded scale panels existed for the TPU's DMA and VMEM
// tiling and have no counterpart here. No atomics.
//
// What bounds it on an H100: bytes. Per element the grouped form reads a
// bf16 gradient, two int8 payloads and the bf16 master and writes the
// payloads and the master (10 bytes, plus 16 bytes of scales per 256
// elements), for ~30 flops and the hash: far below the ~295 flop/byte ridge.
// But each element also takes three correctly rounded divisions and a
// square root, and a block's requantize waits on a shuffle chain, so the
// kernel is latency-bound at the occupancy its registers allow: the grouped
// kernel runs its epilogue per eight elements (fewer live values), divides
// the requantize by one reciprocal per block (exact, see rint_div), and asks
// for four CTAs per SM (kGroupMinCtas).

#include "adam_common.cuh"

namespace ssdt {

constexpr int kBlock = 256;           // quantization block
constexpr int kPerLane = 16;          // elements of a block per lane of its half-warp
constexpr int kThreads = 256;         // 16 half-warps: 16 blocks per CTA step
constexpr int kHalves = kThreads / 16;
constexpr int kSteps = 4;             // CTA steps per chunk of the single-leaf entry
// CTAs per SM the grouped kernel asks for: it caps its registers at 64, with
// a few bytes of spill, and runs latency-bound below that occupancy
// (scripts/sweep_adam_chunks.py --int8-min-ctas).
constexpr int kGroupMinCtas = 4;

struct Adam8Hyper {
  float b1, b2, omb1, omb2, eps, inv_bc1, inv_bc2;
  int g_dtype;
};

// The int8 state of a leaf (lead, minor) with nb blocks per row.
struct Adam8State {
  int8_t* mu_q;
  float* mu_s;
  int8_t* nu_q;
  float* nu_s;
  int lead, minor, nb;
};

// A leaf of a group, as ops/adam8_fused.py packs it (64 bytes).
struct Adam8Leaf {
  char* p;
  int8_t* mu_q;
  float* mu_s;
  int8_t* nu_q;
  float* nu_s;
  int lead, minor, nb;
  uint32_t master_salt;
  long long pad;
};
static_assert(sizeof(Adam8Leaf) == 64, "Adam8Leaf layout must match ops/adam8_fused.py");

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void unpack16_i8(const uint4& r, float (&x)[kPerLane]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    x[k] = static_cast<float>(static_cast<int8_t>((w[k / 4] >> (8 * (k % 4))) & 0xFFu));
}

// rintf(__fdiv_rn(x, safe)), the payload the plain version computes, from
// inv = __frcp_rn(safe) shared by the block. inv is within 2^-24 of 1/safe
// relative, so q = x * inv lies within 2^-23 |q| of x / safe, and the
// rounded quotient within 2^-24 |q|: both round to the same integer unless
// q is within 4e-7 |q| of a half-integer, where the exact division decides
// (as it does where inv or q is not finite: the test is then false).
__device__ __forceinline__ float rint_div(float x, float safe, float inv) {
  const float q = __fmul_rn(x, inv);
  const float r = rintf(q);
  return __fadd_rn(0.5f, -fabsf(__fadd_rn(q, -r))) > __fmul_rn(4e-7f, fabsf(q))
             ? r
             : rintf(__fdiv_rn(x, safe));
}

// Requantize one moment's block: the lane holds kPerLane values; every lane
// of the warp takes part in the shuffle, `active` lanes store.
__device__ __forceinline__ void quantize_block(const float (&val)[kPerLane], int8_t* q,
                                               float* s, int hl, bool active) {
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) amax = fmaxf(amax, fabsf(val[k]));
  amax = half_warp_max(amax);
  const float scale = __fdiv_rn(amax, 127.f);
  const float safe = scale > 0.f ? scale : 1.f;
  const float inv = __frcp_rn(safe);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const float r = fminf(fmaxf(rint_div(val[k], safe, inv), -127.f), 127.f);
    w[k / 4] |= (static_cast<uint32_t>(static_cast<int8_t>(r)) & 0xFFu) << (8 * (k % 4));
  }
  if (active) {
    *reinterpret_cast<uint4*>(q + hl * kPerLane) = make_uint4(w[0], w[1], w[2], w[3]);
    if (hl == 0) *s = scale;
  }
}

// Adam on elements [k0, k0 + 8) of the lane's 16 (mu, nu dequantized in m,
// v and updated in place), then the epilogue: eight at once from raw (the
// epilogue's prefetch) when vec, else those of the first `valid` one by one.
template <class Epi>
__device__ __forceinline__ void adam8_half(float (&m)[kPerLane], float (&v)[kPerLane],
                                           const float (&gf)[8], int k0, long long e0,
                                           bool vec, int valid, const Raw8& raw,
                                           const Adam8Hyper& h, const Epi& epi) {
  float o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m[k0 + k] = adam_mu(m[k0 + k], gf[k], h.b1, h.omb1);
    v[k0 + k] = adam_nu(v[k0 + k], gf[k], h.b2, h.omb2);
    o[k] = adam_step(m[k0 + k], v[k0 + k], h.inv_bc1, h.inv_bc2, h.eps, true);
  }
  if (vec) {
    epi.finish8(e0 + k0, raw, o);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k0 + k < valid) epi.finish1(e0 + k0 + k, o[k]);
  }
}

// Block b (row-major over (lead, nb)) of one leaf, by the half-warp whose
// lane is hl; an inactive half-warp (past the leaf's last block) computes on
// zeros so that the shuffles see a full warp, and stores nothing.
template <class Epi>
__device__ __forceinline__ void adam8_block(const char* g, const Adam8State& st, int b,
                                            bool active, int hl, const Adam8Hyper& h,
                                            const Epi& epi) {
  const int row = active ? b / st.nb : 0;  // 32-bit: a leaf has fewer than 2^31 blocks
  const int j = active ? b - row * st.nb : 0;
  const long long boff = (long long)b * kBlock;  // block start in the payloads
  const int col0 = j * kBlock + hl * kPerLane;
  const long long e0 = (long long)row * st.minor + col0;  // the lane's first element in the leaf
  const int valid = active ? max(0, min(kPerLane, st.minor - col0)) : 0;

  uint4 mq = make_uint4(0, 0, 0, 0), nq = mq;
  float ms = 0.f, ns = 0.f;
  if (active) {
    mq = *reinterpret_cast<const uint4*>(st.mu_q + boff + hl * kPerLane);
    nq = *reinterpret_cast<const uint4*>(st.nu_q + boff + hl * kPerLane);
    ms = st.mu_s[b];
    ns = st.nu_s[b];
  }
  const bool vec = valid == kPerLane && aligned16(g + e0 * dsize(h.g_dtype)) && epi.aligned(e0);
  Raw8 g0{}, g1{}, rp0{}, rp1{};
  if (vec) {
    g0 = load8(g, h.g_dtype, e0);
    g1 = load8(g, h.g_dtype, e0 + 8);
    rp0 = epi.prefetch8(e0);
    rp1 = epi.prefetch8(e0 + 8);
  }
  float m[kPerLane], v[kPerLane];
  unpack16_i8(mq, m);
  unpack16_i8(nq, v);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    m[k] = __fmul_rn(m[k], ms);
    v[k] = __fmul_rn(v[k], ns);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float gf[8];
    if (vec) {
      unpack8(half ? g1 : g0, h.g_dtype, gf);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        gf[k] = 8 * half + k < valid ? load_as_float(g, h.g_dtype, e0 + 8 * half + k) : 0.f;
    }
    adam8_half(m, v, gf, 8 * half, e0, vec, valid, half ? rp1 : rp0, h, epi);
  }
  quantize_block(m, st.mu_q + boff, st.mu_s + b, hl, active);
  quantize_block(v, st.nu_q + boff, st.nu_s + b, hl, active);
}

// Blocks [b0, b0 + steps * kHalves) of one leaf, one per half-warp per step.
template <class Epi>
__device__ __forceinline__ void adam8_chunk(const char* g, const Adam8State& st, long long b0,
                                            int steps, const Adam8Hyper& h, const Epi& epi) {
  const long long nblocks = (long long)st.lead * st.nb;
  const int half = threadIdx.x >> 4, hl = threadIdx.x & 15;
  for (int it = 0; it < steps; ++it) {
    const long long b = b0 + (long long)it * kHalves + half;
    if (b0 + (long long)it * kHalves >= nblocks) break;  // uniform over the CTA
    adam8_block(g, st, (int)b, b < nblocks, hl, h, epi);
  }
}

// Dtypes fixed at compile time: G (gradient; the update-only output takes
// it too), P and U (master and update), each a DType or kAny to read it from
// the arguments. The launchers instantiate the main path's combination,
// where every dtype switch folds away, and one all-kAny instance for the rest.
constexpr int kAny = -1;

template <int G>
__global__ void __launch_bounds__(kThreads) adam8_fused_kernel(const char* g, const Adam8State st,
                                                               Adam8Hyper h, WriteUpdate epi) {
  if (G != kAny) h.g_dtype = epi.dtype = G;
  adam8_chunk(g, st, (long long)blockIdx.x * kSteps * kHalves, kSteps, h, epi);
}

template <int G, int P, int U>
__global__ void __launch_bounds__(kThreads, kGroupMinCtas) adam8_group_kernel(
    const Adam8Leaf* __restrict__ leaves, const char* const* __restrict__ grads,
    const Chunk* __restrict__ chunks, int steps, Adam8Hyper h, ApplyArgs a) {
  if (G != kAny) h.g_dtype = G;
  if (P != kAny) a.p_dtype = P;
  if (U != kAny) a.u_dtype = U;
  const Chunk c = chunks[blockIdx.x];
  const Adam8Leaf L = leaves[c.leaf];
  const Adam8State st{L.mu_q, L.mu_s, L.nu_q, L.nu_s, L.lead, L.minor, L.nb};
  const ApplyToMaster epi{L.p, a, a.step_mix ^ L.master_salt};
  adam8_chunk(grads[c.leaf], st, (long long)c.chunk * steps * kHalves, steps, h, epi);
}

}  // namespace ssdt

extern "C" {

// g_dtype: 0 fp32, 1 bf16, 2 fp16 (the output takes the same dtype). The
// payloads and scales are updated in place.
int ssdt_adam8_fused(const void* g, void* mu_q, void* mu_s, void* nu_q, void* nu_s, void* out,
                     int lead, int minor, int nb, int g_dtype, float b1, float b2, float omb1,
                     float omb2, float eps, float inv_bc1, float inv_bc2, void* stream) {
  using namespace ssdt;
  const long long nblocks = (long long)lead * nb;
  if (nblocks <= 0) return 0;
  const Adam8State st{static_cast<int8_t*>(mu_q), static_cast<float*>(mu_s),
                      static_cast<int8_t*>(nu_q), static_cast<float*>(nu_s), lead, minor, nb};
  const Adam8Hyper h{b1, b2, omb1, omb2, eps, inv_bc1, inv_bc2, g_dtype};
  const WriteUpdate epi{static_cast<char*>(out), g_dtype};
  const long long per_cta = (long long)kSteps * kHalves;
  auto kernel = g_dtype == kBF16 ? adam8_fused_kernel<kBF16> : adam8_fused_kernel<kAny>;
  kernel<<<(unsigned int)((nblocks + per_cta - 1) / per_cta), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const char*>(g), st, h, epi);
  return (int)cudaGetLastError();
}

// One launch over every int8 leaf of a group. leaves: device array of
// Adam8Leaf; grads: device array of the gradients' addresses, one per leaf;
// chunks: device array of nchunks (leaf, chunk) pairs, a chunk being
// steps * 16 blocks. The update takes u_dtype (the gradient's); step_mix,
// wd_p and step_u as for ssdt_adam_bf16_group. State and masters are
// updated in place.
int ssdt_adam8_group(const void* leaves, const void* grads, const void* chunks, int nchunks,
                     int steps, int g_dtype, int p_dtype, int u_dtype, float b1, float b2,
                     float omb1, float omb2, float eps, float inv_bc1, float inv_bc2, int has_wd,
                     float wd_p, float step_u, unsigned int step_mix, void* stream) {
  using namespace ssdt;
  if (nchunks <= 0) return 0;
  const Adam8Hyper h{b1, b2, omb1, omb2, eps, inv_bc1, inv_bc2, g_dtype};
  const ApplyArgs a{p_dtype, u_dtype, has_wd, 0, wd_p, step_u, step_mix};
  auto kernel = adam8_group_kernel<kAny, kAny, kAny>;
  if (g_dtype == kBF16 && p_dtype == kBF16 && u_dtype == kBF16)
    kernel = adam8_group_kernel<kBF16, kBF16, kBF16>;  // AdamW8bit, bf16 masters
  else if (g_dtype == kF32 && p_dtype == kBF16 && u_dtype == kF32)
    kernel = adam8_group_kernel<kF32, kBF16, kF32>;  // the same under gradient accumulation
  kernel<<<(unsigned int)nchunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Adam8Leaf*>(leaves), static_cast<const char* const*>(grads),
      static_cast<const Chunk*>(chunks), steps, h, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
