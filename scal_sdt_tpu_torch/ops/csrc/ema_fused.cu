// Exponential moving average of the trainable UNet masters, for Hopper
// (sm_90a).
//
// Not the port of a TPU kernel: the JAX package computes the EMA in XLA
// (training/ema.py ema_update, fused into its update program). Here it is one
// launch per step over a leaf table in device memory that holds every shadow
// of one (shadow dtype, master dtype) pair, the design of the grouped
// optimizer launches (adam_common.cuh), where a plain chain over SD1.5's 686
// leaves would issue several thousand launches per step and a launch per
// param group hundreds in a LoRA run (192 in lora.yaml's). No scalar differs
// between the leaves: the decay and the step are the step's, the salts the
// leaves' own. It runs after the optimizer's launch in stream order, so it
// reads the updated masters.
//
// Per element, each operation rounded on its own as the plain chain rounds
// it (__fsub_rn / __fmul_rn: nvcc never contracts them into an fma):
//   new = s - (1 - decay_t) * (s - p)                       (fp32)
// then the shadow store: a bf16 shadow by stochastic rounding with 16 bits
// of the counter hash at the train step, the low half of the master SR
// store's own hash (salt crc32(key) ^ 0xE3A0001) where the master is bf16,
// else the high half of a hash salted crc32(key) ^ 0xE3A0002; an fp32
// shadow stored as it is.
//
// What bounds it on an H100: bytes. Per element it reads the shadow and the
// master and writes the shadow (10 bytes for an fp32 shadow of bf16 masters,
// 6 for a bf16 one) for 3 flops and ~10 integer operations of the hash. Each
// thread moves eight elements of each tensor at a time with 16-byte accesses
// (two for fp32); a CTA owns one chunk of one leaf, mapped by the same
// (leaf, chunk) list as the optimizer's grouped launches.

#include "adam_common.cuh"

namespace ssdt {

constexpr int kEmaThreads = 256;

// A leaf of an EMA table, as ops/ema_fused.py packs it (32 bytes).
struct EmaLeaf {
  char* shadow;
  const char* master;
  long long n;
  uint32_t salt;  // crc32(key) ^ 0xE3A0001 (low half) or ^ 0xE3A0002 (high half)
  uint32_t pad;
};
static_assert(sizeof(EmaLeaf) == 32, "EmaLeaf layout must match ops/ema_fused.py");

struct EmaArgs {
  int low_half;       // bf16 shadow: 1 takes the hash's low 16 bits, 0 its high 16
  float one_minus;    // 1 - decay_t, in fp32
  uint32_t step_mix;  // step * 0x9E3779B9; a leaf's seed is step_mix ^ its salt
};

__device__ __forceinline__ float ema_value(float s, float p, float om) {
  return __fsub_rn(s, __fmul_rn(om, __fsub_rn(s, p)));
}

// The bf16 pattern of x stochastically rounded with the dither of element i.
__device__ __forceinline__ uint16_t ema_sr_bits(float x, uint32_t i, uint32_t seed, int low) {
  const uint32_t h = cheap_dither_u32(i, seed);
  return static_cast<uint16_t>((__float_as_uint(x) + (low ? (h & 0xFFFFu) : (h >> 16))) >> 16);
}

// S, P: the shadows' and the masters' dtype (kF32 or kBF16).
template <int S, int P>
__global__ void __launch_bounds__(kEmaThreads) ema_group_kernel(
    const EmaLeaf* __restrict__ leaves, const Chunk* __restrict__ chunks, long long chunk,
    EmaArgs a) {
  const Chunk c = chunks[blockIdx.x];
  const EmaLeaf L = leaves[c.leaf];
  const long long s = (long long)c.chunk * chunk;
  const long long e = min(L.n, s + chunk);
  const uint32_t seed = a.step_mix ^ L.salt;
  constexpr bool sr = S == kBF16;

  // eight-element groups from the first index at which both tensors are
  // 16-byte aligned; the elements before it and the ragged end one by one
  int al = -1;
  for (int k = 0; k < 8 && al < 0; ++k)
    if (aligned16(L.shadow + k * dsize(S)) && aligned16(L.master + k * dsize(P)))
      al = k;
  long long v0 = e, v1 = e;
  if (al >= 0) {
    v0 = min(e, s + ((al - s) & 7));
    v1 = v0 + ((e - v0) & ~7LL);
  }

  for (long long i = v0 + 8LL * threadIdx.x; i < v1; i += 8LL * blockDim.x) {
    const Raw8 rs = load8(L.shadow, S, i);
    const Raw8 rp = load8(L.master, P, i);
    float sv[8], pv[8];
    unpack8(rs, S, sv);
    unpack8(rp, P, pv);
    if (sr) {
      uint16_t b[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        b[k] = ema_sr_bits(ema_value(sv[k], pv[k], a.one_minus), (uint32_t)(i + k), seed,
                           a.low_half);
      store8_bits16(L.shadow, i, b);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) sv[k] = ema_value(sv[k], pv[k], a.one_minus);
      store8_rn(L.shadow, S, i, sv);
    }
  }

  const long long head = v0 - s, rest = head + (e - v1);
  for (long long t = threadIdx.x; t < rest; t += blockDim.x) {
    const long long i = t < head ? s + t : v1 + (t - head);
    const float x = ema_value(load_as_float(L.shadow, S, i),
                              load_as_float(L.master, P, i), a.one_minus);
    if (sr)
      reinterpret_cast<uint16_t*>(L.shadow)[i] = ema_sr_bits(x, (uint32_t)i, seed, a.low_half);
    else
      store_rn(L.shadow, S, i, x);
  }
}

}  // namespace ssdt

extern "C" {

// One EMA launch over every leaf of a table. leaves: device array of
// EmaLeaf; chunks: device array of nchunks (leaf, chunk) pairs, chunk =
// elements per chunk (a multiple of 8). dtypes: 0 fp32, 1 bf16 (shadow,
// master; the port keeps masters and shadows in no other). one_minus: 1 -
// decay_t in fp32; step_mix = step * 0x9E3779B9. The shadows are updated in
// place.
int ssdt_ema_group(const void* leaves, const void* chunks, int nchunks, long long chunk,
                   int s_dtype, int p_dtype, int low_half, float one_minus,
                   unsigned int step_mix, void* stream) {
  using namespace ssdt;
  if (nchunks <= 0) return 0;
  const EmaArgs a{low_half, one_minus, step_mix};
  void (*kernel)(const EmaLeaf*, const Chunk*, long long, EmaArgs) = nullptr;
  if (s_dtype == kF32 && p_dtype == kBF16)
    kernel = ema_group_kernel<kF32, kBF16>;   // fp32 shadow of bf16 masters
  else if (s_dtype == kBF16 && p_dtype == kBF16)
    kernel = ema_group_kernel<kBF16, kBF16>;  // bf16 shadow of bf16 masters
  else if (s_dtype == kF32 && p_dtype == kF32)
    kernel = ema_group_kernel<kF32, kF32>;    // fp32 masters (the default, LoRA factors)
  else if (s_dtype == kBF16 && p_dtype == kF32)
    kernel = ema_group_kernel<kBF16, kF32>;
  else
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)nchunks, kEmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const EmaLeaf*>(leaves), static_cast<const Chunk*>(chunks), chunk, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
