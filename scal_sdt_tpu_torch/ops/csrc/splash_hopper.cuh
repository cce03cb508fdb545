// Hopper pieces of the splash kernels (sm_90a), forward and backward:
// mbarriers, TMA tile loads and stores, wgmma shared-memory descriptors and
// fences, register reallocation, and the warpgroup helpers both kernels'
// consumers share (turns at issuing, the score and P W products, fragments).
//
// Tile layout in shared memory ("chunk-major"): a tile of R rows and DP
// columns (DP a multiple of 16) is DP / 8 chunks of 8 columns, chunk c
// holding its R rows of 16 bytes back to back: element (r, 8c + e) sits at
// byte (c * R + r) * 16 + 2e. Every 8 x 8 core matrix of a wgmma operand is
// then 128 contiguous bytes, so one tile serves both as a K-major operand
// (K = the columns: S = Q K^T) and as an MN-major one (K = the rows:
// dq += dS K), with no swizzle. One TMA copy per tile writes it, from a 5-d
// tensor map over (8 columns, rows, chunks, heads, batch) of a (B, H, L, D)
// view (ops/splash.py `tma_geometry`); chunks past D and rows past L arrive
// as zeros.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splash_common.cuh"
#include "wgmma.cuh"

namespace ssdt {

constexpr int kGroupRows = 64;  // rows of one consumer warpgroup (wgmma M)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA

// One tile of a 5-d tensor map into shared memory; completes `bytes` (the
// whole box, zero-filled parts included) on `bar`.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}

// One tile from shared memory to a 5-d tensor map; parts outside the map's
// dims (rows past L, chunks past D) are not written. Completes on the
// issuing thread's bulk group; the threads that wrote the tile must first
// fence it for the async proxy (fence_async_smem) and sync with the issuer.
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
// Commit the issued stores and wait until their reads of shared memory are
// done (the tile may then be reused or the CTA exit).
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to the async proxy (TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

template <typename... Maps>
__device__ __forceinline__ void prefetch_maps(const Maps&... maps) {
  (tma_prefetch_map(&maps), ...);
}

// ---------------------------------------------------------------------------
// wgmma

// Descriptor of a chunk-major tile operand (no swizzle): `lbo` is the byte
// step between the two 8-wide core matrices of one k16 step, `sbo` the
// byte step between core matrices along M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// A tile of R rows read K-major (K along its columns): rows r.. of the tile
// at `p` + r * 16 bytes; k16 step kk at + kk * 2 * R * 16 bytes.
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return smem_desc(p, R * 16, 128);
}
// The same tile read MN-major (K along its rows, N along its columns):
// k16 step kk (rows 16 kk..) at + kk * 256 bytes.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p) {
  return smem_desc(p, 128, R * 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Named barriers 1-15 (0 is __syncthreads): `count` threads, a multiple
// of 32, of which those calling arrive do not wait.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Register reallocation between warpgroups (all warps of the group).
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// setmaxnreg budget of NC > 1 consumer warpgroups beside the producer
// group: the CTA launches at 65536 / threads registers a thread (a multiple
// of 8), the producer group drops to 24 and the consumers share the rest,
// at most 240 each (NC = 2: 384 * 168 = 128 * 24 + 256 * 240).
template <int NC>
struct Regs {
  static constexpr int launch = 65536 / ((NC + 1) * 128) / 8 * 8, producer = 24;
  static constexpr int share = (launch * (NC + 1) * 128 - 128 * producer) / (NC * 128) / 8 * 8;
  static constexpr int consumer = share < 240 ? share : 240;
};

template <int NC>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NC > 1) regs_dealloc<Regs<NC>::producer>();
}
template <int NC>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NC > 1) regs_alloc<Regs<NC>::consumer>();
}

// ---------------------------------------------------------------------------
// Consumer warpgroups

// Turns of NC consumer warpgroups at issuing products: group w issues only
// after group w - 1 (mod NC) has issued its own, so the tensor cores run
// one group's products while the others compute their exponentials. Named
// barrier 1 + w: group w's 128 threads wait there for the 128 of group
// w - 1; the last group's arrival at construction gives group 0 the first
// turn. Every group takes the same number of turns. One group takes none.
template <int NC>
struct Turns {
  int wg;
  __device__ __forceinline__ explicit Turns(int group) : wg(group) {
    if constexpr (NC > 1) {
      if (wg == NC - 1) named_bar_arrive(1, 256);
    }
  }
  __device__ __forceinline__ void take() const {
    if constexpr (NC > 1) named_bar_sync(1 + wg, 256);
  }
  // last: this group's final turn, after which group 0 takes none.
  __device__ __forceinline__ void pass(bool last) const {
    if constexpr (NC > 1) {
      if (!(last && wg == NC - 1)) named_bar_arrive(1 + (wg + 1) % NC, 256);
    }
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A warpgroup's fixed A operand over the head dim (q in the forward and dq,
// dO in dq, k or v in dkv): its 64 rows of a chunk-major tile of RA rows,
// read by descriptor (InRegs = false) or held as k16 register fragments
// loaded once by ldmatrix (InRegs = true). times_bt: c = A B^T with B a
// K-major tile of N rows; DP / 16 k16 steps.
template <int DP, int RA, bool InRegs>
struct OperandA;

template <int DP, int RA>
struct OperandA<DP, RA, false> {
  const unsigned char* rows;
  __device__ __forceinline__ void load(const unsigned char* group_rows) { rows = group_rows; }
  template <int N>
  __device__ __forceinline__ void times_bt(float (&c)[N / 2], const unsigned char* b) const {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<N>::template ss<0>(c, desc_kmajor<RA>(rows + kk * 2 * RA * 16),
                               desc_kmajor<N>(b + kk * 2 * N * 16), kk > 0);
  }
};

template <int DP, int RA>
struct OperandA<DP, RA, true> {
  uint32_t f[DP / 16][4];
  // ldmatrix x4 per k16 step: lanes 0-15 address rows 0-15 of the warp's 16
  // in chunk 2 kk, lanes 16-31 the same rows in chunk 2 kk + 1.
  __device__ __forceinline__ void load(const unsigned char* group_rows) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const unsigned char* row = group_rows + (warp * 16 + (lane & 15)) * 16;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldsm_x4(f[kk], smem_u32(row + (2 * kk + (lane >> 4)) * RA * 16));
  }
  template <int N>
  __device__ __forceinline__ void times_bt(float (&c)[N / 2], const unsigned char* b) const {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<N>::template rs<0>(c, f[kk], desc_kmajor<N>(b + kk * 2 * N * 16), kk > 0);
  }
};

// acc += P W over the K rows of a tile: P in k16 register fragments, W the
// K-row tile at `w` read MN-major (N = DP).
template <int DP, int K>
__device__ __forceinline__ void gemm_pw(float (&acc)[DP / 2], const uint32_t (&p)[K / 16][4],
                                        const unsigned char* w) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    Wgmma<DP>::template rs<1>(acc, p[kk], desc_mnmajor<K>(w + kk * 256), 1);
}

// n8 accumulator tile n (rows g, g + 8; columns 8n + 2t, +1) packed as the
// half of k16 fragment n / 2 it feeds.
template <int N>
__device__ __forceinline__ void pack_frag(uint32_t (&f)[N / 16][4], int n, float x0, float x1,
                                          float x2, float x3) {
  f[n / 2][(n & 1) * 2] = pack_bf16(x0, x1);
  f[n / 2][(n & 1) * 2 + 1] = pack_bf16(x2, x3);
}

// One consumer thread's rows g, g + 8 of an accumulator over the head dim
// as bf16 into rows row, row + 8 of a (B, H, L, D) view; rows past nrows and
// columns past D are skipped.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], bf16* dst, long long sl,
                                           int row, int nrows, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    if (n * 8 >= D) continue;
    const int col = n * 8 + 2 * t;
    if (row < nrows)
      *reinterpret_cast<uint32_t*>(dst + (long long)row * sl + col) =
          pack_bf16(acc[4 * n], acc[4 * n + 1]);
    if (row + 8 < nrows)
      *reinterpret_cast<uint32_t*>(dst + (long long)(row + 8) * sl + col) =
          pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps

// cuTensorMapEncodeTiled, looked up through the runtime (the library links
// no libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 tile map from `geo` (9 values from ops/splash.py `tma_geometry`:
// dims (8, L, D / 8, H, B) and byte strides of dims 1-4) with a box of
// `rows` rows and `chunks` chunks. Returns false if the encoder refuses it.
inline bool encode_tile_map(CUtensorMap* map, const void* base, const long long* geo, int rows,
                            int chunks) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[5], strides[4];
  for (int i = 0; i < 5; ++i) dims[i] = (cuuint64_t)geo[i];
  for (int i = 0; i < 4; ++i) strides[i] = (cuuint64_t)geo[5 + i];
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)chunks, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Ready a kernel instance on the current device: its register count
// checked (setmaxnreg.inc waits for registers the launch did not give, so a
// build whose entry count would leave the consumers waiting forever is
// refused) and its shared memory allowed. cudaSetDevice also makes the
// device's primary context current in this thread (autograd runs the
// backward on a thread of its own), which cuTensorMapEncodeTiled needs.
template <int NC, typename Kernel>
int ready_kernel(Kernel kernel, size_t smem) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (NC > 1 && attr.numRegs < Regs<NC>::launch) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace ssdt
