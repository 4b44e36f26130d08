// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point (hvd_flash_fwd) that ops/flash_attention.py loads with
// ctypes.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py
// _fwd_kernel (launched by _flash_fwd through pl.pallas_call). It keeps that
// kernel's semantics, not its block structure:
//   * exact attention with an online softmax: running max m, running sum l
//     and an fp32 output accumulator per query row; scale is the caller's
//     sm_scale (1/sqrt(D) by default), applied to the fp32 dot product;
//   * masked scores are those of keys past S_k and, when causal, of keys
//     after the query (q_off + row >= k_off + col on global positions);
//   * q_off and k_off are read from int32 device memory, so a caller can
//     pass positions computed on the device without a host sync;
//   * when causal, key tiles wholly above the diagonal are skipped;
//   * P is rounded to V's dtype before the P.V product (bf16 in training),
//     while l sums the unrounded fp32 P;
//   * l is clamped at 1e-30; out is written in the input dtype and the
//     per-row lse = m + ln(l) in fp32, in natural-log units.
// sm_scale must be positive (the wrapper checks): the bf16/fp16 kernel
// takes each row's max on the raw scores.
//
// One difference, on purpose: a query row that sees no key at all. In the
// TPU kernel its answer depends on the tiling: 0 when its whole q-tile
// precedes the key range (every key block is skipped), a uniform average
// of V otherwise (masked scores of -1e30 give exp(-1e30 + 1e30) = 1 while m
// is still -1e30). Here a masked score contributes exactly 0 to l and to
// the output, so every such row gives out = 0 and lse ~ -1e30 whatever the
// tiling. Rows that see at least one key are unaffected.
//
// What bounds it on an H100 SXM at the training shape (BH = 8 x 12 heads,
// S = 2048, D = 64, bf16, causal):
//   operations: 4 * 96 * 2048 * 2049 / 2 * 64 = 51.6 GFLOP, 52 us at
//   989 TFLOP/s;
//   bytes: q, k, v, out (25.2 MB each) + lse (0.8 MB) = 101 MB, 30 us at
//   3.35 TB/s.
// So the bound is the tensor cores, about 52 us a call. At D = 64 the
// softmax is nearly as heavy: one ex2 per score at the special-function
// units' 16 a clock per SM takes as long as the score's 256 tensor-core
// operations, and each score needs about five other ALU instructions
// besides, so the design is about running the softmax of some warpgroups
// beside the products of others.
//
// Two kernels, one per input type:
//
// flash_fwd_wgmma (bf16, fp16: the training path). Persistent: one thread
// block per SM walks work tiles (a batch*head and a q-tile of 64 rows per
// consumer warpgroup), heaviest causal q-tiles first, dealt out in a
// serpentine over the blocks. Warpgroups:
//   * a producer (32-40 registers a thread after setmaxnreg) whose one
//     elected thread issues TMA copies: each work tile's Q tile once (after
//     the consumers' last read of the previous one), then the 128-key K and
//     V tiles through a ring of kStages stages guarded by full and empty
//     mbarriers, running ahead into the next work tile. The tensor maps are
//     3-D over (D, S, BH), so rows past S of one head are zero-filled by
//     the hardware and never read from the next head. Tiles land in the
//     128/64/32-byte swizzled layout that matches the row width (2 * D
//     bytes, two 128-byte column halves at D = 128);
//   * three consumers at D <= 64 (160 registers), two at D = 128 (232),
//     64 query rows each. They take turns, round robin through named
//     barriers, at issuing their products, so that while one warpgroup's
//     products use the tensor cores the others run their softmax. In a
//     turn a consumer issues S = Q K^T of key tile t (wgmma m64n128k16,
//     both operands K-major in shared memory, D/16 k-steps, fp32
//     accumulators) and O += P V of tile t-1 (wgmma m64nDk16 with P from
//     registers as the A operand: the score accumulators' layout is the
//     A-fragment layout, so rounding to V's type is the only conversion;
//     V is read from shared memory as an MN-major B operand, with no
//     transposed copy). Then the online softmax of tile t on the
//     accumulator registers, in log2 units: the row max of the raw scores
//     across the 4 lanes of a row with two shuffles, then one FFMA (scale *
//     log2(e) folded in) and one ex2.approx a score. The mask is evaluated
//     only on tiles that straddle the causal diagonal or S_k's edge,
//     decided per warpgroup from the offsets on the device; a masked score
//     is -inf and adds exactly 0.
//   * Epilogue: O / l is rounded to the input type, staged through a
//     shared-memory tile of its own in the swizzled layout and written by a
//     TMA store, which clips rows past S_q and is waited for only before the
//     block's next epilogue; lse by plain stores.
//
// flash_fwd_scalar (fp32, tests and small callers): 256 threads, 4 adjacent
// lanes per query row, each lane owning D/4 of the row's dims as float4
// groups; scores are fp32 FMAs on the CUDA cores, reduced across the 4
// lanes by an xor butterfly that leaves the same sum on each, so all keep
// identical m and l. Products of fp32 inputs stay exact fp32, as on the TPU.
//
// Ragged S_q and S_k are masked in the kernels; nothing is padded.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// key tiles a q-tile of `rows` rows needs: when causal, tile t is needed iff
// its first key is at or before the tile's last query
__device__ __forceinline__ int needed_key_tiles(int rows, int qt, int sq,
                                                int sk, int bk, int causal,
                                                int q_off, int k_off) {
  const int all = (sk + bk - 1) / bk;
  if (!causal) return all;
  const int q_last = q_off + min((qt + 1) * rows, sq) - 1;
  const int diff = q_last - k_off;
  return diff < 0 ? 0 : min(diff / bk + 1, all);
}

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, stride byte offset
// between 8-row groups (16-byte units) and the swizzle layout type. The
// leading byte offset is unused (1): every k-step of a K-major operand, and
// every MN-major operand, lies within one swizzle atom along its row.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// named barrier `id` over `n` threads: sync waits, arrive does not
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching the accumulators of an async wgmma
// before the wait that follows it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HVD_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HVD_F8(d, i) HVD_F4(d, i), HVD_F4(d, i + 4)
#define HVD_F16(d, i) HVD_F8(d, i), HVD_F8(d, i + 8)
#define HVD_F32(d, i) HVD_F16(d, i), HVD_F16(d, i + 16)
#define HVD_F64(d, i) HVD_F32(d, i), HVD_F32(d, i + 32)

// D (64 x 128, fp32) (+)= A (64 x 16) * B (16 x 128), A and B K-major in
// shared memory; `accumulate` 0 overwrites D
#define HVD_WGMMA_SS_N128(TY)                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"        \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
  "%56, %57, %58, %59, %60, %61, %62, %63"                             \
  "}, %64, %65, p, 1, 1, 0, 0;\n}\n"

// D (64 x N, fp32) += A (64 x 16, registers) * B (16 x N), B MN-major in
// shared memory
#define HVD_WGMMA_RS_N16(TY)                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"         \
  "%0, %1, %2, %3, %4, %5, %6, %7"                                     \
  "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
#define HVD_WGMMA_RS_N32(TY)                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"         \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15"                               \
  "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
#define HVD_WGMMA_RS_N64(TY)                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
  "%24, %25, %26, %27, %28, %29, %30, %31"                             \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (kIsBf16<T>) {
    asm volatile(HVD_WGMMA_SS_N128("bf16")
                 : HVD_F64(d, 0)
                 : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(HVD_WGMMA_SS_N128("f16")
                 : HVD_F64(d, 0)
                 : "l"(da), "l"(db), "r"(accumulate));
  }
}

// accumulates into d[OFF .. OFF + N/2)
template <typename T, int N, int OFF, int M>
__device__ __forceinline__ void wgmma_pv(float (&d)[M], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) {
    if constexpr (kIsBf16<T>) {
      asm volatile(HVD_WGMMA_RS_N16("bf16")
                   : HVD_F8(d, OFF)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
    } else {
      asm volatile(HVD_WGMMA_RS_N16("f16")
                   : HVD_F8(d, OFF)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
    }
  } else if constexpr (N == 32) {
    if constexpr (kIsBf16<T>) {
      asm volatile(HVD_WGMMA_RS_N32("bf16")
                   : HVD_F16(d, OFF)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
    } else {
      asm volatile(HVD_WGMMA_RS_N32("f16")
                   : HVD_F16(d, OFF)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
    }
  } else {
    static_assert(N == 64, "P.V products are 16, 32 or 64 columns wide");
    if constexpr (kIsBf16<T>) {
      asm volatile(HVD_WGMMA_RS_N64("bf16")
                   : HVD_F32(d, OFF)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
    } else {
      asm volatile(HVD_WGMMA_RS_N64("f16")
                   : HVD_F32(d, OFF)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
    }
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (kIsBf16<T>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, fp16)
// ---------------------------------------------------------------------------

constexpr int kKeyTile = 128;  // keys per K/V tile
constexpr int kWgThreads = 128;
constexpr int kTurnBar = 4;  // named barriers 4.. : turns of consumers 0..

template <int D>
struct Tiles {
  // consumer warpgroups of 64 query rows each; the producer warpgroup comes
  // after them. Registers: producer + consumers within 65,536 a block
  static constexpr int kConsumers = D <= 64 ? 3 : 2;
  static constexpr int kQTile = 64 * kConsumers;  // query rows per block
  static constexpr int kThreads = (kConsumers + 1) * kWgThreads;
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 232;
  static_assert(kWgThreads * (kProducerRegs + kConsumers * kConsumerRegs) <=
                    65536,
                "registers of one block");
  // bytes of a swizzled shared-memory row: the whole row of 2*D bytes, in
  // 128-byte column halves at D = 128
  static constexpr int kSwz = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kHalves = 2 * D / kSwz;
  static constexpr int kHalfCols = kSwz / 2;
  static constexpr int kStepsPerHalf = kSwz / 32;  // 16-wide k-steps
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kTileBytes = kKeyTile * 2 * D;
  static constexpr int kQBytes = kQTile * 2 * D;
  static constexpr int kHalfBytes = kKeyTile * kSwz;
  static constexpr uint32_t kSbo = 8 * kSwz / 16;  // 8-row groups, 16 B units
  // wgmma layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint32_t kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;
  static constexpr int kBarriers = 2 + 3 * kStages;
  static constexpr int kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// byte offset of element (row, col) of a q-tile (Q, or O staged for its
// store) in its swizzled layout (Swizzle<B,4,3>: address bits 7.. XOR-ed
// into the 16-byte chunk)
template <int D>
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  using L = Tiles<D>;
  const uint32_t off = (col / L::kHalfCols) * (L::kQTile * L::kSwz) +
                       row * L::kSwz +
                       (col % L::kHalfCols) * 2;
  return off ^ ((off >> 3) & ((L::kSwz / 16 - 1) << 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o,
                    float* __restrict__ lse, const int* __restrict__ q_offset,
                    const int* __restrict__ k_offset, int bh_count, int sq,
                    int sk, int causal, float scale_log2) {
  using L = Tiles<D>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  uint8_t* const gbase = smem_raw + (base - raw);
  constexpr int kQTile = L::kQTile;
  constexpr int kQHalf = kQTile * L::kSwz;  // bytes of a Q column half
  const uint32_t q_tile = base;
  const uint32_t o_tile = base + L::kQBytes;  // O staged for its TMA store
  const uint32_t k_tiles = o_tile + L::kQBytes;
  const uint32_t v_tiles = k_tiles + S * L::kTileBytes;
  const uint32_t bars = v_tiles + S * L::kTileBytes;
  const uint32_t q_full = bars;
  const uint32_t q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + S + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + 2 * S + s); };

  // Persistent blocks: the block's i-th work tile (a batch*head and a
  // q-tile) is dealt out in a serpentine over the blocks, heaviest causal
  // q-tiles first, so that a block's next tile loads while this one ends.
  const int n_qt = (sq + kQTile - 1) / kQTile;
  const int n_tiles = n_qt * bh_count;
  auto work = [&](int i, int* bh, int* qt) {
    const int b = static_cast<int>(blockIdx.x);
    const int w = i * static_cast<int>(gridDim.x) +
                  ((i & 1) ? static_cast<int>(gridDim.x) - 1 - b : b);
    *qt = n_qt - 1 - w / bh_count;
    *bh = w % bh_count;
    return w < n_tiles;
  };
  const int q_off = *q_offset;
  const int k_off = *k_offset;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, L::kConsumers);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), L::kConsumers);  // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == L::kConsumers) {
    // ---- producer: one thread keeps the TMA copies in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        L::kProducerRegs));
    if (threadIdx.x == L::kConsumers * kWgThreads) {
      int it = 0;  // K/V tiles loaded over all work tiles
      int bh, qt;
      for (int i = 0; work(i, &bh, &qt); ++i) {
        const int n_kt = needed_key_tiles(kQTile, qt, sq, sk, kKeyTile,
                                          causal, q_off, k_off);
        if (i > 0) mbar_wait(q_empty, (i - 1) & 1);
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          tma_load(q_tile + h * kQHalf, &tm_q, q_full, h * L::kHalfCols,
                   qt * kQTile, bh);
        }
        for (int t = 0; t < n_kt; ++t, ++it) {
          const int s = it % S;
          const int round = it / S;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            tma_load(k_tiles + s * L::kTileBytes + h * L::kHalfBytes, &tm_k,
                     k_full(s), h * L::kHalfCols, t * kKeyTile, bh);
          }
          mbar_expect_tx(v_full(s), L::kTileBytes);
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            tma_load(v_tiles + s * L::kTileBytes + h * L::kHalfBytes, &tm_v,
                     v_full(s), h * L::kHalfCols, t * kKeyTile, bh);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        L::kConsumerRegs));
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;  // row group of the accumulator fragments
    const int c = tid % 4;         // column pair within the group
    // of the current work tile: the warpgroup's first row, rows a and b of
    // this lane, and the local keys visible to them (those below lim)
    int bh, qt, row_wg, ra, rb, lim_a, lim_b;
    int it = 0;  // key tiles consumed over all work tiles

    constexpr int ND = D / 2;  // output accumulators a thread
    float o[ND];
    float sc[64];  // scores, then P: n-block j holds keys 8j + 2c + {0, 1}
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    // running max in log2 units, and this lane's share of its rows' sums
    float m_a, m_b, l_a, l_b;

    uint32_t pa[8][4];  // P of the previous tile, the A operand of P.V

    // S = Q K^T of the tile in stage s, into sc (issued, not waited for)
    auto issue_qk = [&](int s) {
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        const uint32_t k_off_b = (e / L::kStepsPerHalf) * L::kHalfBytes +
                                 (e % L::kStepsPerHalf) * 32;
        const uint32_t q_off_b = (e / L::kStepsPerHalf) * kQHalf +
                                 (e % L::kStepsPerHalf) * 32;
        const uint64_t da = gmma_desc(q_tile + q_off_b + wg * 64 * L::kSwz,
                                      L::kSbo, L::kLayout);
        const uint64_t db = gmma_desc(k_tiles + s * L::kTileBytes + k_off_b,
                                      L::kSbo, L::kLayout);
        wgmma_qk<T>(sc, da, db, e > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage s (issued, not waited for)
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t v_at = v_tiles + s * L::kTileBytes + e * 16 * L::kSwz;
        wgmma_pv<T, D / L::kHalves, 0>(
            o, pa[e], gmma_desc(v_at, L::kSbo, L::kLayout));
        if constexpr (L::kHalves == 2) {  // dims 64-127 from the second half
          wgmma_pv<T, 64, 32>(o, pa[e],
                              gmma_desc(v_at + L::kHalfBytes, L::kSbo,
                                        L::kLayout));
        }
      }
      wgmma_commit();
    };
    // the online softmax of the raw scores in sc for keys k0..: sc becomes
    // P, m and l move on; returns the factors that rescale O to the new max.
    // scale_log2 > 0, so the row max of the raw scores, scaled, is the max
    // of the scaled scores, and each P is one FFMA and one ex2.
    auto softmax = [&](int k0, float* corr_a, float* corr_b) {
      // element e of n-block j: row (e < 2 ? a : b), key k0 + 8j + 2c + (e&1)
      const bool edge = k0 + kKeyTile > sk ||
                        (causal && q_off + row_wg < k_off + k0 + kKeyTile - 1);
      if (edge) {
        const float kMinusInf = __uint_as_float(0xff800000u);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * c + (e & 1);
            if (key >= (e < 2 ? lim_a : lim_b)) sc[4 * j + e] = kMinusInf;
          }
        }
      }
      // four partial maxima and sums a row, for instruction-level parallelism
      float pm_a[4], pm_b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pm_a[j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
        pm_b[j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
      }
#pragma unroll
      for (int j = 4; j < 16; ++j) {
        pm_a[j % 4] = fmaxf(pm_a[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
        pm_b[j % 4] = fmaxf(pm_b[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float mx_a = fmaxf(fmaxf(pm_a[0], pm_a[1]), fmaxf(pm_a[2], pm_a[3]));
      float mx_b = fmaxf(fmaxf(pm_b[0], pm_b[1]), fmaxf(pm_b[2], pm_b[3]));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      mx_a = fmaxf(m_a, mx_a * scale_log2);  // a row all masked keeps m
      mx_b = fmaxf(m_b, mx_b * scale_log2);
      *corr_a = ex2(m_a - mx_a);
      *corr_b = ex2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float ps_a[4] = {0.f, 0.f, 0.f, 0.f}, ps_b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // a masked score is -inf, and ex2(-inf) is exactly 0
        sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -mx_a));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -mx_a));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -mx_b));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -mx_b));
        ps_a[j % 4] += sc[4 * j] + sc[4 * j + 1];
        ps_b[j % 4] += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l_a = l_a * *corr_a + ((ps_a[0] + ps_a[1]) + (ps_a[2] + ps_a[3]));
      l_b = l_b * *corr_b + ((ps_b[0] + ps_b[1]) + (ps_b[2] + ps_b[3]));
    };
    // the scores of n-blocks 2e, 2e+1 are the A fragment of k-step e;
    // packing rounds P to V's dtype
    auto pack_p = [&]() {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pa[e][0] = pack2<T>(sc[8 * e], sc[8 * e + 1]);
        pa[e][1] = pack2<T>(sc[8 * e + 2], sc[8 * e + 3]);
        pa[e][2] = pack2<T>(sc[8 * e + 4], sc[8 * e + 5]);
        pa[e][3] = pack2<T>(sc[8 * e + 6], sc[8 * e + 7]);
      }
    };

    // The consumer warpgroups take turns, round robin, at issuing their
    // products (named barrier kTurnBar + wg over this warpgroup and the one
    // before it), so that the others' softmax runs while one warpgroup's
    // products use the tensor cores. The last consumer opens the first turn
    // to consumer 0.
    auto turn_begin = [&]() { named_sync(kTurnBar + wg, 2 * kWgThreads); };
    auto turn_end = [&]() {
      named_arrive(kTurnBar + (wg + 1) % L::kConsumers, 2 * kWgThreads);
    };
    if (wg == L::kConsumers - 1) turn_end();

    for (int i = 0; work(i, &bh, &qt); ++i) {
      const int n_kt = needed_key_tiles(kQTile, qt, sq, sk, kKeyTile, causal,
                                        q_off, k_off);
      row_wg = qt * kQTile + wg * 64;
      ra = row_wg + warp * 16 + g;
      rb = ra + 8;
      lim_a = causal ? min(sk, q_off + ra - k_off + 1) : sk;
      lim_b = causal ? min(sk, q_off + rb - k_off + 1) : sk;
#pragma unroll
      for (int j = 0; j < ND; ++j) o[j] = 0.f;
      m_a = m_b = kNegInf * kLog2e;  // -1e30 in natural-log units
      l_a = l_b = 0.f;
      auto stage = [&](int t) { return (it + t) % S; };
      auto parity = [&](int t) {
        return static_cast<uint32_t>((it + t) / S) & 1;
      };
      auto release_q = [&]() {
        if (tid == 0) mbar_arrive(q_empty);
      };

      // One turn a key tile: S of tile t and P.V of tile t-1 are issued
      // together, then the softmax of tile t. (ptxas puts the wait for P.V
      // ahead of the softmax whatever the order here; the softmax overlaps
      // the other warpgroups' products, not this one's.)
      mbar_wait(q_full, i & 1);
      if (n_kt > 0) {
        float corr_a, corr_b;
        mbar_wait(k_full(stage(0)), parity(0));
        turn_begin();
        wgmma_fence();
        issue_qk(stage(0));
        turn_end();
        wgmma_wait<0>();
        fence_regs(sc);
        if (n_kt == 1) release_q();
        softmax(0, &corr_a, &corr_b);  // O is 0: nothing to rescale
        pack_p();
        for (int t = 1; t < n_kt; ++t) {
          const int s = stage(t);
          const int sp = stage(t - 1);
          mbar_wait(k_full(s), parity(t));
          mbar_wait(v_full(sp), parity(t - 1));
          turn_begin();
          wgmma_fence();
          issue_qk(s);
          issue_pv(sp);
          turn_end();
          wgmma_wait<1>();  // S of tile t; P.V of tile t-1 still runs
          fence_regs(sc);
          if (t == n_kt - 1) release_q();  // its last read of Q is done
          softmax(t * kKeyTile, &corr_a, &corr_b);
          wgmma_wait<0>();
          fence_regs(o);
          if (tid == 0) mbar_arrive(empty(sp));  // K and V of tile t-1 done
#pragma unroll
          for (int j = 0; j < ND / 4; ++j) {
            o[4 * j] *= corr_a;
            o[4 * j + 1] *= corr_a;
            o[4 * j + 2] *= corr_b;
            o[4 * j + 3] *= corr_b;
          }
          pack_p();
        }
        const int sp = stage(n_kt - 1);
        mbar_wait(v_full(sp), parity(n_kt - 1));
        turn_begin();
        wgmma_fence();
        issue_pv(sp);
        turn_end();
        wgmma_wait<0>();
        fence_regs(o);
        if (tid == 0) mbar_arrive(empty(sp));
      } else {
        release_q();
      }
      it += n_kt;

      // ---- epilogue: O / l through shared memory to a TMA store ----
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      l_a = fmaxf(l_a, 1e-30f);
      l_b = fmaxf(l_b, 1e-30f);
      // the previous tile's store has to have read this warpgroup's rows
      if (tid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      named_sync(1 + wg, kWgThreads);
      uint8_t* const o_rows = gbase + (o_tile - base);
      const int la = wg * 64 + warp * 16 + g;  // row in the tile
#pragma unroll
      for (int j = 0; j < ND / 4; ++j) {
        const int col = 8 * j + 2 * c;
        *reinterpret_cast<uint32_t*>(o_rows + swizzled<D>(la, col)) =
            pack2<T>(o[4 * j] / l_a, o[4 * j + 1] / l_a);
        *reinterpret_cast<uint32_t*>(o_rows + swizzled<D>(la + 8, col)) =
            pack2<T>(o[4 * j + 2] / l_b, o[4 * j + 3] / l_b);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, kWgThreads);
      if (tid == 0) {
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          tma_store(&tm_o, o_tile + h * kQHalf + wg * 64 * L::kSwz,
                    h * L::kHalfCols, row_wg, bh);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (c == 0) {
        float* lb = lse + static_cast<size_t>(bh) * sq;
        if (ra < sq) lb[ra] = m_a * kLn2 + logf(l_a);
        if (rb < sq) lb[rb] = m_b * kLn2 + logf(l_b);
      }
    }
    // the last consumer ended one turn more than consumer 0 began: close it
    if (wg == 0) turn_begin();
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Scalar kernel (fp32)
// ---------------------------------------------------------------------------

constexpr int kRowsPerBlock = 64;
constexpr int kLanesPerRow = 4;
constexpr int kScalarThreads = kRowsPerBlock * kLanesPerRow;

__device__ __forceinline__ bool visible(int key, int qpos, int sk, int causal,
                                        int k_off) {
  return key < sk && (!causal || qpos >= k_off + key);
}

template <typename T, int D>
__global__ void __launch_bounds__(kScalarThreads)
    flash_fwd_scalar(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ q_offset,
                     const int* __restrict__ k_offset, int sq, int sk,
                     int causal, float sm_scale) {
  constexpr int BK = D >= 128 ? 32 : 64;  // keys per tile: 32 KB of smem
  constexpr int G = D / 16;               // float4 groups per lane
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  // the last q-tiles carry the most causal work: the grid runs them first
  const int n_qt = (sq + kRowsPerBlock - 1) / kRowsPerBlock;
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int tid = threadIdx.x;
  const int sub = tid % kLanesPerRow;
  const int row = qt * kRowsPerBlock + tid / kLanesPerRow;
  const bool row_ok = row < sq;
  const int q_off = *q_offset;
  const int k_off = *k_offset;
  const int qpos = q_off + row;

  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  // lane `sub` owns dims 16*g + 4*sub + e
  float qr[G][4];
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * g + 4 * sub + e;
      qr[g][e] = row_ok ? to_float(qb[static_cast<size_t>(row) * D + d]) : 0.f;
      acc[g][e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  const int n_kt = needed_key_tiles(kRowsPerBlock, qt, sq, sk, BK, causal,
                                    q_off, k_off);
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every lane is done with the previous tile
    for (int i = tid; i < BK * D; i += kScalarThreads) {
      const int key = k0 + i / D;
      float kv = 0.f;
      float vv = 0.f;
      if (key < sk) {
        const size_t src = static_cast<size_t>(key) * D + (i % D);
        kv = to_float(kb[src]);
        vv = to_float(vb[src]);
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[j * D + 16 * g + 4 * sub]);
        part = fmaf(qr[g][0], kk.x, part);
        part = fmaf(qr[g][1], kk.y, part);
        part = fmaf(qr[g][2], kk.z, part);
        part = fmaf(qr[g][3], kk.w, part);
      }
      // the butterfly leaves the same sum on all 4 lanes of the row
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = part;
    }

    float m_blk = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const bool ok = visible(k0 + j, qpos, sk, causal, k_off);
      s[j] = ok ? s[j] * sm_scale : kNegInf;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const bool ok = visible(k0 + j, qpos, sk, causal, k_off);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      s[j] = to_float(from_float<T>(p));  // P in V's dtype for P.V
    }
    l = l * corr + p_sum;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j * D + 16 * g + 4 * sub]);
        acc[g][0] = fmaf(s[j], vv.x, acc[g][0]);
        acc[g][1] = fmaf(s[j], vv.y, acc[g][1]);
        acc[g][2] = fmaf(s[j], vv.z, acc[g][2]);
        acc[g][3] = fmaf(s[j], vv.w, acc[g][3]);
      }
    }
    m = m_new;
  }

  l = fmaxf(l, 1e-30f);
  if (row_ok) {
    T* ob = out + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ob[16 * g + 4 * sub + e] = from_float<T>(acc[g][e] / l);
      }
    }
    if (sub == 0) lse[static_cast<size_t>(bh) * sq + row] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  void* lse;
  const void* q_offset;
  const void* k_offset;
  int bh, sq, sk, causal;
  float sm_scale;
  cudaStream_t stream;
};

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a 3-D tensor map over (D, S, BH) of a contiguous (BH, S, D) tensor, with
// boxes of one swizzled column half by `rows` rows
template <typename T, int D>
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int rows) {
  using L = Tiles<D>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kHalfCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      L::kSwz == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::kSwz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type = kIsBf16<T>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
cudaError_t launch_wgmma(const Args& a) {
  using L = Tiles<D>;
  const long long tiles =
      static_cast<long long>((a.sq + L::kQTile - 1) / L::kQTile) * a.bh;
  if (tiles < 1 || tiles > INT_MAX) return cudaErrorInvalidValue;
  static const int sms = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess) {
      return 0;
    }
    return n;
  }();
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long blocks = tiles < sms ? tiles : sms;  // one per SM
  CUtensorMap tq, tk, tv, to;
  if (!make_map<T, D>(&tq, a.q, a.bh, a.sq, L::kQTile) ||
      !make_map<T, D>(&tk, a.k, a.bh, a.sk, kKeyTile) ||
      !make_map<T, D>(&tv, a.v, a.bh, a.sk, kKeyTile) ||
      !make_map<T, D>(&to, a.out, a.bh, a.sq, 64)) {
    return cudaErrorInvalidValue;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (attr != cudaSuccess) return attr;
  const float scale_log2 =
      static_cast<float>(static_cast<double>(a.sm_scale) * 1.4426950408889634);
  flash_fwd_wgmma<T, D><<<static_cast<unsigned>(blocks), L::kThreads,
                          L::kSmem, a.stream>>>(
      tq, tk, tv, to, static_cast<float*>(a.lse),
      static_cast<const int*>(a.q_offset), static_cast<const int*>(a.k_offset),
      a.bh, a.sq, a.sk, a.causal, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  if constexpr (!std::is_same<T, float>::value) {
    return launch_wgmma<T, D>(a);
  } else {
    const long long n_qt = (a.sq + kRowsPerBlock - 1) / kRowsPerBlock;
    const long long blocks = n_qt * a.bh;
    if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
    flash_fwd_scalar<T, D><<<static_cast<unsigned>(blocks), kScalarThreads, 0,
                             a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse), static_cast<const int*>(a.q_offset),
        static_cast<const int*>(a.k_offset), a.sq, a.sk, a.causal,
        a.sm_scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int d, const Args& a) {
  switch (d) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (bh, s, d) contiguous, 16-byte aligned, in one dtype
// (0 fp32, 1 bf16, 2 fp16); lse: (bh, sq) fp32; q_offset, k_offset: one
// int32 each, in device memory. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* q_offset,
                             const void* k_offset, int bh, int sq, int sk,
                             int d, int dtype, int causal, float sm_scale,
                             void* stream) {
  const Args a{q,  k,  v,  out,    lse,      q_offset,
               k_offset, bh, sq, sk, causal, sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_head_dim<float>(d, a));
    case 1: return static_cast<int>(dispatch_head_dim<__nv_bfloat16>(d, a));
    case 2: return static_cast<int>(dispatch_head_dim<__half>(d, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
