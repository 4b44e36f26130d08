// Hopper building blocks shared by the flash-attention kernels of this
// directory (flash_fwd.cu, flash_bwd.cu): mbarriers, TMA copies, wgmma
// descriptors and products, the swizzled tile layout, and the host side of
// the TMA tensor maps. Each kernel source includes it and is built on its
// own into a library with a plain C entry point.

#pragma once

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

// a plain (not tensor) bulk copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// D (64 x N, fp32) (+)= A (64 x 16) * B (16 x N), A and B K-major in
// shared memory; `accumulate` 0 overwrites D
#define HVD_WGMMA_SS_N32(TY)                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"         \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15"                               \
  "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
#define HVD_WGMMA_SS_N64(TY)                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
  "%24, %25, %26, %27, %28, %29, %30, %31"                             \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 32) {
    if constexpr (kIsBf16<T>) {
      asm volatile(HVD_WGMMA_SS_N32("bf16")
                   : HVD_F16(d, 0)
                   : "l"(da), "l"(db), "r"(accumulate));
    } else {
      asm volatile(HVD_WGMMA_SS_N32("f16")
                   : HVD_F16(d, 0)
                   : "l"(da), "l"(db), "r"(accumulate));
    }
  } else if constexpr (N == 64) {
    if constexpr (kIsBf16<T>) {
      asm volatile(HVD_WGMMA_SS_N64("bf16")
                   : HVD_F32(d, 0)
                   : "l"(da), "l"(db), "r"(accumulate));
    } else {
      asm volatile(HVD_WGMMA_SS_N64("f16")
                   : HVD_F32(d, 0)
                   : "l"(da), "l"(db), "r"(accumulate));
    }
  } else {
    static_assert(N == 128, "score products are 32, 64 or 128 columns wide");
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
    static_assert(N == 64, "register-A products are 16, 32 or 64 wide");
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

constexpr int kWgThreads = 128;  // threads of a warpgroup

// the swizzled shared-memory layout of a tile of rows of D 2-byte elements:
// the whole row of 2*D bytes, in 128-byte column halves at D = 128
template <int D>
struct Swizzle {
  static constexpr int kSwz = 2 * D < 128 ? 2 * D : 128;  // bytes a row
  static constexpr int kHalves = 2 * D / kSwz;
  static constexpr int kHalfCols = kSwz / 2;
  static constexpr int kStepsPerHalf = kSwz / 32;  // 16-wide k-steps
  static constexpr uint32_t kSbo = 8 * kSwz / 16;  // 8-row groups, 16 B units
  // wgmma layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint32_t kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;
};

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);
using CtxGetCurrentFn = CUresult (*)(CUcontext*);

// streaming multiprocessors of the current device (0 if it cannot be read),
// read once: the persistent kernels launch at most one block on each
int sm_count() {
  static const int sms = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess) {
      return 0;
    }
    return n;
  }();
  return sms;
}

// a driver entry point (the library links the runtime only), or nullptr
void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return p;
}

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn =
      reinterpret_cast<EncodeTiledFn>(driver_fn("cuTensorMapEncodeTiled"));
  return fn;
}

// cuTensorMapEncodeTiled, a driver call, needs a context current on the
// calling host thread. A thread whose CUDA work so far went through
// PyTorch's caching allocator alone (a serving batcher's thread, when the
// offset tensors are cached) has none, and the encode fails; the runtime
// would make one current only at the launch, after it. So make the
// context of the inputs' device current first, when none is.
cudaError_t bind_context(const void* ptr) {
  static const CtxGetCurrentFn get =
      reinterpret_cast<CtxGetCurrentFn>(driver_fn("cuCtxGetCurrent"));
  CUcontext ctx = nullptr;
  if (get != nullptr && get(&ctx) == CUDA_SUCCESS && ctx != nullptr) {
    return cudaSuccess;
  }
  cudaPointerAttributes attrs;
  const cudaError_t err = cudaPointerGetAttributes(&attrs, ptr);
  if (err != cudaSuccess) return err;
  return cudaSetDevice(attrs.device);
}

// a 3-D tensor map over (D, S, BH) of a contiguous (BH, S, D) tensor, with
// boxes of one swizzled column half by `rows` rows
template <typename T, int D>
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int rows) {
  using L = Swizzle<D>;
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

}  // namespace
