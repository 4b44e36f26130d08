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
//   * masked scores are set to -1e30 (the TPU kernel's NEG_INF, not -inf):
//     keys past S_k always, and keys after the query when causal, with the
//     causal test q_off + row >= k_off + col on global positions;
//   * q_off and k_off are read from int32 device memory, so a caller can
//     pass positions computed on the device without a host sync;
//   * when causal, key tiles wholly above the diagonal are skipped;
//   * P is rounded to V's dtype before the P.V product (bf16 in training),
//     while l sums the unrounded fp32 P;
//   * l is clamped at 1e-30; out is written in the input dtype and the
//     per-row lse = m + log(l) in fp32.
//
// One difference, on purpose: a query row that sees no key at all. In the
// TPU kernel its answer depends on the tiling: 0 when its whole q-tile
// precedes the key range (every key block is skipped), a uniform average
// of V otherwise (masked scores give exp(-1e30 + 1e30) = 1 while m is still
// -1e30). Here a masked score contributes exactly 0 to l and to the output,
// so every such row gives out = 0 and lse ~ -1e30 whatever the tiling. Rows
// that see at least one key are unaffected: there exp(-1e30 - m) is 0.
//
// What bounds it on an H100 SXM at the training shape (BH = 8 x 12 heads,
// S = 2048, D = 64, bf16, causal):
//   operations: 4 * 96 * 2048^2 * 64 / 2 = 51.5 GFLOP, 52 us at 989 TFLOP/s;
//   bytes: q, k, v, out (25.2 MB each) + lse (0.8 MB) = 101 MB, 30 us at
//   3.35 TB/s.
// So the bound is compute, about 52 us a call, and only the tensor cores
// reach it.
//
// Two kernels, one per input type:
//
// flash_fwd_mma (bf16, fp16: the training path). One thread block of 4
// warps per (batch*head, 64-row q-tile); each warp owns 16 query rows. The
// block stages each 64-key K/V tile in shared memory (rows padded by 16
// bytes, so fragment reads hit 32 different banks). S = Q K^T and O += P V
// run on the tensor cores as mma.sync m16n8k16 with fp32 accumulators; the
// Q fragments, the tile's scores, m, l and O stay in registers; P goes from
// the score accumulators straight into the A operand of P V (their register
// layouts coincide), rounded to V's dtype on the way; V's B fragments come
// from ldmatrix.trans. Device memory sees each q and out element once and
// each K/V tile once per q-tile. Not yet done: cp.async/TMA prefetch of the
// next tile while this one computes, and Hopper's wgmma, which alone reaches
// the bound above.
//
// flash_fwd_scalar (fp32, tests and small callers): 256 threads, 4 adjacent
// lanes per query row, each lane owning D/4 of the row's dims as float4
// groups; scores are fp32 FMAs on the CUDA cores, reduced across the 4
// lanes by an xor butterfly that leaves the same sum on each, so all keep
// identical m and l. Products of fp32 inputs stay exact fp32, as on the TPU.
//
// Ragged S_q and S_k are masked in the kernels; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRowsPerBlock = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// number of q-tiles of a block's (batch*head); the last q-tiles carry the
// most causal work, so the grid schedules them first
__device__ __forceinline__ void tile_of_block(int sq, int* bh, int* qt) {
  const int n_qt = (sq + kRowsPerBlock - 1) / kRowsPerBlock;
  *bh = blockIdx.x / n_qt;
  *qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
}

// key tiles a q-tile needs: when causal, tile t is needed iff its first key
// is at or before the tile's last query
__device__ __forceinline__ int needed_key_tiles(int qt, int sq, int sk,
                                                int bk, int causal, int q_off,
                                                int k_off) {
  const int all = (sk + bk - 1) / bk;
  if (!causal) return all;
  const int q_last = q_off + min((qt + 1) * kRowsPerBlock, sq) - 1;
  const int diff = q_last - k_off;
  return diff < 0 ? 0 : min(diff / bk + 1, all);
}

__device__ __forceinline__ bool visible(int key, int qpos, int sk, int causal,
                                        int k_off) {
  return key < sk && (!causal || qpos >= k_off + key);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, fp16)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = kRowsPerBlock / 16;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaKeys = 64;  // keys per K/V tile

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// c += a (16x16, row-major) * b (16x8, col-major), fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r0, uint32_t* r1,
                                                  const void* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(*r0), "=r"(*r1)
               : "r"(addr));
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, const int* __restrict__ q_offset,
                  const int* __restrict__ k_offset, int sq, int sk,
                  int causal, float sm_scale) {
  constexpr int BK = kMmaKeys;
  constexpr int STR = D + 8;     // padded smem row, in elements (16 bytes)
  constexpr int NT = BK / 8;     // key n-tiles of S
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int ND = D / 8;      // dim n-tiles of O
  constexpr int KP = BK / 16;    // k-steps of P V
  constexpr int CH = D / 8;      // 16-byte chunks per row
  __shared__ __align__(16) T ks[BK * STR];
  __shared__ __align__(16) T vs[BK * STR];

  int bh, qt;
  tile_of_block(sq, &bh, &qt);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;        // row group of the mma fragments
  const int c = lane % 4;        // column pair within the group
  const int ra = qt * kRowsPerBlock + (threadIdx.x / 32) * 16 + g;
  const int rb = ra + 8;
  const int q_off = *q_offset;
  const int k_off = *k_offset;
  const int qpos_a = q_off + ra;
  const int qpos_b = q_off + rb;

  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;

  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int d = 16 * s + 2 * c;
    qa[s][0] = ra < sq ? ld32(qb + static_cast<size_t>(ra) * D + d) : 0u;
    qa[s][1] = rb < sq ? ld32(qb + static_cast<size_t>(rb) * D + d) : 0u;
    qa[s][2] = ra < sq ? ld32(qb + static_cast<size_t>(ra) * D + d + 8) : 0u;
    qa[s][3] = rb < sq ? ld32(qb + static_cast<size_t>(rb) * D + d + 8) : 0u;
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;
  float l_a = 0.f, l_b = 0.f;  // this lane's share of its rows' sums

  const int n_kt = needed_key_tiles(qt, sq, sk, BK, causal, q_off, k_off);
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * CH; i += kMmaThreads) {
      const int j = i / CH;
      const int col = (i % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;  // zeros past S_k: 0 * garbage could be NaN
      if (k0 + j < sk) {
        const size_t src = static_cast<size_t>(k0 + j) * D + col;
        kv = *reinterpret_cast<const uint4*>(kb + src);
        vv = *reinterpret_cast<const uint4*>(vb + src);
      }
      *reinterpret_cast<uint4*>(&ks[j * STR + col]) = kv;
      *reinterpret_cast<uint4*>(&vs[j * STR + col]) = vv;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const T* krow = &ks[(8 * j + g) * STR + 2 * c];
#pragma unroll
      for (int e = 0; e < KS; ++e) {
        mma16816<T>(s[j], qa[e], ld32(krow + 16 * e), ld32(krow + 16 * e + 8));
      }
    }

    // fragment element e of n-tile j: row (e < 2 ? ra : rb),
    // key k0 + 8j + 2c + (e & 1)
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * c + (e & 1);
        const bool ok = visible(key, e < 2 ? qpos_a : qpos_b, sk, causal,
                                k_off);
        s[j][e] = ok ? s[j][e] * sm_scale : kNegInf;
        if (e < 2) {
          mx_a = fmaxf(mx_a, s[j][e]);
        } else {
          mx_b = fmaxf(mx_b, s[j][e]);
        }
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a);
    const float corr_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * c + (e & 1);
        const bool a = e < 2;
        const bool ok = visible(key, a ? qpos_a : qpos_b, sk, causal, k_off);
        const float p = ok ? expf(s[j][e] - (a ? mn_a : mn_b)) : 0.f;
        s[j][e] = p;
        if (a) {
          sum_a += p;
        } else {
          sum_b += p;
        }
      }
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr_a;
      o[n][1] *= corr_a;
      o[n][2] *= corr_b;
      o[n][3] *= corr_b;
    }
#pragma unroll
    for (int e = 0; e < KP; ++e) {
      // the scores of key n-tiles 2e, 2e+1 are the A fragment of k-step e;
      // packing rounds P to V's dtype
      const uint32_t pa[4] = {pack2<T>(s[2 * e][0], s[2 * e][1]),
                              pack2<T>(s[2 * e][2], s[2 * e][3]),
                              pack2<T>(s[2 * e + 1][0], s[2 * e + 1][1]),
                              pack2<T>(s[2 * e + 1][2], s[2 * e + 1][3])};
      const T* vrow = &vs[(16 * e + lane % 16) * STR];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(&b0, &b1, vrow + 8 * n);
        mma16816<T>(o[n], pa, b0, b1);
      }
    }
    m_a = mn_a;
    m_b = mn_b;
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  T* ob = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * c;
    if (ra < sq) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(ra) * D + d) =
          pack2<T>(o[n][0] / l_a, o[n][1] / l_a);
    }
    if (rb < sq) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(rb) * D + d) =
          pack2<T>(o[n][2] / l_b, o[n][3] / l_b);
    }
  }
  if (c == 0) {
    float* lb = lse + static_cast<size_t>(bh) * sq;
    if (ra < sq) lb[ra] = m_a + logf(l_a);
    if (rb < sq) lb[rb] = m_b + logf(l_b);
  }
}

// ---------------------------------------------------------------------------
// Scalar kernel (fp32)
// ---------------------------------------------------------------------------

constexpr int kLanesPerRow = 4;
constexpr int kScalarThreads = kRowsPerBlock * kLanesPerRow;

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

  int bh, qt;
  tile_of_block(sq, &bh, &qt);
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

  const int n_kt = needed_key_tiles(qt, sq, sk, BK, causal, q_off, k_off);
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

template <typename T, int D>
cudaError_t launch(const Args& a) {
  const long long n_qt = (a.sq + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = n_qt * a.bh;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const T*>(a.q);
  const auto* kp = static_cast<const T*>(a.k);
  const auto* vp = static_cast<const T*>(a.v);
  auto* op = static_cast<T*>(a.out);
  auto* lp = static_cast<float*>(a.lse);
  const auto* qo = static_cast<const int*>(a.q_offset);
  const auto* ko = static_cast<const int*>(a.k_offset);
  const unsigned grid = static_cast<unsigned>(blocks);
  if constexpr (std::is_same<T, float>::value) {
    flash_fwd_scalar<T, D><<<grid, kScalarThreads, 0, a.stream>>>(
        qp, kp, vp, op, lp, qo, ko, a.sq, a.sk, a.causal, a.sm_scale);
  } else {
    flash_fwd_mma<T, D><<<grid, kMmaThreads, 0, a.stream>>>(
        qp, kp, vp, op, lp, qo, ko, a.sq, a.sk, a.causal, a.sm_scale);
  }
  return cudaGetLastError();
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
