// Flash-attention backward for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point (hvd_flash_bwd) that ops/flash_attention.py loads with
// ctypes.
//
// It replaces no TPU kernel: the JAX package's backward
// (horovod_tpu/ops/flash_attention.py _flash_vjp_bwd) is plain XLA. It was
// added because the port's plain-PyTorch backward (flash_bwd_plain: fp32
// products on the CUDA cores, about 70 launches a layer) took 84 ms of a
// 240-285 ms GPT-2 medium training step (8 x 1024 tokens, 24 layers) on an
// NVIDIA H100 80GB HBM3, the largest block of device time in the step.
// flash_bwd_plain stays as the CPU path, the fp32 CUDA path and the test
// oracle. It keeps that version's semantics:
//   * p = exp(scale * q.k - lse), masked as the forward masks (keys past
//     S_k, and when causal keys after the query on global positions);
//   * ds = p * (dp - delta + g_lse) * scale with dp = dO.v and delta =
//     rowsum(dO * O): the lse cotangent g_lse is carried (the eager ring
//     merges shards through lse);
//   * dq = ds k, dk = ds^T q, dv = p^T dO, written in the input dtype;
//   * q_off and k_off are read from int32 device memory (no host sync);
//   * the mask is applied before the exponential, so a query row that sees
//     no key (lse ~ -1e30) gets exactly zero gradient and adds nothing.
// A library backward (aten's or cuDNN's flash backward behind SDPA) cannot
// take its place: it takes no lse cotangent (g_lse), no causal offsets read
// from device tensors (the eager ring's shards), and does not promise a dq
// bit-identical across calls. A library path would still need a second,
// ring-only kernel beside it; one hand kernel for every path is simpler.
//
// Precision. q, k, v and dO arrive in bf16 (fp16): S = Q K^T and dP = dO V^T
// on the tensor cores with fp32 accumulation are the same products the plain
// version computes on upcast copies. P and dS are computed in fp32 and then
// rounded to the input type for the dV, dK and dQ products, which accumulate
// in fp32; that rounding is the only new one, and it is what the forward
// kernel already does to P before P.V. (The JAX package ran these einsums at
// XLA's default TPU precision, bf16 passes.)
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s), causal, D 64,
// counting the five products of a backward over the visible pairs and each
// input and output byte once (q, k, v, O, dO read, dq, dk, dv written, lse
// and g_lse read):
//   GPT-2 medium's layer, BH 128, S 1024: 5 * 2 * 64 * 128 * 524,800 =
//     43.0 GFLOP, 43.5 us; 135 MB, 40.4 us;
//   the training shape, BH 96, S 2048: 5 * 2 * 64 * 96 * 2,098,176 =
//     128.9 GFLOP, 130.3 us; 203 MB, 60.6 us.
// So the tensor cores bound it. The design runs seven products, not five
// (S and dP twice), to keep dq deterministic; at 7/5 of the bound the
// products still come first, then one ex2 a score pair on the special
// function units, as in the forward.
//
// Three kernels, launched in order on the caller's stream:
//
// flash_bwd_prep: one thread a query row writes, in fp32, the row terms
//   nl = -lse * log2(e) and rt = (g_lse - rowsum(dO * O)) * scale into a
//   scratch buffer the wrapper allocates at the size
//   hvd_flash_bwd_scratch_floats gives, padded to the row tile: a padded
//   row has nl = -inf (p = 0) and rt = 0.
//
// flash_bwd_dkdv and flash_bwd_dq: one pass each, of one design (bwd_pass).
// A work tile holds 128 rows of one side fixed (64 a consumer warpgroup)
// and streams the other side's tiles that can see them; the dK/dV pass
// holds keys and streams queries, the dQ pass holds queries and streams
// keys. Persistent: one block per SM walks work tiles, heaviest causal tiles
// first, dealt out in a serpentine over the blocks (as the forward). The
// causal range of streamed tiles is decided from the offsets on the device;
// a warpgroup whose rows see none of a streamed tile passes over it.
//   * A producer warpgroup (24 registers after setmaxnreg) whose one thread
//     issues the TMA copies: the two fixed tiles (K and V, or Q and dO) once
//     a work tile, after the consumers' last read of the previous ones, then
//     the two streamed tiles (Q and dO, or K and V) through a ring of
//     kStages stages guarded by full and empty mbarriers; the dK/dV pass
//     also copies the streamed queries' nl and rt (plain bulk copies).
//   * Two consumer warpgroups (240 registers). For each streamed tile: the
//     score products S = X1 Y1^T and dP = X2 Y2^T (wgmma m64nNk16, both
//     operands K-major in shared memory, fp32 accumulators); then, on the
//     accumulator registers, p = ex2(s * scale * log2(e) + nl) (masked
//     scores set to -inf first, only on tiles that straddle the diagonal or
//     an edge) and ds = p * (dp * scale + rt); then the accumulating
//     products from registers (wgmma m64nDk16 with P or dS as the A operand:
//     the score accumulators' layout is the A-fragment layout, so rounding
//     to the input type is the only conversion), with the streamed tile read
//     as an MN-major B operand, no transposed copy. In the dK/dV pass the
//     fixed rows are keys, so the scores sit transposed (S^T = K Q^T): dV +=
//     P^T dO and dK += dS^T Q take them straight from registers. In the dQ
//     pass dQ += dS K. The two warpgroups' products and exponentials
//     interleave on their own.
//   * Epilogue: each accumulator rounded to the input type and stored by the
//     thread that holds it.
//
// dq is deterministic: every element of dq, dk and dv is accumulated by one
// thread, over the streamed tiles in order, and written once. There are no
// atomics and no fp32 scratch of S x D; the price is S and dP computed again
// in the dQ pass.

#include "flash_common.cuh"

namespace {

constexpr int kBwdConsumers = 2;                // consumer warpgroups a block
constexpr int kFixedRows = 64 * kBwdConsumers;  // fixed rows of a work tile

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <int D>
struct BwdTiles : Swizzle<D> {
  using Sw = Swizzle<D>;
  static constexpr int kStream = D <= 64 ? 64 : 32;  // rows a streamed tile
  static constexpr int kThreads = (kBwdConsumers + 1) * kWgThreads;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static_assert(kWgThreads * (kProducerRegs + kBwdConsumers * kConsumerRegs) <=
                    65536,
                "registers of one block");
  static constexpr int kStages = 4;
  static constexpr int kFixedBytes = kFixedRows * 2 * D;
  static constexpr int kFixedHalf = kFixedRows * Sw::kSwz;
  static constexpr int kStreamBytes = kStream * 2 * D;
  static constexpr int kStreamHalf = kStream * Sw::kSwz;
  static constexpr int kSideBytes = kStream * 4;  // one fp32 a streamed row
  static constexpr int kBarriers = 2 + 2 * kStages;
  // tiles first (each a multiple of the 1024-byte swizzle atom), then the
  // row terms, then the barriers
  static constexpr int kSmem = 1024 + 2 * kFixedBytes +
                               kStages * (2 * kStreamBytes + 2 * kSideBytes) +
                               8 * kBarriers;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// one pass of the backward over work tiles; kKV: the dK/dV pass (fixed keys
// X1 = K, X2 = V; streamed queries Y1 = Q, Y2 = dO), else the dQ pass (fixed
// queries X1 = Q, X2 = dO; streamed keys Y1 = K, Y2 = V)
template <typename T, int D, bool kKV>
__device__ __forceinline__ void bwd_pass(
    uint8_t* smem_raw, const CUtensorMap* tm_x1, const CUtensorMap* tm_x2,
    const CUtensorMap* tm_y1, const CUtensorMap* tm_y2,
    const float* __restrict__ nl, const float* __restrict__ rt,
    T* __restrict__ out1, T* __restrict__ out2,
    const int* __restrict__ q_offset, const int* __restrict__ k_offset,
    int bh_count, int sq, int sk, int sq_pad, int causal, float scale_log2,
    float scale) {
  using L = BwdTiles<D>;
  constexpr int S = L::kStages;
  constexpr int N = L::kStream;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t x1 = base;
  const uint32_t x2 = x1 + L::kFixedBytes;
  const uint32_t y1 = x2 + L::kFixedBytes;
  const uint32_t y2 = y1 + S * L::kStreamBytes;
  const uint32_t sides = y2 + S * L::kStreamBytes;  // nl of stages, rt of stages
  const uint32_t bars = sides + 2 * S * L::kSideBytes;
  const uint32_t x_full = bars;
  const uint32_t x_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + S + s); };
  auto side_nl = [&](int s) { return sides + s * L::kSideBytes; };
  auto side_rt = [&](int s) { return sides + (S + s) * L::kSideBytes; };

  const int q_off = *q_offset;
  const int k_off = *k_offset;
  const int fixed_len = kKV ? sk : sq;
  const int n_ft = (fixed_len + kFixedRows - 1) / kFixedRows;
  const int n_st = ((kKV ? sq : sk) + N - 1) / N;
  const int n_tiles = n_ft * bh_count;
  // the block's i-th work tile (a batch*head and a fixed tile): heaviest
  // causal tiles first (the first key tiles, the last query tiles)
  auto work = [&](int i, int* bh, int* ft) {
    const int b = static_cast<int>(blockIdx.x);
    const int w = i * static_cast<int>(gridDim.x) +
                  ((i & 1) ? static_cast<int>(gridDim.x) - 1 - b : b);
    *ft = kKV ? w / bh_count : n_ft - 1 - w / bh_count;
    *bh = w % bh_count;
    return w < n_tiles;
  };
  // the streamed tiles [*begin, *end) that some of fixed rows [f0, f0 + n)
  // can see: when causal, query q sees key f iff q_off + q >= k_off + f
  auto span = [&](int f0, int n, int* begin, int* end) {
    *begin = 0;
    *end = n_st;
    if (f0 >= fixed_len) {
      *end = 0;
    } else if (causal && kKV) {  // from the first query that sees key f0
      const int diff = k_off + f0 - q_off;
      *begin = diff <= 0 ? 0 : min(diff / N, n_st);
    } else if (causal) {  // up to the last key that query f0 + n - 1 sees
      const int diff = q_off + min(f0 + n, fixed_len) - 1 - k_off;
      *end = diff < 0 ? 0 : min(diff / N + 1, n_st);
    }
  };
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    mbar_init(x_empty, kBwdConsumers);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kBwdConsumers);  // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kBwdConsumers) {
    // ---- producer: one thread keeps the copies in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        L::kProducerRegs));
    if (threadIdx.x == kBwdConsumers * kWgThreads) {
      int it = 0;  // streamed tiles loaded over all work tiles
      int bh, ft;
      for (int i = 0; work(i, &bh, &ft); ++i) {
        int begin, end;
        span(ft * kFixedRows, kFixedRows, &begin, &end);
        if (i > 0) mbar_wait(x_empty, (i - 1) & 1);
        mbar_expect_tx(x_full, 2 * L::kFixedBytes);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          tma_load(x1 + h * L::kFixedHalf, tm_x1, x_full, h * L::kHalfCols,
                   ft * kFixedRows, bh);
          tma_load(x2 + h * L::kFixedHalf, tm_x2, x_full, h * L::kHalfCols,
                   ft * kFixedRows, bh);
        }
        for (int t = begin; t < end; ++t, ++it) {
          const int s = it % S;
          const int round = it / S;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(full(s),
                         2 * L::kStreamBytes + (kKV ? 2 * L::kSideBytes : 0));
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            tma_load(y1 + s * L::kStreamBytes + h * L::kStreamHalf, tm_y1,
                     full(s), h * L::kHalfCols, t * N, bh);
            tma_load(y2 + s * L::kStreamBytes + h * L::kStreamHalf, tm_y2,
                     full(s), h * L::kHalfCols, t * N, bh);
          }
          if constexpr (kKV) {
            const size_t at = static_cast<size_t>(bh) * sq_pad + t * N;
            bulk_load(side_nl(s), nl + at, L::kSideBytes, full(s));
            bulk_load(side_rt(s), rt + at, L::kSideBytes, full(s));
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 fixed rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        L::kConsumerRegs));
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;  // row group of the accumulator fragments
    const int c = tid % 4;         // column pair within the group
    const float kMinusInf = __uint_as_float(0xff800000u);
    constexpr int ND = D / 2;  // accumulators a thread of a 64 x D product
    float acc1[ND];            // dK (dK/dV pass) or dQ
    float acc2[kKV ? ND : 1];  // dV
    float sc[N / 2];           // S, then P: n-block j holds 8j + 2c + {0, 1}
    float dp[N / 2];           // dP, then dS
    uint32_t pa[N / 16][4];    // P, the A operand of dV += P^T dO
    uint32_t pd[N / 16][4];    // dS, the A operand of dK or dQ
#pragma unroll
    for (int j = 0; j < N / 2; ++j) sc[j] = dp[j] = 0.f;

    // score products of the streamed tile at y: d = X Y^T (issued)
    auto issue_ss = [&](float(&d)[N / 2], uint32_t x, uint32_t y) {
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        const uint32_t x_at = (e / L::kStepsPerHalf) * L::kFixedHalf +
                              (e % L::kStepsPerHalf) * 32;
        const uint32_t y_at = (e / L::kStepsPerHalf) * L::kStreamHalf +
                              (e % L::kStepsPerHalf) * 32;
        wgmma_ss<T, N>(d,
                       gmma_desc(x + x_at + wg * 64 * L::kSwz, L::kSbo,
                                 L::kLayout),
                       gmma_desc(y + y_at, L::kSbo, L::kLayout), e > 0);
      }
    };
    // d += A Y with A from registers, Y the streamed tile at y (issued)
    auto issue_rs = [&](float(&d)[ND], const uint32_t(&a)[N / 16][4],
                        uint32_t y) {
#pragma unroll
      for (int e = 0; e < N / 16; ++e) {
        const uint32_t at = y + e * 16 * L::kSwz;
        wgmma_pv<T, D / L::kHalves, 0>(d, a[e],
                                       gmma_desc(at, L::kSbo, L::kLayout));
        if constexpr (L::kHalves == 2) {  // dims 64-127 from the second half
          wgmma_pv<T, 64, 32>(
              d, a[e], gmma_desc(at + L::kStreamHalf, L::kSbo, L::kLayout));
        }
      }
    };
    // the accumulators of n-blocks 2e, 2e+1 are the A fragment of k-step e;
    // packing rounds them to the input type
    auto pack = [&](uint32_t(&a)[N / 16][4], const float(&v)[N / 2]) {
#pragma unroll
      for (int e = 0; e < N / 16; ++e) {
        a[e][0] = pack2<T>(v[8 * e], v[8 * e + 1]);
        a[e][1] = pack2<T>(v[8 * e + 2], v[8 * e + 3]);
        a[e][2] = pack2<T>(v[8 * e + 4], v[8 * e + 5]);
        a[e][3] = pack2<T>(v[8 * e + 6], v[8 * e + 7]);
      }
    };

    int it = 0;  // streamed tiles consumed over all work tiles
    int bh, ft;
    for (int i = 0; work(i, &bh, &ft); ++i) {
      const int f0 = ft * kFixedRows + wg * 64;  // the warpgroup's first row
      int begin, end, wbegin, wend;
      span(ft * kFixedRows, kFixedRows, &begin, &end);
      span(f0, 64, &wbegin, &wend);
      const int ra = f0 + warp * 16 + g;  // this lane's fixed rows
      const int rb = ra + 8;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc1[j] = 0.f;
      if constexpr (kKV) {
#pragma unroll
        for (int j = 0; j < ND; ++j) acc2[j] = 0.f;
      }
      // masks: in the dK/dV pass a streamed query q is masked for key row r
      // iff q < lo_r; in the dQ pass a streamed key is masked for query row
      // r iff key >= lim_r. The row terms of the dQ pass are the lane's.
      int lo_a = 0, lo_b = 0, lim_a = 0, lim_b = 0;
      float nl_a = 0.f, nl_b = 0.f, rt_a = 0.f, rt_b = 0.f;
      if constexpr (kKV) {
        lo_a = ra >= sk ? INT_MAX : causal ? k_off + ra - q_off : INT_MIN;
        lo_b = rb >= sk ? INT_MAX : causal ? k_off + rb - q_off : INT_MIN;
      } else {
        lim_a = causal ? min(sk, q_off + ra - k_off + 1) : sk;
        lim_b = causal ? min(sk, q_off + rb - k_off + 1) : sk;
        const size_t row0 = static_cast<size_t>(bh) * sq_pad;
        nl_a = nl[row0 + ra];
        nl_b = nl[row0 + rb];
        rt_a = rt[row0 + ra];
        rt_b = rt[row0 + rb];
      }

      // One thread of the warpgroup arrives for all its warps. Where no
      // product follows (a warpgroup-wide wgmma keeps them together), its
      // warps first meet at a named barrier: a warp left two phases behind
      // would wait forever on a barrier whose parity came round again.
      auto arrive = [&](uint32_t bar) {
        named_sync(1 + wg, kWgThreads);
        if (tid == 0) mbar_arrive(bar);
      };
      mbar_wait(x_full, i & 1);
      if (wbegin >= wend) arrive(x_empty);
      for (int t = begin; t < end; ++t, ++it) {
        const int s = it % S;
        mbar_wait(full(s), static_cast<uint32_t>(it / S) & 1);
        if (t < wbegin || t >= wend) {  // none of these rows sees the tile
          arrive(empty(s));
          continue;
        }
        const uint32_t y1s = y1 + s * L::kStreamBytes;
        const uint32_t y2s = y2 + s * L::kStreamBytes;
        wgmma_fence();
        issue_ss(sc, x1, y1s);  // S^T = K Q^T, or S = Q K^T
        issue_ss(dp, x2, y2s);  // dP^T = V dO^T, or dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (t == wend - 1 && tid == 0) mbar_arrive(x_empty);  // last read

        // p and ds of element e of n-block j: fixed row (e < 2 ? a : b),
        // streamed row t * N + 8j + 2c + (e & 1)
        const int col0 = t * N + 2 * c;
        if constexpr (kKV) {
          const bool edge =
              f0 + 64 > sk || (causal && q_off + t * N < k_off + f0 + 63);
          const float2* nlv =
              reinterpret_cast<const float2*>(gbase + (side_nl(s) - base));
          const float2* rtv =
              reinterpret_cast<const float2*>(gbase + (side_rt(s) - base));
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const float2 n2 = nlv[4 * j + c];
            const float2 r2 = rtv[4 * j + c];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = fmaf(sc[4 * j + e], scale_log2, (e & 1) ? n2.y : n2.x);
              if (edge && col0 + 8 * j + (e & 1) < (e < 2 ? lo_a : lo_b)) {
                x = kMinusInf;
              }
              const float p = ex2(x);  // ex2(-inf) is exactly 0
              sc[4 * j + e] = p;
              dp[4 * j + e] =
                  p * fmaf(dp[4 * j + e], scale, (e & 1) ? r2.y : r2.x);
            }
          }
          pack(pa, sc);
        } else {
          const bool edge = t * N + N > sk ||
                            (causal && q_off + f0 < k_off + t * N + N - 1);
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = fmaf(sc[4 * j + e], scale_log2, e < 2 ? nl_a : nl_b);
              if (edge && col0 + 8 * j + (e & 1) >= (e < 2 ? lim_a : lim_b)) {
                x = kMinusInf;
              }
              const float p = ex2(x);
              dp[4 * j + e] =
                  p * fmaf(dp[4 * j + e], scale, e < 2 ? rt_a : rt_b);
            }
          }
        }
        pack(pd, dp);

        wgmma_fence();
        if constexpr (kKV) issue_rs(acc2, pa, y2s);  // dV += P^T dO
        issue_rs(acc1, pd, y1s);                     // dK += dS^T Q; dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc1);
        if constexpr (kKV) fence_regs(acc2);
        if (tid == 0) mbar_arrive(empty(s));  // both tiles of the stage read
      }

      // ---- epilogue: the fixed rows' gradients, one store a pair ----
      const size_t row0 = static_cast<size_t>(bh) * fixed_len;
#pragma unroll
      for (int j = 0; j < ND / 4; ++j) {
        const int col = 8 * j + 2 * c;
        if (ra < fixed_len) {
          *reinterpret_cast<uint32_t*>(out1 + (row0 + ra) * D + col) =
              pack2<T>(acc1[4 * j], acc1[4 * j + 1]);
          if constexpr (kKV) {
            *reinterpret_cast<uint32_t*>(out2 + (row0 + ra) * D + col) =
                pack2<T>(acc2[4 * j], acc2[4 * j + 1]);
          }
        }
        if (rb < fixed_len) {
          *reinterpret_cast<uint32_t*>(out1 + (row0 + rb) * D + col) =
              pack2<T>(acc1[4 * j + 2], acc1[4 * j + 3]);
          if constexpr (kKV) {
            *reinterpret_cast<uint32_t*>(out2 + (row0 + rb) * D + col) =
                pack2<T>(acc2[4 * j + 2], acc2[4 * j + 3]);
          }
        }
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BwdTiles<D>::kThreads, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_g,
                   const float* __restrict__ nl, const float* __restrict__ rt,
                   T* __restrict__ dk, T* __restrict__ dv,
                   const int* __restrict__ q_offset,
                   const int* __restrict__ k_offset, int bh_count, int sq,
                   int sk, int sq_pad, int causal, float scale_log2,
                   float scale) {
  extern __shared__ uint8_t smem_raw[];
  bwd_pass<T, D, true>(smem_raw, &tm_k, &tm_v, &tm_q, &tm_g, nl, rt, dk, dv,
                       q_offset, k_offset, bh_count, sq, sk, sq_pad, causal,
                       scale_log2, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(BwdTiles<D>::kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_g,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ nl, const float* __restrict__ rt,
                 T* __restrict__ dq, const int* __restrict__ q_offset,
                 const int* __restrict__ k_offset, int bh_count, int sq,
                 int sk, int sq_pad, int causal, float scale_log2,
                 float scale) {
  extern __shared__ uint8_t smem_raw[];
  bwd_pass<T, D, false>(smem_raw, &tm_q, &tm_g, &tm_k, &tm_v, nl, rt, dq,
                        static_cast<T*>(nullptr), q_offset, k_offset,
                        bh_count, sq, sk, sq_pad, causal, scale_log2, scale);
}

constexpr int kPrepThreads = 256;

// the row terms of every query row, padded rows included
template <typename T, int D>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_prep(const T* __restrict__ out, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ g_lse, float* __restrict__ nl,
                   float* __restrict__ rt, int bh_count, int sq, int sq_pad,
                   float scale) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (idx >= static_cast<long long>(bh_count) * sq_pad) return;
  const int bh = static_cast<int>(idx / sq_pad);
  const int row = static_cast<int>(idx % sq_pad);
  if (row >= sq) {
    nl[idx] = __uint_as_float(0xff800000u);
    rt[idx] = 0.f;
    return;
  }
  const size_t at = static_cast<size_t>(bh) * sq + row;
  const uint4* o4 = reinterpret_cast<const uint4*>(out + at * D);
  const uint4* g4 = reinterpret_cast<const uint4*>(g + at * D);
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint4 a = o4[i];
    const uint4 b = g4[i];
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* be = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      delta = fmaf(to_float(ae[e]), to_float(be[e]), delta);
    }
  }
  nl[idx] = -lse[at] * kLog2e;
  rt[idx] = (g_lse[at] - delta) * scale;
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* g;
  const void* lse;
  const void* g_lse;
  void* scratch;
  long long scratch_floats;
  void* dq;
  void* dk;
  void* dv;
  const void* q_offset;
  const void* k_offset;
  int bh, sq, sk, causal;
  float sm_scale;
  cudaStream_t stream;
};

// query rows padded to the row tile
long long padded_rows(int sq) {
  return (static_cast<long long>(sq) + kFixedRows - 1) / kFixedRows *
         kFixedRows;
}

template <typename T, int D>
cudaError_t launch_bwd(const BwdArgs& a) {
  using L = BwdTiles<D>;
  const long long sq_pad = padded_rows(a.sq);
  const long long rows = sq_pad * a.bh;
  const long long kv_tiles =
      static_cast<long long>((a.sk + kFixedRows - 1) / kFixedRows) * a.bh;
  const long long q_tiles = sq_pad / kFixedRows * a.bh;
  if (rows < 1 || sq_pad > INT_MAX || kv_tiles > INT_MAX ||
      q_tiles > INT_MAX || a.scratch_floats < 2 * rows) {
    return cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  float* nl = static_cast<float*>(a.scratch);
  float* rt = nl + rows;
  const float scale_log2 =
      static_cast<float>(static_cast<double>(a.sm_scale) * 1.4426950408889634);

  flash_bwd_prep<T, D><<<static_cast<unsigned>(
                             (rows + kPrepThreads - 1) / kPrepThreads),
                         kPrepThreads, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.g_lse), nl,
      rt, a.bh, a.sq, static_cast<int>(sq_pad), a.sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = bind_context(a.q);
  if (err != cudaSuccess) return err;
  // fixed tiles: kFixedRows rows a box; streamed tiles: kStream rows
  CUtensorMap fk, fv, fq, fg, sq_map, sg, sk_map, sv;
  if (!make_map<T, D>(&fk, a.k, a.bh, a.sk, kFixedRows) ||
      !make_map<T, D>(&fv, a.v, a.bh, a.sk, kFixedRows) ||
      !make_map<T, D>(&fq, a.q, a.bh, a.sq, kFixedRows) ||
      !make_map<T, D>(&fg, a.g, a.bh, a.sq, kFixedRows) ||
      !make_map<T, D>(&sq_map, a.q, a.bh, a.sq, L::kStream) ||
      !make_map<T, D>(&sg, a.g, a.bh, a.sq, L::kStream) ||
      !make_map<T, D>(&sk_map, a.k, a.bh, a.sk, L::kStream) ||
      !make_map<T, D>(&sv, a.v, a.bh, a.sk, L::kStream)) {
    return cudaErrorInvalidValue;
  }
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const int* qo = static_cast<const int*>(a.q_offset);
  const int* ko = static_cast<const int*>(a.k_offset);

  flash_bwd_dkdv<T, D><<<static_cast<unsigned>(kv_tiles < sms ? kv_tiles
                                                               : sms),
                         L::kThreads, L::kSmem, a.stream>>>(
      fk, fv, sq_map, sg, nl, rt, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      qo, ko, a.bh, a.sq, a.sk, static_cast<int>(sq_pad), a.causal,
      scale_log2, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, D><<<static_cast<unsigned>(q_tiles < sms ? q_tiles : sms),
                       L::kThreads, L::kSmem, a.stream>>>(
      fq, fg, sk_map, sv, nl, rt, static_cast<T*>(a.dq), qo, ko, a.bh, a.sq,
      a.sk, static_cast<int>(sq_pad), a.causal, scale_log2, a.sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int d, const BwdArgs& a) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(a);
    case 32: return launch_bwd<T, 32>(a);
    case 64: return launch_bwd<T, 64>(a);
    case 128: return launch_bwd<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out, g (the output's cotangent), dq, dk, dv: (bh, s, d)
// contiguous, 16-byte aligned, in one dtype (1 bf16, 2 fp16); lse, g_lse:
// (bh, sq) fp32; scratch: fp32, at least hvd_flash_bwd_scratch_floats(bh,
// sq) of them; q_offset, k_offset: one int32 each, in device memory.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hvd_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* g, const void* lse,
                             const void* g_lse, void* scratch,
                             long long scratch_floats, void* dq, void* dk,
                             void* dv, const void* q_offset,
                             const void* k_offset, int bh, int sq, int sk,
                             int d, int dtype, int causal, float sm_scale,
                             void* stream) {
  const BwdArgs a{q,  k,  v,  out, g,  lse, g_lse, scratch, scratch_floats,
                  dq, dk, dv, q_offset, k_offset, bh, sq, sk, causal,
                  sm_scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return static_cast<int>(dispatch_head_dim<__nv_bfloat16>(d, a));
    case 2: return static_cast<int>(dispatch_head_dim<__half>(d, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fp32 scratch hvd_flash_bwd needs: two terms a query row, the rows
// padded to the row tile.
extern "C" long long hvd_flash_bwd_scratch_floats(int bh, int sq) {
  return 2 * padded_rows(sq) * bh;
}
