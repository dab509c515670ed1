// Flash attention's backward for bf16 / fp16 operands on Hopper (sm_90a):
// the dq kernel (with dbias) and the dk/dv kernel, each a persistent
// warp-specialised kernel on wgmma with fp32 accumulation, its tiles
// brought in by TMA from a producer warp. flash_bwd_dq_sm90.cu builds the
// first, flash_bwd_dkv_sm90.cu the second (two libraries, so that nvcc
// builds them side by side); the primitives are sm90.cuh's, shared with the
// forward (flash_fwd_sm90.cu).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_bwd_dq  <- _make_bwd_dq_kernel (:228) and, past the TPU's VMEM
//                    budget, _make_bwd_dq_kernel_streamed (:533), dbias
//                    included (:245-274);
//   flash_bwd_dkv <- _make_bwd_dkv_kernel (:285) / _make_bwd_dkv_kernel_streamed
//                    (:581).
// Each kernel streams its other operand at any S, so it stands for both of
// its TPU pair. The fp32 backward and the 16-bit hd 16 one stay on the
// mma.sync kernels of flash_attention.cuh; ops/flash_attention.py routes
// each launch on (kernel, dtype, hd) by a fixed table.
//
// Function: the one of flash_attention.cuh, with its rounding points. s =
// (q . k) in fp32 from the storage-dtype operands, times 1/sqrt(hd), plus
// the bias upcast to fp32, plus slope_h * (key - query) for ALiBi; p =
// exp(s - lse) from the forward's fp32 lse, 0 where the causal cut, the (B,
// S) key mask or S hides the position; dp = dO . v; ds = p (dp - delta)
// with delta = rowsum(dO o) in fp32. dq = (ds rounded to k's dtype) . k,
// dk = (ds rounded to q's dtype)^T . q, both scaled by 1/sqrt(hd) once at
// the end; dv = (p rounded to dO's dtype)^T . dO; dbias = ds rounded to the
// bias's dtype. No atomics: every output element has one writer, and a
// second run gives the same bits.
//
// Layout: q, dO, dq (B, S, H, hd); k, v, dk, dv (B, S, KV, hd), contiguous
// (the JAX layout); lse, delta (B, H, S) fp32. GQA maps query head h to KV
// head h / (H / KV) by index; dk/dv of a KV head sum its group's query
// heads inside one unit. The bias is any (B|1, H|1, S, S) tensor whose last
// two dims are contiguous, element (b, h, r, c) at b * sb + h * sh + r * S +
// c; dbias a contiguous (B, H, S, S) tensor of the bias's dtype, every
// element written (zeros past the causal cut), nothing past S.
//
// Bound (chip_smoke.py prints both terms for every shape it times): dq's
// three products (2 * B * H * S^2 * hd flop each, halved when causal) and
// dk/dv's four at 989 TFLOP/s, against each input read and each output
// written once at 3.35 TB/s (the bias as stored, dbias as written). At hd
// 64-128 without a bias the operations bound both kernels; with AlphaFold
// 2's bias at hd 32 the bytes do (dq writes a (B, H, S, S) dbias).
//
// Design (the forward's, flash_fwd_sm90.cu, with the two roles swapped for
// dk/dv):
// - Persistent: one block an SM (fewer if there are fewer units), three
//   warpgroups of 128 threads. Warpgroup 0 is the producer: setmaxnreg
//   gives back all but 24 of its registers and one thread issues the TMA
//   loads (4-D tensor maps over the JAX layout, encoded per call; rows past
//   S arrive as zeros). Warpgroups 1 and 2 take 240 registers each and own
//   64 rows of a 128-row unit apiece (wgmma's m64).
// - dq: a unit is 128 query rows of one (b, h); its Q and dO come in once
//   (into buffers freed once the unit's last S and dP have retired, so the
//   next unit's arrive during this one's last product and epilogue), K and
//   V in tiles of 64 keys through rings with a full and an empty barrier a
//   stage. Per key tile: S = Q.K^T and dP = dO.V^T (wgmma, both operands
//   K-major in shared memory), then ds in registers, then dQ += dS.K with
//   dS as the A operand from registers (the accumulator fragment of S is,
//   warp by warp, an A fragment) and K read MN-major from the same tile.
//   Tile j's S and dP are issued with tile j - 1's dQ product after one
//   fence, so ds of tile j is formed while that product runs (with a bias
//   at hd 128 the product retires first: its registers hold the bias
//   loads). V's stage is free after dP, K's after dQ.
// - dbias: each thread writes its rounded ds fragment (two rows, pairs of
//   adjacent keys where S is even) straight to device memory; a warp's
//   stores of one tile fill whole 32-byte sectors of eight rows, which L2
//   merges. The key tiles a causal unit skips are written as zeros by the
//   same warpgroup, coalesced, after its last tile.
// - dk/dv: a unit is 128 keys of one (b, KV head); its K and V come in
//   once, then tiles of 64 queries of Q and dO (TMA) stream over the
//   group's G query heads x query tiles (their lse and delta rows loaded a
//   step ahead by the consumers, one value a thread, into shared memory);
//   a causal unit starts at the diagonal's query tile. Per step: S^T = K.Q^T and dP^T = V.dO^T (both
//   K-major), then P^T and dS^T in registers (lse and delta read per query
//   column from shared memory), then dV += P^T.dO and dK += dS^T.Q with the
//   tiles read MN-major. Without a bias at hd <= 64 step i's S^T and dP^T
//   are issued with step i - 1's dV and dK products after one fence, as in
//   dq; at hd 128 dK and dV take 128 fp32 registers a thread and leave no
//   room for that (nor does a bias fragment), so a step's products wait for
//   the last step's, and the two warpgroups, unsynchronized, cover each
//   other.
// - Order: causal units run heaviest first (dq: the last query tiles, dk/dv:
//   the first key tiles); the blocks take the units in passes of gridDim.x,
//   every other pass in reverse block order, as in the forward.
// - Masks: a tile inside S, without a key mask and clear of the causal
//   diagonal checks no element; elsewhere each position tests its key's
//   liveness (a ballot word for dq, two flags a thread for dk/dv), S and the
//   causal cut. With no bias and no ALiBi the scale folds into the exponent
//   (one FFMA and one ex2 a score).
// - The bias: each thread reads the bias of its own score fragment straight
//   from device memory: dq pairs of adjacent keys of its two rows, dk/dv the
//   same elements for its transposed fragment (a warp's load of one column
//   covers 8 adjacent keys of 4 query rows). Where registers allow (dq at
//   hd <= 64, dk/dv at hd 32) the fragment is loaded while the step's
//   products run; elsewhere each value is added where it is loaded. The
//   dtype is dispatched once a tile, outside the unrolled element loops.
//
// C interface (ctypes): dstpu_flash_bwd_dq / dstpu_flash_bwd_dkv take the
// arguments of the mma.sync library's functions of those names and return
// cudaGetLastError() after the launch, cudaErrorInvalidValue for what they
// do not take (fp32, hd outside {32, 64, 128}) and cudaErrorNotSupported
// when libcuda gives no tensor map encoder.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int kUnit = 128;   // rows of a unit: queries (dq) or keys (dk/dv)
constexpr int kStep = 64;    // rows of a streamed tile: keys (dq) or queries
template <int HD> constexpr int kUnitB = kUnit * HD * 2;
template <int HD> constexpr int kStepB = kStep * HD * 2;
// stages of a ring of two streamed tiles: as many as 200 KiB hold beside
// the unit's two tiles, at most 6
template <int HD>
constexpr int kStages = (204800 - 2 * kUnitB<HD>) / (2 * kStepB<HD>) < 6
                            ? (204800 - 2 * kUnitB<HD>) / (2 * kStepB<HD>)
                            : 6;
// dk/dv's lse and delta rows of a step: per consumer warpgroup two buffers
// of 64 + 64 fp32
constexpr int kRowsB = 2 * 2 * 2 * kStep * 4;

// the unit's two tiles, the ring, (dk/dv: the rows,) then the barriers
// (dq: 2 + 4 a stage, dk/dv 2 + 2 a stage); 1024 bytes of slack align the
// swizzled tiles
template <int HD>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * kUnitB<HD> + 2 * kStages<HD> * kStepB<HD> +
         8 * (2 + 4 * kStages<HD>);
}
template <int HD>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * kUnitB<HD> + 2 * kStages<HD> * kStepB<HD> + kRowsB +
         8 * (2 + 2 * kStages<HD>);
}

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__half* p, float x) {
  *p = __float2half(x);
}
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x[j][e] = the bias at [query q0 + 8 j + 2 t + (e & 1)][key key[e >> 1]]
// upcast to fp32, 0 outside S: the bias of a thread's transposed (key,
// query) fragment of dk/dv, from the (S, S) matrix at p
template <typename B, int NJ>
__device__ __forceinline__ void bias_frag_t(float (&x)[NJ][4],
                                            const B* __restrict__ p,
                                            const int (&key)[2], int q0,
                                            int t, int S) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = q0 + 8 * j + 2 * t + (e & 1), k = key[e >> 1];
      x[j][e] = query < S && k < S ? to_f32(p[(size_t)query * S + k]) : 0.f;
    }
}

// bias_frag_t with the dtype dispatched once, outside the element loops
template <int NJ>
__device__ __forceinline__ void load_bias_t(float (&x)[NJ][4], int dtype,
                                            const unsigned char* p,
                                            const int (&key)[2], int q0,
                                            int t, int S) {
  if (dtype == 2)
    bias_frag_t(x, reinterpret_cast<const __nv_bfloat16*>(p), key, q0, t, S);
  else if (dtype == 1)
    bias_frag_t(x, reinterpret_cast<const __half*>(p), key, q0, t, S);
  else
    bias_frag_t(x, reinterpret_cast<const float*>(p), key, q0, t, S);
}

// dbias[row e >> 1][key k0 + 8 j + 2 t + (e & 1)] = ds[j][e] rounded to B,
// inside S only: a thread's fragment of the (S, S) matrix at p. PAIRS
// writes two adjacent keys at once (S even, p aligned to a pair).
template <typename B, bool PAIRS, int NJ>
__device__ __forceinline__ void dbias_frag(B* __restrict__ p,
                                           const float (&ds)[NJ][4],
                                           const int (&row)[2], int k0, int t,
                                           int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    B* pr = p + (size_t)row[r] * S;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = k0 + 8 * j + 2 * t;
      if constexpr (PAIRS) {
        if (c < S) store_pair(pr + c, ds[j][2 * r], ds[j][2 * r + 1]);
      } else {
        if (c < S) from_f32(pr + c, ds[j][2 * r]);
        if (c + 1 < S) from_f32(pr + c + 1, ds[j][2 * r + 1]);
      }
    }
  }
}

// zeros over columns [c0, S) of rows [r0, min(r0 + 64, S)) of the (S, S)
// matrix at p, by the 128 threads of a warpgroup (tid its thread), a row's
// columns on adjacent threads
template <typename B>
__device__ __forceinline__ void dbias_zeros(B* __restrict__ p, int r0, int c0,
                                            int S, int tid) {
  const int w = S - c0;
  if (w <= 0) return;
  const int rows = min(64, S - r0);
  for (int i = tid; i < rows * w; i += 128) {
    const int r = i / w;
    from_f32(p + (size_t)(r0 + r) * S + c0 + (i - r * w), 0.f);
  }
}

// ------------------------------------------------------------------ dq
template <typename T, int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                             __grid_constant__ const CUtensorMap tdo,
                             __grid_constant__ const CUtensorMap tk,
                             __grid_constant__ const CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ slopes, Bias bias,
                             T* __restrict__ dq, void* __restrict__ dbias,
                             int B, int S, int H, int KV, int causal,
                             float scale) {
  constexpr int NS = kStages<HD>, BN = kStep;
  constexpr int TB = kStepB<HD>, RB = kRowB<HD>, PC = kPC<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sDO = sQ + kUnitB<HD>;
  const uint32_t sK = sDO + kUnitB<HD>;              // NS K tiles
  const uint32_t sV = sK + NS * TB;                  // NS V tiles
  // Q and dO full and empty; per stage K and V full (TMA's bytes landed),
  // K and V empty (every consumer warp's product that reads it retired)
  const uint32_t bar_q = sV + NS * TB;
  const uint32_t bar_eq = bar_q + 8;
  const uint32_t bar_k = bar_eq + 8;                 // NS each, 8 bytes apart
  const uint32_t bar_v = bar_k + 8 * NS;
  const uint32_t bar_ek = bar_v + 8 * NS;
  const uint32_t bar_ev = bar_ek + 8 * NS;

  // a unit is a (query tile, b, h), the query tile the slowest index;
  // causal units run heaviest first (the tiles with the most keys)
  const int nq = (S + kUnit - 1) / kUnit, nunits = nq * H * B;
  const int ntiles = (S + BN - 1) / BN;
  struct Unit { int h, b, q0, nend; };
  auto unit = [&](int u) {
    const int hb = u % (H * B), rank = u / (H * B);
    const int q0 = (causal ? nq - 1 - rank : rank) * kUnit;
    return Unit{hb % H, hb / H, q0,
                causal ? min(ntiles, (q0 + kUnit - 1) / BN + 1) : ntiles};
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_eq, kConsumerWarps);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, kConsumerWarps);
      mbar_init(bar_ev + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, read through a shuffle so that the compiler sees it uniform
  // across each warp (a role branch it took for divergent would serialize
  // the wgmma of the branch)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                  // K / V tiles loaded so far, all units
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        const int kvh = w.h / (H / KV);
        // Q and dO are free once the last unit's last S and dP retired (a
        // fresh barrier's parity 1 counts as complete)
        mbar_wait(bar_eq, (n & 1) ^ 1);
        mbar_expect_tx(bar_q, 2 * kUnitB<HD>);
#pragma unroll
        for (int p = 0; p < HD / PC; ++p) {
          tma_load(sQ + p * kUnit * RB, &tq, bar_q, p * PC, w.h, w.q0, w.b);
          tma_load(sDO + p * kUnit * RB, &tdo, bar_q, p * PC, w.h, w.q0, w.b);
        }
        for (int j = 0; j < w.nend; ++j, ++it) {
          const int s = it % NS, parity = ((it / NS) & 1) ^ 1;
          mbar_wait(bar_ev + 8 * s, parity);
          mbar_expect_tx(bar_v + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
            tma_load(sV + s * TB + p * BN * RB, &tv, bar_v + 8 * s, p * PC,
                     kvh, j * BN, w.b);
          mbar_wait(bar_ek + 8 * s, parity);
          mbar_expect_tx(bar_k + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
            tma_load(sK + s * TB + p * BN * RB, &tk, bar_k + 8 * s, p * PC,
                     kvh, j * BN, w.b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;                         // consumer warpgroup
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint32_t sQw = sQ + cw * 64 * RB;        // the group's rows
    const uint32_t sDOw = sDO + cw * 64 * RB;
    float acc[HD / 8][4];
    float sc[BN / 8][4], dp[BN / 8][4];
    uint32_t pa[BN / 16][4];
    // the current unit's
    int b = 0, row0 = 0, row[2] = {0, 0};
    float lse2[2], dlt[2];           // lse * log2(e) and delta of each row
    float slope = 0.f;
    const unsigned char* bias_p = nullptr;         // its (S, S) bias matrix
    unsigned char* dbias_p = nullptr;              // and dbias matrix
    bool pairs = false;

    auto wait_tile = [&](uint32_t bars, int i) {
      mbar_wait(bars + 8 * (i % NS), (i / NS) & 1);
    };
    auto release = [&](uint32_t bars, int i) {
      if (lane == 0) mbar_arrive(bars + 8 * (i % NS));
    };
    // S = Q . K^T and dP = dO . V^T of the ring's tile i, one group (the
    // first k step writes the accumulators: nothing is zeroed)
    auto issue_s = [&](int i) {
      const uint32_t k_tile = sK + (i % NS) * TB, v_tile = sV + (i % NS) * TB;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16)
        wgmma_ss(sc, desc_k<HD>(sQw, kUnit, kk), desc_k<HD>(k_tile, BN, kk),
                 kk > 0, T());
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16)
        wgmma_ss(dp, desc_k<HD>(sDOw, kUnit, kk), desc_k<HD>(v_tile, BN, kk),
                 kk > 0, T());
      wgmma_commit();
    };
    // acc += dS . K of the ring's tile i (K read MN-major); the unit's
    // first tile (i == i0) writes acc
    auto issue_dq = [&](int i, int i0) {
      const uint32_t k_tile = sK + (i % NS) * TB;
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)
        wgmma_rs(acc, pa[c], desc<HD>(k_tile + c * 16 * RB, BN * RB),
                 i != i0 || c > 0, T());
      wgmma_commit();
    };
    // tile j's key liveness (the key mask and key < S) as ballot words, and
    // whether any position of the group's rows must be hidden; called
    // before the wait for the products, so the mask's loads overlap them
    uint32_t live[BN / 32];
    bool hide = false;
    // at hd <= 64 the bias of the thread's scores is loaded with the key
    // bits, while the products run (at hd 128 its registers are not free)
    constexpr bool kPrefetchBias = BIAS && HD <= 64;
    float bv[BN / 8][4];
    auto key_bits = [&](int j) {
      if constexpr (kPrefetchBias)
        load_bias<false>(bv, bias.dtype, bias_p, pairs, row, j * BN, t, S);
      const int k0 = j * BN;
      const bool diag = causal && k0 + BN - 1 > row0;
      hide = mask != nullptr || k0 + BN > S || diag;
      if (!hide) return;
      uint32_t all = ~0u;
#pragma unroll
      for (int w = 0; w < BN / 32; ++w) {
        const int key = k0 + 32 * w + lane;
        live[w] = __ballot_sync(
            0xffffffffu, key < S && (mask == nullptr ||
                                     mask[(size_t)b * S + key] != 0));
        all &= live[w];
      }
      hide = all != ~0u || diag;
    };
    // tile j's scores and dP to ds (in sc), and ds to dbias
    auto grad = [&](int j) {
      const int k0 = j * BN;
      const bool fold = !BIAS && slopes == nullptr;
      if constexpr (kPrefetchBias) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jn][e] = sc[jn][e] * scale + bv[jn][e];
      } else if constexpr (BIAS) {
        auto as = [&](auto tag) {                  // the bias's dtype
          using BT = decltype(tag);
          const BT* pb = reinterpret_cast<const BT*>(bias_p);
          if (pairs)
            add_bias<BT, true>(sc, pb, row, k0, t, S, scale);
          else
            add_bias<BT, false>(sc, pb, row, k0, t, S, scale);
        };
        if (bias.dtype == 2) as(__nv_bfloat16());
        else if (bias.dtype == 1) as(__half());
        else as(float());
      } else if (!fold) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jn][e] *= scale;
      }
      if (slopes != nullptr) {
        const int d0 = k0 + 2 * t - row[0];        // key - query at jn, e = 0
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[jn][e] += slope * (float)(d0 + 8 * jn + (e & 1) - 8 * (e >> 1));
      }
      const float c = fold ? scale * kLog2e : kLog2e;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[jn][e], c, -lse2[e >> 1]));
          if (hide) {
            const int kc = 8 * jn + 2 * t + (e & 1);    // key within the tile
            const bool keep = ((live[kc >> 5] >> (kc & 31)) & 1u) &&
                              (!causal || k0 + kc <= row[e >> 1]);
            p = keep ? p : 0.f;
          }
          sc[jn][e] = p * (dp[jn][e] - dlt[e >> 1]);
        }
      if constexpr (BIAS) {
        if (dbias != nullptr) {
          if (bias.dtype == 2) {
            auto* p = reinterpret_cast<__nv_bfloat16*>(dbias_p);
            if (pairs) dbias_frag<__nv_bfloat16, true>(p, sc, row, k0, t, S);
            else dbias_frag<__nv_bfloat16, false>(p, sc, row, k0, t, S);
          } else if (bias.dtype == 1) {
            auto* p = reinterpret_cast<__half*>(dbias_p);
            if (pairs) dbias_frag<__half, true>(p, sc, row, k0, t, S);
            else dbias_frag<__half, false>(p, sc, row, k0, t, S);
          } else {
            auto* p = reinterpret_cast<float*>(dbias_p);
            if (pairs) dbias_frag<float, true>(p, sc, row, k0, t, S);
            else dbias_frag<float, false>(p, sc, row, k0, t, S);
          }
        }
      }
    };
    // ds rounded to k's dtype, as A fragments of dQ += dS . K
    auto pack_ds = [&] {
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        pa[c][0] = pack(sc[2 * c][0], sc[2 * c][1], T());
        pa[c][1] = pack(sc[2 * c][2], sc[2 * c][3], T());
        pa[c][2] = pack(sc[2 * c + 1][0], sc[2 * c + 1][1], T());
        pa[c][3] = pack(sc[2 * c + 1][2], sc[2 * c + 1][3], T());
      }
    };

    // Tile j's ds is formed while tile j - 1's dQ product runs, but for a
    // bias at hd 128: there the product retires first, freeing its A
    // fragments' registers for the bias loads (else ptxas spills).
    constexpr bool kOverlap = !(BIAS && HD == 128);

    int it = 0;                      // the ring's tiles consumed, all units
    for (int n = 0; unit_of(n) < nunits; ++n) {
      const Unit w = unit(unit_of(n));
      const int h = w.h;
      b = w.b;
      row0 = w.q0 + cw * 64;                       // the group's first row
      row[0] = row0 + warp * 16 + g;
      row[1] = row[0] + 8;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t i = ((size_t)b * H + h) * S + row[r];
        lse2[r] = row[r] < S ? lse[i] * kLog2e : 0.f;
        dlt[r] = row[r] < S ? delta[i] : 0.f;
      }
      slope = slopes != nullptr ? slopes[h] : 0.f;
      if constexpr (BIAS) {
        const int esize = bias.dtype == 3 ? 4 : 2;
        bias_p = static_cast<const unsigned char*>(bias.p) +
                 (size_t)(b * bias.sb + h * bias.sh) * esize;
        if (dbias != nullptr)
          dbias_p = static_cast<unsigned char*>(dbias) +
                    ((size_t)b * H + h) * S * S * esize;
        // the bias's and dbias's pairs: dbias is contiguous and aligned
        pairs = S % 2 == 0 &&
                reinterpret_cast<uintptr_t>(bias_p) % (2 * esize) == 0;
      }
      const int nend = w.nend;

      mbar_wait(bar_q, n & 1);
      wait_tile(bar_k, it);
      wait_tile(bar_v, it);
      wgmma_fence();
      issue_s(it);
      key_bits(0);
      wgmma_wait<0>();
      release(bar_ev, it);
      if (nend == 1 && lane == 0) mbar_arrive(bar_eq);
      grad(0);
      pack_ds();
      for (int j = 1; j < nend; ++j) {
        wait_tile(bar_k, it + j);
        wait_tile(bar_v, it + j);
        wgmma_fence();      // covers acc and pa of the last step
        issue_s(it + j);
        issue_dq(it + j - 1, it);
        key_bits(j);
        if constexpr (kOverlap) {
          wgmma_wait<1>();  // S, dP of tile j are in; tile j - 1's dQ runs on
        } else {
          wgmma_wait<0>();
          release(bar_ek, it + j - 1);
        }
        release(bar_ev, it + j);
        if (j == nend - 1 && lane == 0) mbar_arrive(bar_eq);  // Q, dO free
        grad(j);
        if constexpr (kOverlap) {
          wgmma_wait<0>();
          release(bar_ek, it + j - 1);
        }
        pack_ds();
      }
      wgmma_fence();
      issue_dq(it + nend - 1, it);
      wgmma_wait<0>();
      release(bar_ek, it + nend - 1);
      it += nend;

      // the key tiles past the causal cut: dbias 0, so that every element
      // has been written once
      if constexpr (BIAS) {
        if (dbias != nullptr && row0 < S) {
          const int tid = threadIdx.x & 127, c0 = nend * BN;
          if (bias.dtype == 2)
            dbias_zeros(reinterpret_cast<__nv_bfloat16*>(dbias_p), row0, c0,
                        S, tid);
          else if (bias.dtype == 1)
            dbias_zeros(reinterpret_cast<__half*>(dbias_p), row0, c0, S, tid);
          else
            dbias_zeros(reinterpret_cast<float*>(dbias_p), row0, c0, S, tid);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= S) continue;
        T* dst = dq + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          *reinterpret_cast<uint32_t*>(dst + nn * 8) =
              pack(acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale, T());
      }
    }
  }
}

// ------------------------------------------------------------------ dk, dv
template <typename T, int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                              __grid_constant__ const CUtensorMap tdo,
                              __grid_constant__ const CUtensorMap tk,
                              __grid_constant__ const CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ slopes, Bias bias,
                              T* __restrict__ dk, T* __restrict__ dv, int B,
                              int S, int H, int KV, int causal, float scale) {
  constexpr int NS = kStages<HD>, BM = kStep;
  constexpr int TB = kStepB<HD>, RB = kRowB<HD>, PC = kPC<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = sK + kUnitB<HD>;
  const uint32_t sQ = sV + kUnitB<HD>;               // NS Q tiles
  const uint32_t sDO = sQ + NS * TB;                 // NS dO tiles
  const uint32_t sRows = sDO + NS * TB;              // kRowsB
  // K and V full and empty; per stage full (Q and dO landed) and empty
  // (every consumer warp's products that read it retired)
  const uint32_t bar_kv = sRows + kRowsB;
  const uint32_t bar_ekv = bar_kv + 8;
  const uint32_t bar_f = bar_ekv + 8;                // NS each
  const uint32_t bar_e = bar_f + 8 * NS;
  float* rows_s =                                    // its generic address
      reinterpret_cast<float*>(smem_raw + (sRows - smem_u32(smem_raw)));

  // a unit is a (key tile, b, KV head), the key tile the slowest index;
  // causal units run heaviest first (the first key tiles see the most
  // queries). Its steps run over (query head of the group, query tile),
  // the query tile the fastest; a causal unit starts at the tile of its
  // first key.
  const int G = H / KV;
  const int nk = (S + kUnit - 1) / kUnit, nunits = nk * KV * B;
  const int nqt = (S + BM - 1) / BM;
  struct Unit { int kvh, b, k0, it0, per; };
  auto unit = [&](int u) {
    const int hb = u % (KV * B), k0 = (u / (KV * B)) * kUnit;
    const int it0 = causal ? k0 / BM : 0;
    return Unit{hb % KV, hb / KV, k0, it0, nqt - it0};
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_ekv, kConsumerWarps);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                  // steps loaded so far, all units
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        // K and V are free once the last unit's last S^T and dP^T retired
        mbar_wait(bar_ekv, (n & 1) ^ 1);
        mbar_expect_tx(bar_kv, 2 * kUnitB<HD>);
#pragma unroll
        for (int p = 0; p < HD / PC; ++p) {
          tma_load(sK + p * kUnit * RB, &tk, bar_kv, p * PC, w.kvh, w.k0, w.b);
          tma_load(sV + p * kUnit * RB, &tv, bar_kv, p * PC, w.kvh, w.k0, w.b);
        }
        const int nsteps = G * w.per;
        for (int i = 0; i < nsteps; ++i, ++it) {
          const int h = w.kvh * G + i / w.per;
          const int q0 = (w.it0 + i % w.per) * BM;
          const int s = it % NS, parity = ((it / NS) & 1) ^ 1;
          mbar_wait(bar_e + 8 * s, parity);
          mbar_expect_tx(bar_f + 8 * s, 2 * TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p) {
            tma_load(sQ + s * TB + p * BM * RB, &tq, bar_f + 8 * s, p * PC, h,
                     q0, w.b);
            tma_load(sDO + s * TB + p * BM * RB, &tdo, bar_f + 8 * s, p * PC,
                     h, q0, w.b);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint32_t sKw = sK + cw * 64 * RB;        // the group's keys
    const uint32_t sVw = sV + cw * 64 * RB;
    float dka[HD / 8][4], dva[HD / 8][4];
    float st[BM / 8][4], dpt[BM / 8][4];           // (key, query) tiles
    uint32_t pp[BM / 16][4], pd[BM / 16][4];
    // A step's 64 lse and 64 delta values (0 past S), one a thread, go
    // through the group's two buffers in turn: loaded a step ahead, stored
    // before the step's products, read after a barrier of the group's 128
    // threads (a TMA box of them would start at any element of an fp32 row
    // of S, and TMA wants 16-byte-aligned boxes).
    const int tid = threadIdx.x & 127;
    // Without a bias at hd <= 64 a step's products overlap the next step's
    // (dK and dV leave the registers for it); with a bias at hd 32 the
    // step's bias fragment is loaded while its products run instead (both
    // at once spill).
    constexpr bool kOverlap = HD <= 64 && !BIAS;
    constexpr bool kPrefetchBias = BIAS && HD == 32;
    float bv[BM / 8][4];

    int it = 0;                      // the ring's steps consumed, all units
    for (int n = 0; unit_of(n) < nunits; ++n) {
      const Unit w = unit(unit_of(n));
      const int b = w.b, kw0 = w.k0 + cw * 64 + warp * 16;  // warp's keys
      // the (S, S) bias matrix of (b, head h)
      auto bias_matrix = [&](int h) {
        return static_cast<const unsigned char*>(bias.p) +
               (size_t)(b * bias.sb + h * bias.sh) * (bias.dtype == 3 ? 4 : 2);
      };
      const int key[2] = {kw0 + g, kw0 + g + 8};
      bool live_key[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        live_key[r] = key[r] < S &&
                      (mask == nullptr || mask[(size_t)b * S + key[r]] != 0);
      const bool keys_live =
          __all_sync(0xffffffffu, live_key[0] && live_key[1]);
      const int nsteps = G * w.per;
      auto row_value = [&](int i) {                // step i's, this thread's
        const int h = w.kvh * G + i / w.per;
        const int q = (w.it0 + i % w.per) * BM + (tid & (BM - 1));
        const float* src = tid < BM ? lse : delta;
        return q < S ? src[((size_t)b * H + h) * S + q] : 0.f;
      };
      // step i's query head, first query and ring stage
      auto head = [&](int i) { return w.kvh * G + i / w.per; };
      auto first_query = [&](int i) { return (w.it0 + i % w.per) * BM; };
      auto stage = [&](int i) { return (it + i) % NS; };
      auto rows_of = [&](int i) {
        return rows_s + (cw * 2 + ((it + i) & 1)) * 2 * BM;
      };
      // step i's rows into its buffer (the next step's load goes out), then
      // the wait for its Q and dO
      float rv = row_value(0);
      auto step_front = [&](int i) {
        rows_of(i)[tid] = rv;
        if (i + 1 < nsteps) rv = row_value(i + 1);
        mbar_wait(bar_f + 8 * stage(i), ((it + i) / NS) & 1);
      };
      // S^T = K . Q^T and dP^T = V . dO^T of step i, one group
      auto issue_s = [&](int i) {
        const uint32_t q_tile = sQ + stage(i) * TB;
        const uint32_t do_tile = sDO + stage(i) * TB;
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16)
          wgmma_ss(st, desc_k<HD>(sKw, kUnit, kk), desc_k<HD>(q_tile, BM, kk),
                   kk > 0, T());
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16)
          wgmma_ss(dpt, desc_k<HD>(sVw, kUnit, kk),
                   desc_k<HD>(do_tile, BM, kk), kk > 0, T());
        wgmma_commit();
      };
      // dV += P^T . dO and dK += dS^T . Q of step i (the unit's first step
      // writes them)
      auto issue_dkv = [&](int i) {
        const uint32_t q_tile = sQ + stage(i) * TB;
        const uint32_t do_tile = sDO + stage(i) * TB;
#pragma unroll
        for (int c = 0; c < BM / 16; ++c)
          wgmma_rs(dva, pp[c], desc<HD>(do_tile + c * 16 * RB, BM * RB),
                   i > 0 || c > 0, T());
#pragma unroll
        for (int c = 0; c < BM / 16; ++c)
          wgmma_rs(dka, pd[c], desc<HD>(q_tile + c * 16 * RB, BM * RB),
                   i > 0 || c > 0, T());
        wgmma_commit();
      };
      // after step i's products are issued: the barrier that publishes the
      // group's rows (the buffer's last readers, two steps back, passed the
      // last step's), and at hd 32 the loads of the step's bias, which
      // overlap the products
      auto step_issued = [&](int i) {
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
        if constexpr (kPrefetchBias)
          load_bias_t(bv, bias.dtype, bias_matrix(head(i)), key,
                      first_query(i), t, S);
      };
      auto release = [&](int i) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * stage(i));
      };
      auto kv_free = [&](int i) {        // K and V after the last S^T, dP^T
        if (i == nsteps - 1 && lane == 0) mbar_arrive(bar_ekv);
      };
      // step i's P^T and dS^T in place; BT is the bias's element type
      // (float when there is none)
      auto grad = [&](int i) {
        const int h = head(i), q0 = first_query(i);
        const float* ls = rows_of(i);
        const float* dl = ls + BM;
        // a warp whose keys are all live and whose step lies inside S and
        // at or past its causal diagonal checks no element
        const bool hide = !keys_live || q0 + BM > S ||
                          (causal && q0 < kw0 + 15);
        const float slope = slopes != nullptr ? slopes[h] : 0.f;
        auto body = [&](auto tag) {
          using BT = decltype(tag);
          const BT* bp = reinterpret_cast<const BT*>(bias_matrix(h));
          const bool fold = !BIAS && slopes == nullptr;
          const float c = fold ? scale * kLog2e : kLog2e;
#pragma unroll
          for (int jn = 0; jn < BM / 8; ++jn) {
            const int qc = 8 * jn + 2 * t;                // query column
            const float2 lq = *reinterpret_cast<const float2*>(ls + qc);
            const float2 dq2 = *reinterpret_cast<const float2*>(dl + qc);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int query = q0 + qc + (e & 1), kk = key[e >> 1];
              float x = st[jn][e];
              if (!fold) x *= scale;
              if constexpr (kPrefetchBias) {
                x += bv[jn][e];
              } else if constexpr (BIAS) {
                if (query < S && kk < S)
                  x += to_f32(bp[(size_t)query * S + kk]);
              }
              if (slopes != nullptr) x += slope * (float)(kk - query);
              float p = ex2(fmaf(x, c, -(e & 1 ? lq.y : lq.x) * kLog2e));
              if (hide) {
                const bool keep = live_key[e >> 1] && query < S &&
                                  (!causal || kk <= query);
                p = keep ? p : 0.f;
              }
              st[jn][e] = p;
              dpt[jn][e] = p * (dpt[jn][e] - (e & 1 ? dq2.y : dq2.x));
            }
          }
        };
        if constexpr (BIAS && !kPrefetchBias) {
          if (bias.dtype == 2) body(__nv_bfloat16());
          else if (bias.dtype == 1) body(__half());
          else body(float());
        } else {
          body(float());
        }
      };
      // P^T rounded to dO's dtype, dS^T to q's, as A fragments
      auto pack_p = [&] {
#pragma unroll
        for (int c = 0; c < BM / 16; ++c) {
          pp[c][0] = pack(st[2 * c][0], st[2 * c][1], T());
          pp[c][1] = pack(st[2 * c][2], st[2 * c][3], T());
          pp[c][2] = pack(st[2 * c + 1][0], st[2 * c + 1][1], T());
          pp[c][3] = pack(st[2 * c + 1][2], st[2 * c + 1][3], T());
          pd[c][0] = pack(dpt[2 * c][0], dpt[2 * c][1], T());
          pd[c][1] = pack(dpt[2 * c][2], dpt[2 * c][3], T());
          pd[c][2] = pack(dpt[2 * c + 1][0], dpt[2 * c + 1][1], T());
          pd[c][3] = pack(dpt[2 * c + 1][2], dpt[2 * c + 1][3], T());
        }
      };

      mbar_wait(bar_kv, n & 1);
      if constexpr (kOverlap) {
        // step i's S^T and dP^T go out with step i - 1's dV and dK after
        // one fence; step i's P^T and dS^T are formed while those run
        step_front(0);
        wgmma_fence();
        issue_s(0);
        step_issued(0);
        wgmma_wait<0>();
        kv_free(0);
        grad(0);
        pack_p();
        for (int i = 1; i < nsteps; ++i) {
          step_front(i);
          wgmma_fence();
          issue_s(i);
          issue_dkv(i - 1);
          step_issued(i);
          wgmma_wait<1>();
          kv_free(i);
          grad(i);
          wgmma_wait<0>();
          release(i - 1);
          pack_p();
        }
        wgmma_fence();
        issue_dkv(nsteps - 1);
        wgmma_wait<0>();
        release(nsteps - 1);
      } else {
        for (int i = 0; i < nsteps; ++i) {
          step_front(i);
          wgmma_fence();
          issue_s(i);
          step_issued(i);
          wgmma_wait<0>();
          kv_free(i);
          grad(i);
          pack_p();
          wgmma_fence();
          issue_dkv(i);
          wgmma_wait<0>();
          release(i);
        }
      }
      it += nsteps;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= S) continue;
        const size_t off = (((size_t)b * S + key[r]) * KV + w.kvh) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn) {
          *reinterpret_cast<uint32_t*>(dk + off + nn * 8) =
              pack(dka[nn][2 * r] * scale, dka[nn][2 * r + 1] * scale, T());
          *reinterpret_cast<uint32_t*>(dv + off + nn * 8) =
              pack(dva[nn][2 * r], dva[nn][2 * r + 1], T());
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* mask;
  const float* slopes;
  Bias bias;
  void *dq, *dk, *dv, *dbias;
  int B, S, H, KV, hd, causal, dtype;
  float scale;
  cudaStream_t stream;
};

bool bwd_args_ok(const BwdArgs& a) {
  return a.B > 0 && a.S > 0 && a.H > 0 && a.KV > 0 && a.H % a.KV == 0 &&
         (long long)a.B * a.H * a.S < (1ll << 31) &&
         (a.hd == 32 || a.hd == 64 || a.hd == 128) &&
         (a.dtype == 1 || a.dtype == 2) &&
         (a.bias.p == nullptr || (a.bias.dtype >= 1 && a.bias.dtype <= 3)) &&
         (a.dbias == nullptr || a.bias.p != nullptr);
}

template <typename T, int HD, bool BIAS>
cudaError_t launch_dq(const BwdArgs& a, EncodeTiled enc) {
  CUtensorMap m[4];
  if (!encode(enc, &m[0], a.q, a.dtype, a.B, a.S, a.H, a.hd, kUnit) ||
      !encode(enc, &m[1], a.dout, a.dtype, a.B, a.S, a.H, a.hd, kUnit) ||
      !encode(enc, &m[2], a.k, a.dtype, a.B, a.S, a.KV, a.hd, kStep) ||
      !encode(enc, &m[3], a.v, a.dtype, a.B, a.S, a.KV, a.hd, kStep))
    return cudaErrorInvalidValue;
  constexpr int smem = dq_smem_bytes<HD>();
  auto fn = flash_bwd_dq_sm90_kernel<T, HD, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = persistent_blocks((long long)((a.S + kUnit - 1) / kUnit) * a.H * a.B,
                          &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.mask, a.slopes, a.bias,
      static_cast<T*>(a.dq), a.dbias, a.B, a.S, a.H, a.KV, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD, bool BIAS>
cudaError_t launch_dkv(const BwdArgs& a, EncodeTiled enc) {
  CUtensorMap m[4];
  if (!encode(enc, &m[0], a.q, a.dtype, a.B, a.S, a.H, a.hd, kStep) ||
      !encode(enc, &m[1], a.dout, a.dtype, a.B, a.S, a.H, a.hd, kStep) ||
      !encode(enc, &m[2], a.k, a.dtype, a.B, a.S, a.KV, a.hd, kUnit) ||
      !encode(enc, &m[3], a.v, a.dtype, a.B, a.S, a.KV, a.hd, kUnit))
    return cudaErrorInvalidValue;
  constexpr int smem = dkv_smem_bytes<HD>();
  auto fn = flash_bwd_dkv_sm90_kernel<T, HD, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = persistent_blocks((long long)((a.S + kUnit - 1) / kUnit) * a.KV * a.B,
                          &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.mask, a.slopes, a.bias,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B, a.S, a.H, a.KV,
      a.causal, a.scale);
  return cudaGetLastError();
}

// LAUNCH<T, HD, BIAS>::run(a, enc) at the call's dtype, head dim and bias
// (each source instantiates only its own kernel)
template <template <typename, int, bool> class LAUNCH>
int bwd_dispatch(const BwdArgs& a) {
  if (!bwd_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto by_hd = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    const bool bias = a.bias.p != nullptr;
    switch (a.hd) {
      case 32: return bias ? LAUNCH<T, 32, true>::run(a, enc)
                           : LAUNCH<T, 32, false>::run(a, enc);
      case 64: return bias ? LAUNCH<T, 64, true>::run(a, enc)
                           : LAUNCH<T, 64, false>::run(a, enc);
      default: return bias ? LAUNCH<T, 128, true>::run(a, enc)
                           : LAUNCH<T, 128, false>::run(a, enc);
    }
  };
  return static_cast<int>(a.dtype == 2 ? by_hd(__nv_bfloat16())
                                       : by_hd(__half()));
}

}  // namespace
