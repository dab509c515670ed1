// Flash attention's forward for fp32 operands on Hopper (sm_90a): a
// persistent warp-specialised kernel whose two products are 3xTF32 on
// wgmma, Q, K and V brought in by TMA, converter warps writing the tf32 low
// parts and the transposed copies tf32 needs. The fp32 pieces (geometry,
// the split, the transposed copies, the tf32 wgmma and their 3xTF32 sums,
// the fp32 tensor maps) are tf32_sm90.cuh's, shared with the fp32 backward
// pair (flash_bwd_f32_sm90.cuh); the TMA, mbarrier, unit-order and bias
// helpers sm90.cuh's. ops/flash_attention.py routes the fp32 forward at hd
// 32, 64 and 128 here by a fixed table; fp32 at hd 16 stays on the mma.sync
// kernel of flash_attention.cuh (flash_attention_f32.cu).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py, for
// fp32 operands:
//   flash_fwd <- _fwd_kernel (:43, pallas_call :210) and, past the TPU's
//                VMEM budget, _fwd_kernel_streamed (:436, pallas_call :514).
// One kernel streams K/V at any S, so it stands for both.
//
// Function: the one of flash_attention.cuh's fp32 forward, with its
// rounding points. s = (q . k) * 1/sqrt(hd) + the bias upcast to fp32 +
// slope_h * (key - query) for ALiBi; positions hidden by the causal cut,
// the (B, S) key mask or S get no probability; online softmax in fp32 (m
// starts at BIG_NEG = -2^30); o = acc / max(l, 1e-30) and lse = m +
// log(max(l, 1e-30)), so a fully masked row gives o = 0 and lse = BIG_NEG
// + log(1e-30), never NaN. Both products are 3xTF32: x . y as x_lo . y_hi +
// x_hi . y_lo + x_hi . y_hi, each operand split once (TMA's raw tile is
// its own tf32 high part: the tensor cores read a tf32 operand's top 19
// bits; the low part x - hi is exact in fp32), about fp32's accuracy.
//
// Layout: q, o (B, S, H, hd) and k, v (B, S, KV, hd), contiguous fp32 (the
// JAX layout); lse (B, H, S) fp32. GQA maps query head h to KV head h / (H
// / KV) by index. The bias is any (B|1, H|1, S, S) fp32 / bf16 / fp16
// tensor whose last two dims are contiguous, element (b, h, r, c) at b * sb
// + h * sh + r * S + c with stride 0 on a broadcast dim: never materialized.
//
// Bound (chip_smoke.py prints it): the two products, 2 * 2 * B * H * S^2 *
// hd flop halved when causal, as three tf32 products each at 495 TFLOP/s
// (165 TFLOP/s of fp32 work), against q, k, v and the bias read and o and
// lse written once at 3.35 TB/s. The operations bound it at GPT-2 1.5B's
// shape; with the DS4Science example's full (B, H, S, S) fp32 bias the
// bytes do.
//
// Design (the fp32 dq kernel's, flash_bwd_f32_sm90.cuh, with dP dropped and
// V in place of K in the second product):
// - Persistent: one block an SM (fewer if there are fewer units), two
//   warpgroups. Warpgroup 0: warp 0's first thread issues the TMA loads
//   (4-D tensor maps over the JAX layout, encoded per call, boxes of 32
//   fp32 columns in the 128-byte swizzle; rows past S arrive as zeros);
//   warps 1-3 are converters. Warpgroup 1, the consumer, runs the products
//   and owns a unit of 64 query rows of one (b, h) (wgmma's m64); keys come
//   32 a tile.
// - The converters write Q's lo tile once a unit and K's lo tile once a
//   tile, as each lands; then V's transposed hi and lo copies (row n holds
//   column n of V, its 32 keys in pos() order): P . V reads V along its
//   rows, and tf32 has no transpose bit. A tile's two halves go through
//   two rings with barriers of their own: the natural slot (K hi, K lo, V
//   as TMA wrote it) is free once S retired and the converters read V out
//   of it, the transposed slot (V^T hi, lo) once its P . V retired.
// - S = Q_hi.K_hi + Q_hi.K_lo + Q_lo.K_hi (both operands K-major as they
//   land, the small terms first). P is split into hi and lo A fragments in
//   registers of their own (reinterpreting the accumulator's registers
//   serializes wgmma, C7511), its contraction index in pos() order, and P .
//   V is three products into a fresh accumulator; then O = (O + tile) *
//   alpha in fp32 registers. The tensor cores truncate fp32 sums, so no sum
//   longer than one tile's is kept in them; online softmax rescales O each
//   tile anyway.
// - Overlap: tile j's S and tile j - 1's P . V are issued after one fence;
//   S is waited for alone, so tile j's masks, bias and softmax run while
//   the P . V does. At hd 128 with a bias the P . V runs alone before the
//   softmax, 64 columns at a time added straight into O: with a 128-column
//   fresh tile and P's fragments live, the bias loads spilled.
// - Shared memory: Q hi and lo (two 64-row tiles), kFwdF32Stages<HD>
//   natural slots of three 32-row tiles and kF32TStages transposed slots
//   of two; ops/flash_attention.py flash_fwd_f32_plan() repeats these
//   numbers, a CPU test holds them to each other and under 227 KiB, and
//   chip_smoke.py's phase 1 to the library's own count. At hd 128 two
//   slots of each fit (225 KiB).
// - Order, masks and the bias: the dq kernel's. Causal units run heaviest
//   first, the blocks take them in passes of gridDim.x (sm90.cuh unit_of);
//   a tile inside S, without a key mask and clear of the causal diagonal
//   checks no element; each thread reads the bias of its own score
//   fragment from device memory, while the products run at hd 32 and 64;
//   at hd 128 each pair is added to its score where it is loaded, at the
//   softmax (no registers are free for a fragment of bias values).
//
// C interface (ctypes): dstpu_flash_fwd takes the arguments of the
// mma.sync library's function of that name and returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for what it does not take (16-bit
// operands, hd outside {32, 64, 128}) and cudaErrorNotSupported when
// libcuda gives no tensor map encoder.

#include "tf32_sm90.cuh"

namespace {

// natural slots: the deepest ring that fits beside the unit (at GPT-2's
// shape the fp32 dq kernel timed the same at deeper and shallower rings)
template <int HD> constexpr int kFwdF32Stages = HD == 32 ? 8 : HD == 64 ? 4 : 2;

// Q (hi, lo), the natural slots (K hi, K lo, V), the transposed slots (V^T
// hi, lo), then the barriers (3 for the unit, 3 a natural slot, 2 a
// transposed one); 1024 bytes of slack align the swizzled tiles
template <int HD>
constexpr int fwd_f32_smem_bytes() {
  return 1024 + 2 * kFUnitB<HD> + kFwdF32Stages<HD> * 3 * kFStepB<HD> +
         kF32TStages * 2 * kFStepB<HD> +
         8 * (3 + 3 * kFwdF32Stages<HD> + 2 * kF32TStages);
}
static_assert(fwd_f32_smem_bytes<32>() <= 232448, "fwd f32 hd 32 smem");
static_assert(fwd_f32_smem_bytes<64>() <= 232448, "fwd f32 hd 64 smem");
static_assert(fwd_f32_smem_bytes<128>() <= 232448, "fwd f32 hd 128 smem");

template <int HD, bool BIAS>
__global__ void __launch_bounds__(kFThreads, 1)
    flash_fwd_f32_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                              __grid_constant__ const CUtensorMap tk,
                              __grid_constant__ const CUtensorMap tv,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ slopes, Bias bias,
                              float* __restrict__ o, float* __restrict__ lse,
                              int B, int S, int H, int KV, int causal,
                              float scale) {
  constexpr int NS = kFwdF32Stages<HD>, NT = kF32TStages, BN = kFStep;
  constexpr int UB = kFUnitB<HD>, TB = kFStepB<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  auto gen = [&](uint32_t a) { return smem_raw + (a - raw); };
  // the unit's Q: TMA's values (hi) and their lo tile
  const uint32_t sQ = base, sQl = sQ + UB;
  // natural slot s: K (TMA's: hi), K lo, V (TMA's); transposed slot u:
  // V^T hi, V^T lo
  const uint32_t sNat = sQl + UB, sT = sNat + NS * 3 * TB;
  auto nat = [&](int s, int k) { return sNat + (s * 3 + k) * TB; };
  auto tt = [&](int u, int k) { return sT + (u * 2 + k) * TB; };
  // the unit's full (TMA), converted and empty (its last S retired)
  // barriers; per natural slot full, converted and free (S retired, V read
  // for its transposed copy), per transposed slot written and free (P . V
  // retired)
  const uint32_t bar_u = sT + NT * 2 * TB;
  const uint32_t bar_uc = bar_u + 8, bar_ue = bar_u + 16;
  const uint32_t bar_f = bar_u + 24;                 // NS each, 8 bytes apart
  const uint32_t bar_r = bar_f + 8 * NS, bar_en = bar_r + 8 * NS;
  const uint32_t bar_t = bar_en + 8 * NS;            // NT each
  const uint32_t bar_et = bar_t + 8 * NT;

  // a unit is a (query tile, b, h), the query tile the slowest index;
  // causal units run heaviest first
  const int nq = (S + kFUnit - 1) / kFUnit, nunits = nq * H * B;
  const int ntiles = (S + BN - 1) / BN;
  struct Unit { int h, b, q0, nend; };
  auto unit = [&](int u) {
    const int hb = u % (H * B), rank = u / (H * B);
    const int q0 = (causal ? nq - 1 - rank : rank) * kFUnit;
    return Unit{hb % H, hb / H, q0,
                causal ? min(ntiles, (q0 + kFUnit - 1) / BN + 1) : ntiles};
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_u, 1);
    mbar_init(bar_uc, kFConverters);
    mbar_init(bar_ue, 4);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_r + 8 * s, kFConverters);
      mbar_init(bar_en + 8 * s, 4 + kFConverters);
    }
    for (int u = 0; u < NT; ++u) {
      mbar_init(bar_t + 8 * u, kFConverters);
      mbar_init(bar_et + 8 * u, 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the role, read through a shuffle so that the compiler sees it uniform
  // across each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (wg == 0) {
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      // -------------------------------------------------------- producer
      if (lane != 0) return;
      int it = 0;                  // key tiles loaded so far, all units
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        const int kvh = w.h / (H / KV);
        // Q is free once the last unit's last S retired (a fresh
        // barrier's parity 1 counts as complete)
        mbar_wait(bar_ue, (n & 1) ^ 1);
        mbar_expect_tx(bar_u, UB);
#pragma unroll
        for (int p = 0; p < HD / 32; ++p)
          tma_load(sQ + p * kFUnit * 128, &tq, bar_u, p * 32, w.h, w.q0, w.b);
        for (int j = 0; j < w.nend; ++j, ++it) {
          const int s = it % NS;
          mbar_wait(bar_en + 8 * s, ((it / NS) & 1) ^ 1);
          mbar_expect_tx(bar_f + 8 * s, 2 * TB);
#pragma unroll
          for (int p = 0; p < HD / 32; ++p) {
            tma_load(nat(s, 0) + p * BN * 128, &tk, bar_f + 8 * s, p * 32,
                     kvh, j * BN, w.b);
            tma_load(nat(s, 2) + p * BN * 128, &tv, bar_f + 8 * s, p * 32,
                     kvh, j * BN, w.b);
          }
        }
      }
    } else {
      // ------------------------------------------------------ converters
      // each tile: K's lo tile as it lands, then V's transposed copies once
      // the tile their slot held before is out of its P . V
      const int cw = warp - 1, ctid = threadIdx.x - 32;
      constexpr int NC = 32 * kFConverters;
      int it = 0;
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        mbar_wait(bar_u, n & 1);
        lo_tile(gen(sQ), gen(sQl), UB, ctid, NC);
        publish(bar_uc, lane);
        for (int j = 0; j < w.nend; ++j, ++it) {
          const int s = it % NS, u = it % NT;
          mbar_wait(bar_f + 8 * s, (it / NS) & 1);
          lo_tile(gen(nat(s, 0)), gen(nat(s, 1)), TB, ctid, NC);
          publish(bar_r + 8 * s, lane);
          mbar_wait(bar_et + 8 * u, ((it / NT) & 1) ^ 1);
          transpose_step<HD, kFConverters>(gen(nat(s, 2)), gen(tt(u, 0)),
                                           gen(tt(u, 1)), cw, lane);
          publish(bar_t + 8 * u, lane);
          if (lane == 0) mbar_arrive(bar_en + 8 * s);  // V read for V^T
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumer
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
    const int g = lane >> 2, t = lane & 3;
    float acc[HD / 8][4], fresh[HD / 8][4];
    float sc[BN / 8][4];
    uint32_t ph[4][4], pl[4][4];     // P's A fragments, hi and lo
    float m[2], l[2], corr[2];
    // the current unit's
    int b = 0, row0 = 0, row[2] = {0, 0};
    float slope = 0.f;
    const unsigned char* bias_p = nullptr;         // its (S, S) bias matrix
    bool pairs = false;

    // tile i's natural half converted / transposed copy written, and the
    // releases of its slots
    auto wait_nat = [&](int i) {
      mbar_wait(bar_r + 8 * (i % NS), (i / NS) & 1);
    };
    auto wait_t = [&](int i) {
      mbar_wait(bar_t + 8 * (i % NT), (i / NT) & 1);
    };
    auto free_nat = [&](int i) {
      if (lane == 0) mbar_arrive(bar_en + 8 * (i % NS));
    };
    auto free_t = [&](int i) {
      if (lane == 0) mbar_arrive(bar_et + 8 * (i % NT));
    };
    // S = Q . K^T of the ring's tile i, one group
    auto issue_s = [&](int i) {
      const int s = i % NS;
      ss3<HD>(sc, sQ, sQl, nat(s, 0), nat(s, 1));
      wgmma_commit();
    };
    // fresh = P . V of the ring's tile i (V transposed)
    auto issue_pv = [&](int i) {
      const int u = i % NT;
      rs3(fresh, ph, pl, tt(u, 0), tt(u, 1), 0);
      wgmma_commit();
    };
    // tile j's key liveness as a ballot word, and whether any score of the
    // unit's rows must be hidden; at hd 32 and 64 the bias of the thread's
    // scores is loaded with it, while the products run (at hd 128 no
    // registers are free for it: each pair is added where it is loaded, at
    // the softmax)
    constexpr bool kPrefetchBias = BIAS && HD <= 64;
    uint32_t live = ~0u;
    bool hide = false;
    float bv[BN / 8][4];
    auto key_bits = [&](int j) {
      if constexpr (kPrefetchBias)
        load_bias<false>(bv, bias.dtype, bias_p, pairs, row, j * BN, t, S);
      const int k0 = j * BN;
      const bool diag = causal && k0 + BN - 1 > row0;
      hide = mask != nullptr || k0 + BN > S || diag;
      if (!hide) return;
      const int key = k0 + lane;
      live = __ballot_sync(
          0xffffffffu,
          key < S && (mask == nullptr || mask[(size_t)b * S + key] != 0));
      hide = live != ~0u || diag;
    };
    // tile j's scores in sc to probabilities, the running max and sum
    // updated, and each row's rescale of O in corr
    auto softmax = [&](int j) {
      const int k0 = j * BN;
      // with nothing added to the scores, the scale folds into the
      // exponent: the max of s times scale is the max of the scaled s
      const bool fold = !BIAS && slopes == nullptr;
      if constexpr (kPrefetchBias) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jn][e] = sc[jn][e] * scale + bv[jn][e];
      } else if constexpr (BIAS) {
        // each pair added where it is loaded: no fragment of bias values
        // is held (the dtype dispatched once a tile)
        auto as = [&](auto tag) {
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
      const float xs = fold ? scale : 1.f;   // the scores are sc * xs
      if (slopes != nullptr) {
        const int d0 = k0 + 2 * t - row[0];        // key - query at jn, e = 0
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[jn][e] += slope * (float)(d0 + 8 * jn + (e & 1) - 8 * (e >> 1));
      }
      if (hide) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = 8 * jn + 2 * t + (e & 1);    // key within the tile
            const bool keep = ((live >> kc) & 1u) &&
                              (!causal || k0 + kc <= row[e >> 1]);
            sc[jn][e] = keep ? sc[jn][e] : __int_as_float(0xff800000u);
          }
      }
      float mx[2] = {sc[0][0], sc[0][2]};
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[jn][e]);
      float ms[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(m[r], quad_max(mx[r]) * xs);
        corr[r] = ex2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ms[r] = mx[r] * kLog2e;
      }
      const float c = xs * kLog2e;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sc[jn][e], c, -ms[e >> 1]));
          sc[jn][e] = p;
          psum[e >> 1] += p;
        }
      // the thread's partial row sums; the quad sums them at the end
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
    };
    // tile j's softmax runs while tile j - 1's P . V does, but at hd 128
    // with a bias: there the P . V runs alone before the softmax, 64 of V's
    // columns at a time added straight into O, so that no 128-column fresh
    // tile and no P fragment is live while the bias loads run (with them
    // live, ptxas spilled)
    constexpr bool kOverlap = !(BIAS && HD == 128);
    // O += P . V of the ring's tile i, waited for, in halves of 64 columns
    // (the second half's rows of the transposed copy start 64 rows, 8 KiB,
    // in); then the tile's transposed slot is free
    auto pv_halves = [&](int i) {
      const int u = i % NT;
      float part[8][4];
#pragma unroll
      for (int hh = 0; hh < HD / 64; ++hh) {
        wgmma_fence();
        rs3(part, ph, pl, tt(u, 0) + hh * 64 * 128, tt(u, 1) + hh * 64 * 128,
            0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[8 * hh + nn][e] += part[nn][e];
      }
      free_t(i);
    };
    // O = (O + the last tile's P . V) * corr: both were relative to the
    // last tile's max, the result to this one's
    auto add_fresh = [&] {
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nn][e] = (acc[nn][e] + fresh[nn][e]) * corr[e >> 1];
    };

    int it = 0;                      // the ring's tiles consumed, all units
    for (int n = 0; unit_of(n) < nunits; ++n) {
      const Unit w = unit(unit_of(n));
      const int h = w.h;
      b = w.b;
      row0 = w.q0;
      row[0] = row0 + warp * 16 + g;
      row[1] = row[0] + 8;
      slope = slopes != nullptr ? slopes[h] : 0.f;
      if constexpr (BIAS) {
        const int esize = bias.dtype == 3 ? 4 : 2;
        bias_p = static_cast<const unsigned char*>(bias.p) +
                 (size_t)(b * bias.sb + h * bias.sh) * esize;
        pairs = S % 2 == 0 &&
                reinterpret_cast<uintptr_t>(bias_p) % (2 * esize) == 0;
      }
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = kBigNeg;
        l[r] = 0.f;
      }
      const int nend = w.nend;

      mbar_wait(bar_uc, n & 1);
      wait_nat(it);
      wgmma_fence();
      issue_s(it);
      key_bits(0);
      wgmma_wait<0>();
      free_nat(it);
      if (nend == 1 && lane == 0) mbar_arrive(bar_ue);
      softmax(0);
      split_frags(sc, ph, pl);
      for (int j = 1; j < nend; ++j) {
        wait_nat(it + j);
        wait_t(it + j - 1);
        if constexpr (kOverlap) {
          wgmma_fence();    // covers fresh and the fragments of the last step
          issue_s(it + j);
          issue_pv(it + j - 1);
          key_bits(j);
          wgmma_wait<1>();  // S of tile j is in; tile j - 1's P . V runs on
          free_nat(it + j);
          if (j == nend - 1 && lane == 0) mbar_arrive(bar_ue);  // Q is free
          softmax(j);
          wgmma_wait<0>();
          free_t(it + j - 1);
          add_fresh();
        } else {
          wgmma_fence();
          issue_s(it + j);
          key_bits(j);
          wgmma_wait<0>();
          free_nat(it + j);
          if (j == nend - 1 && lane == 0) mbar_arrive(bar_ue);  // Q is free
          pv_halves(it + j - 1);
          softmax(j);
#pragma unroll
          for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nn][e] *= corr[e >> 1];
        }
        split_frags(sc, ph, pl);
      }
      wait_t(it + nend - 1);
      if constexpr (kOverlap) {
        wgmma_fence();
        issue_pv(it + nend - 1);
        wgmma_wait<0>();
        free_t(it + nend - 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) corr[r] = 1.f;
        add_fresh();
      } else {
        pv_halves(it + nend - 1);
      }
      it += nend;

      // the epilogue overlaps the producer's loads of the next unit
      float lq[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) lq[r] = quad_sum(l[r]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= S) continue;
        const float ls = fmaxf(lq[r], 1e-30f), inv = 1.f / ls;
        float* dst = o + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          store_pair(dst + nn * 8, acc[nn][2 * r] * inv,
                     acc[nn][2 * r + 1] * inv);
        if (t == 0) lse[((size_t)b * H + h) * S + row[r]] = m[r] + logf(ls);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v;
  const uint8_t* mask;
  const float* slopes;
  Bias bias;
  void* o;
  float* lse;
  int B, S, H, KV, hd, causal, dtype;
  float scale;
  cudaStream_t stream;
};

bool args_ok(const Args& a) {
  return a.B > 0 && a.S > 0 && a.H > 0 && a.KV > 0 && a.H % a.KV == 0 &&
         (long long)a.B * a.H * a.S < (1ll << 31) &&
         (a.hd == 32 || a.hd == 64 || a.hd == 128) && a.dtype == 3 &&
         (a.bias.p == nullptr || (a.bias.dtype >= 1 && a.bias.dtype <= 3));
}

template <int HD, bool BIAS>
cudaError_t launch(const Args& a, EncodeTiled enc) {
  CUtensorMap m[3];
  if (!encode_f32(enc, &m[0], a.q, a.B, a.S, a.H, HD, kFUnit) ||
      !encode_f32(enc, &m[1], a.k, a.B, a.S, a.KV, HD, kFStep) ||
      !encode_f32(enc, &m[2], a.v, a.B, a.S, a.KV, HD, kFStep))
    return cudaErrorInvalidValue;
  constexpr int smem = fwd_f32_smem_bytes<HD>();
  auto fn = flash_fwd_f32_sm90_kernel<HD, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = persistent_blocks((long long)((a.S + kFUnit - 1) / kFUnit) * a.H * a.B,
                          &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kFThreads, smem, a.stream>>>(
      m[0], m[1], m[2], a.mask, a.slopes, a.bias, static_cast<float*>(a.o),
      a.lse, a.B, a.S, a.H, a.KV, a.causal, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_bias(const Args& a, EncodeTiled enc) {
  return a.bias.p != nullptr ? launch<HD, true>(a, enc)
                             : launch<HD, false>(a, enc);
}

}  // namespace

// The arguments of the mma.sync library's dstpu_flash_fwd (dtype 3: fp32);
// bias_dtype: 1 fp16, 2 bf16, 3 fp32. mask: (B, S) uint8 or null; slopes:
// (H,) fp32 or null; bias: null, or element (b, h, r, c) at b * bias_sb + h
// * bias_sh + r * S + c; lse: (B, H, S) fp32 out. q, k, v must be 16-byte
// aligned.
extern "C" int dstpu_flash_fwd(const void* q, const void* k, const void* v,
                               const uint8_t* mask, const float* slopes,
                               const void* bias, void* o, float* lse, int B,
                               int S, int H, int KV, int hd, int causal,
                               int dtype, int bias_dtype, long long bias_sb,
                               long long bias_sh, float scale, void* stream) {
  const Args a{q, k, v, mask, slopes, Bias{bias, bias_sb, bias_sh, bias_dtype},
               o, lse, B, S, H, KV, hd, causal, dtype, scale,
               static_cast<cudaStream_t>(stream)};
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  switch (hd) {
    case 32: return static_cast<int>(dispatch_bias<32>(a, enc));
    case 64: return static_cast<int>(dispatch_bias<64>(a, enc));
    default: return static_cast<int>(dispatch_bias<128>(a, enc));
  }
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build): ops/flash_attention.py flash_fwd_f32_plan() must agree.
extern "C" int dstpu_flash_fwd_f32_smem_bytes(int hd) {
  switch (hd) {
    case 32: return fwd_f32_smem_bytes<32>();
    case 64: return fwd_f32_smem_bytes<64>();
    case 128: return fwd_f32_smem_bytes<128>();
    default: return 0;
  }
}
