// Flash attention's backward for fp32 operands on Hopper (sm_90a): the dq
// kernel (with dbias) and the dk/dv kernel, each a persistent
// warp-specialised kernel whose products are 3xTF32 on wgmma, its tiles
// brought in by TMA. flash_bwd_dq_f32_sm90.cu builds the first,
// flash_bwd_dkv_f32_sm90.cu the second (two libraries, built side by side);
// the TMA, mbarrier and wgmma-descriptor primitives are sm90.cuh's, the
// launch arguments, the unit order and the bias / dbias fragment helpers
// flash_bwd_sm90.cuh's (the bf16 / fp16 pair). ops/flash_attention.py
// routes fp32 dq and dk/dv at hd 32 and 64 here; fp32 at hd 16 and 128
// stays on the mma.sync kernels of flash_attention.cuh
// (flash_attention_f32.cu), by the same fixed table.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py, for
// fp32 operands:
//   flash_bwd_dq  <- _make_bwd_dq_kernel (:228) and, past the TPU's VMEM
//                    budget, _make_bwd_dq_kernel_streamed (:533), dbias
//                    included (:245-274);
//   flash_bwd_dkv <- _make_bwd_dkv_kernel (:285) / _make_bwd_dkv_kernel_streamed
//                    (:581).
//
// Function: the one of flash_attention.cuh's fp32 kernels. s = (q . k) *
// 1/sqrt(hd) + the bias upcast to fp32 + slope_h * (key - query) for ALiBi;
// p = exp(s - lse) from the forward's fp32 lse, 0 where the causal cut, the
// (B, S) key mask or S hides the position; dp = dO . v; ds = p (dp - delta);
// dq = ds . k and dk = ds^T . q, scaled by 1/sqrt(hd) once at the end; dv =
// p^T . dO; dbias = ds in the bias's dtype. dq is exactly 0 on rows with no
// live key, dk and dv exactly 0 on masked keys; no atomics: every output
// element has one writer, and a second run gives the same bits.
//
// Every product is 3xTF32: each fp32 operand x is split once into x_hi
// and x_lo, and x . y is summed as x_lo . y_hi + x_hi . y_lo + x_hi . y_hi
// (the small terms first; x_lo . y_lo, ~2^-20 of the product, dropped).
// The tensor cores read only a tf32 operand's top 19 bits (the card test
// test_tf32_wgmma_reads_the_top_19_bits holds it), so x as it lies serves
// as x_hi = x truncated to tf32, and x_lo = x - x_hi is exact in fp32 and
// truncated in turn: two integer / fp32 operations an element, no
// conversion. That keeps about fp32's accuracy where one tf32 product
// keeps ~1e-3 (tests/test_torch_flash_attention.py emulates both).
//
// Layout: q, dO, dq (B, S, H, hd); k, v, dk, dv (B, S, KV, hd), contiguous
// fp32 (the JAX layout); lse, delta (B, H, S) fp32; GQA by index, dk/dv of
// a KV head summing its group inside one unit; the bias any (B|1, H|1, S,
// S) fp32 / bf16 / fp16 tensor whose last two dims are contiguous; dbias a
// contiguous (B, H, S, S) tensor of the bias's dtype, every element written
// (zeros past the causal cut).
//
// Bound (chip_smoke.py prints it): dq's three products (2 * B * H * S^2 *
// hd flop each, halved when causal) and dk/dv's four, as three tf32
// products each at 495 TFLOP/s (165 TFLOP/s of fp32 work), against each
// input read and each output written once at 3.35 TB/s. The operations
// bound both kernels at GPT-2's shape; with the DS4Science example's full
// (B, H, S, S) fp32 bias at hd 32 the bytes do (dq writes dbias).
//
// Design (the 16-bit pair's of flash_bwd_sm90.cuh, re-derived for tf32):
// - Persistent: one block an SM (fewer if there are fewer units), two
//   warpgroups. Warpgroup 0: warp 0's first thread issues the TMA loads (4-D
//   tensor maps over the JAX layout, encoded per call, boxes of 32 fp32
//   columns in the 128-byte swizzle; rows past S arrive as zeros); warps
//   1-3 are converters. Warpgroup 1, the consumer, runs the products on
//   wgmma and owns a unit of 64 rows (wgmma's m64): query rows for dq, keys
//   for dk/dv.
// - The split happens once per tile per block, by the converters, as soon
//   as a tile lands: TMA's tile is x_hi as it lies, x_lo goes into a tile of
//   the same layout. tf32 has no transpose bit (wgmma takes both
//   shared-memory operands K-major), so the tiles that a gradient product
//   reads along their rows (K for dq += ds . K, Q and dO for dk/dv) get a
//   transposed copy too, hi and lo: row n holds column n of the tile.
// - A tile's two halves go through two rings, each slot with barriers of
//   its own. The natural half (TMA's tiles and their lo tiles) is read by S
//   and dP and its slot is free once they retired and the converters'
//   second pass read it; the transposed half is written in that second pass
//   once the gradient product of the tile its slot held before retired, and
//   is read by the gradient product a step later than S and dP. So no
//   slot waits for a gradient product before its next TMA load. The depths
//   are what fits in shared memory; at GPT-2's shape deeper or shallower
//   rings time the same.
// - dS, P^T and dS^T come out of the accumulators and are split in
//   registers into wgmma's A fragments. The tf32 A fragment holds (row g |
//   g + 8, k t | t + 4), the accumulator (row g | g + 8, col 2t | 2t + 1):
//   instead of moving registers, the contraction index is permuted. Key 2t
//   of each group of 8 stands at k position t and key 2t + 1 at t + 4, in
//   both the A fragment and the transposed tile's rows (pos()), which the
//   converters write in that order at no cost.
// - Shared memory sets the tiles: fp32 tiles are twice bf16's and each
//   split operand is two tiles (four with its transposed copy). A unit is
//   64 rows and a streamed tile 32 rows; dq holds the unit's Q and dO (hi,
//   lo), per natural slot K and V (hi, lo) and per transposed slot K's
//   transposed hi and lo; dk/dv the unit's K and V (hi, lo), per natural
//   slot Q and dO (hi, lo) with the step's lse and delta and per
//   transposed slot their transposed hi and lo. kDqF32Stages /
//   kDkvF32Stages natural slots, kF32TStages transposed ones;
//   ops/flash_attention.py flash_bwd_f32_plan() repeats these numbers and
//   a CPU test holds them to each other and under 227 KiB. At hd 128 no
//   slot would fit beside the unit: fp32 hd 128 stays on mma.sync.
// - dq: per key tile, S = Q . K^T and dP = dO . V^T (both operands K-major
//   in shared memory), ds in registers, then dQ_j = dS . K over the
//   transposed K (A from registers) into a fresh accumulator, added to the
//   running dq in fp32: the tensor cores truncate their fp32 sums, and a
//   chain over every key of a long row drifts (flash_attention.cuh :228).
//   Tile j's S and dP are issued with tile j - 1's dQ product after one
//   fence, so ds of tile j is formed while that product runs.
// - dk/dv: per step of 32 queries of one query head of the group, S^T = K .
//   Q^T and dP^T = V . dO^T, then P^T and dS^T in registers, then dV_i =
//   P^T . dO and dK_i = dS^T . Q over the transposed tiles, each into a
//   fresh accumulator added to the running dV and dK in fp32, as dq does: a
//   chain over the G * S / 32 steps of a unit drifted to 1.3e-5 of max at S
//   1000 and grows with the chain. A step's products run alone: issuing
//   them with the next step's S^T and dP^T timed 3-6% slower on an H100.
// - The lse and delta rows of a dk/dv step are loaded by the converters
//   into its natural slot beside its tiles.
// - Order, masks and the bias: flash_bwd_sm90.cuh's. Causal units run
//   heaviest first, the blocks take the units in passes of gridDim.x; a
//   tile inside S, without a key mask and clear of the causal diagonal
//   checks no element; each thread reads the bias of its own score
//   fragment straight from device memory (loaded while the products run
//   where registers allow), and dq writes its ds fragment to dbias.
//
// C interface (ctypes): dstpu_flash_bwd_dq / dstpu_flash_bwd_dkv take the
// arguments of the mma.sync library's functions of those names and return
// cudaGetLastError() after the launch, cudaErrorInvalidValue for what they
// do not take (16-bit operands, hd outside {32, 64}) and
// cudaErrorNotSupported when libcuda gives no tensor map encoder.

#pragma once

#include "flash_bwd_sm90.cuh"
#include "tf32_sm90.cuh"

namespace {

// ------------------------------------------------------------ geometry
// (the unit, the streamed tile and the transposed ring are tf32_sm90.cuh's)
// ring slots of the natural halves (TMA's tiles and their lo tiles)
template <int HD> constexpr int kDqF32Stages = HD == 32 ? 8 : 4;
template <int HD> constexpr int kDkvF32Stages = HD == 32 ? 8 : 3;
constexpr int kFRowsB = 2 * kFStep * 4;  // dk/dv: a step's lse and delta

// the unit's four tiles, the natural slots (4 tiles; dk/dv: and the rows),
// the transposed slots (dq: 2 tiles, dk/dv: 4), then the barriers (3 for
// the unit, 3 a natural slot, 2 a transposed one); 1024 bytes of slack
// align the swizzled tiles
template <int HD>
constexpr int dq_f32_smem_bytes() {
  return 1024 + 4 * kFUnitB<HD> + kDqF32Stages<HD> * 4 * kFStepB<HD> +
         kF32TStages * 2 * kFStepB<HD> +
         8 * (3 + 3 * kDqF32Stages<HD> + 2 * kF32TStages);
}
template <int HD>
constexpr int dkv_f32_smem_bytes() {
  return 1024 + 4 * kFUnitB<HD> +
         kDkvF32Stages<HD> * (4 * kFStepB<HD> + kFRowsB) +
         kF32TStages * 4 * kFStepB<HD> +
         8 * (3 + 3 * kDkvF32Stages<HD> + 2 * kF32TStages);
}
static_assert(dq_f32_smem_bytes<64>() <= 232448, "dq f32 hd 64 smem");
static_assert(dkv_f32_smem_bytes<64>() <= 232448, "dk/dv f32 hd 64 smem");
static_assert(dq_f32_smem_bytes<32>() <= 232448, "dq f32 hd 32 smem");
static_assert(dkv_f32_smem_bytes<32>() <= 232448, "dk/dv f32 hd 32 smem");

// ------------------------------------------------------------------ dq
template <int HD, bool BIAS>
__global__ void __launch_bounds__(kFThreads, 1)
    flash_bwd_dq_f32_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                                 __grid_constant__ const CUtensorMap tdo,
                                 __grid_constant__ const CUtensorMap tk,
                                 __grid_constant__ const CUtensorMap tv,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ slopes, Bias bias,
                                 float* __restrict__ dq,
                                 void* __restrict__ dbias, int B, int S,
                                 int H, int KV, int causal, float scale) {
  constexpr int NS = kDqF32Stages<HD>, NT = kF32TStages, BN = kFStep;
  constexpr int UB = kFUnitB<HD>, TB = kFStepB<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  auto gen = [&](uint32_t a) { return smem_raw + (a - raw); };
  // the unit's Q and dO: TMA's values (hi) and their lo tiles
  const uint32_t sQ = base, sQl = sQ + UB, sDO = sQl + UB, sDOl = sDO + UB;
  // natural slot s: K (TMA's: hi), K lo, V (hi), V lo; transposed slot u:
  // K^T hi, K^T lo
  const uint32_t sNat = sDOl + UB, sT = sNat + NS * 4 * TB;
  auto nat = [&](int s, int k) { return sNat + (s * 4 + k) * TB; };
  auto tt = [&](int u, int k) { return sT + (u * 2 + k) * TB; };
  // the unit's full (TMA), converted and empty (its last S and dP retired)
  // barriers; per natural slot full, converted and free (S and dP retired,
  // the transposed copy read from it), per transposed slot written and free
  // (dQ retired)
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
      int it = 0;                  // stages loaded so far, all units
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        const int kvh = w.h / (H / KV);
        // Q and dO are free once the last unit's last S and dP retired (a
        // fresh barrier's parity 1 counts as complete)
        mbar_wait(bar_ue, (n & 1) ^ 1);
        mbar_expect_tx(bar_u, 2 * UB);
#pragma unroll
        for (int p = 0; p < HD / 32; ++p) {
          tma_load(sQ + p * kFUnit * 128, &tq, bar_u, p * 32, w.h, w.q0, w.b);
          tma_load(sDO + p * kFUnit * 128, &tdo, bar_u, p * 32, w.h, w.q0,
                   w.b);
        }
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
      // each tile: the natural half as it lands, then the transposed half
      // once the tile its stage held before is out of the dQ product
      const int cw = warp - 1, ctid = threadIdx.x - 32;
      constexpr int NC = 32 * kFConverters;
      int it = 0;
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        mbar_wait(bar_u, n & 1);
        lo_tile(gen(sQ), gen(sQl), UB, ctid, NC);
        lo_tile(gen(sDO), gen(sDOl), UB, ctid, NC);
        publish(bar_uc, lane);
        for (int j = 0; j < w.nend; ++j, ++it) {
          const int s = it % NS, u = it % NT;
          mbar_wait(bar_f + 8 * s, (it / NS) & 1);
          lo_tile(gen(nat(s, 0)), gen(nat(s, 1)), TB, ctid, NC);
          lo_tile(gen(nat(s, 2)), gen(nat(s, 3)), TB, ctid, NC);
          publish(bar_r + 8 * s, lane);
          mbar_wait(bar_et + 8 * u, ((it / NT) & 1) ^ 1);
          transpose_step<HD, kFConverters>(gen(nat(s, 0)), gen(tt(u, 0)),
                                           gen(tt(u, 1)), cw, lane);
          publish(bar_t + 8 * u, lane);
          if (lane == 0) mbar_arrive(bar_en + 8 * s);  // K read for K^T
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumer
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
    const int g = lane >> 2, t = lane & 3;
    float acc[HD / 8][4], fresh[HD / 8][4];
    float sc[BN / 8][4], dp[BN / 8][4];
    uint32_t fh[4][4], fl[4][4];     // dS's A fragments, hi and lo
    // the current unit's
    int b = 0, row0 = 0, row[2] = {0, 0};
    float lse2[2], dlt[2];           // lse * log2(e) and delta of each row
    float slope = 0.f;
    const unsigned char* bias_p = nullptr;         // its (S, S) bias matrix
    unsigned char* dbias_p = nullptr;              // and dbias matrix
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
    // S = Q . K^T and dP = dO . V^T of the ring's tile i, one group
    auto issue_s = [&](int i) {
      const int s = i % NS;
      ss3<HD>(sc, sQ, sQl, nat(s, 0), nat(s, 1));
      ss3<HD>(dp, sDO, sDOl, nat(s, 2), nat(s, 3));
      wgmma_commit();
    };
    // fresh = dS . K of the ring's tile i (K transposed)
    auto issue_dq = [&](int i) {
      const int u = i % NT;
      rs3(fresh, fh, fl, tt(u, 0), tt(u, 1), 0);
      wgmma_commit();
    };
    auto add_fresh = [&] {
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nn][e] += fresh[nn][e];
    };
    // tile j's key liveness as a ballot word, and whether any position of
    // the unit's rows must be hidden; the bias of the thread's scores is
    // loaded with it, while the products run
    uint32_t live = ~0u;
    bool hide = false;
    float bv[BN / 8][4];
    auto key_bits = [&](int j) {
      if constexpr (BIAS)
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
    // tile j's scores and dP to ds (in sc), and ds to dbias
    auto grad = [&](int j) {
      const int k0 = j * BN;
      const bool fold = !BIAS && slopes == nullptr;
      if constexpr (BIAS) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jn][e] = sc[jn][e] * scale + bv[jn][e];
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
            const bool keep = ((live >> kc) & 1u) &&
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

    int it = 0;                      // the ring's tiles consumed, all units
    for (int n = 0; unit_of(n) < nunits; ++n) {
      const Unit w = unit(unit_of(n));
      const int h = w.h;
      b = w.b;
      row0 = w.q0;
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
        pairs = S % 2 == 0 &&
                reinterpret_cast<uintptr_t>(bias_p) % (2 * esize) == 0;
      }
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
      const int nend = w.nend;

      mbar_wait(bar_uc, n & 1);
      wait_nat(it);
      wgmma_fence();
      issue_s(it);
      key_bits(0);
      wgmma_wait<0>();
      free_nat(it);
      if (nend == 1 && lane == 0) mbar_arrive(bar_ue);
      grad(0);
      split_frags(sc, fh, fl);
      for (int j = 1; j < nend; ++j) {
        wait_nat(it + j);
        wait_t(it + j - 1);
        wgmma_fence();      // covers fresh and the fragments of the last step
        issue_s(it + j);
        issue_dq(it + j - 1);
        key_bits(j);
        wgmma_wait<1>();    // S, dP of tile j are in; tile j - 1's dQ runs on
        free_nat(it + j);
        if (j == nend - 1 && lane == 0) mbar_arrive(bar_ue);  // Q, dO free
        grad(j);
        wgmma_wait<0>();
        free_t(it + j - 1);
        add_fresh();
        split_frags(sc, fh, fl);
      }
      wait_t(it + nend - 1);
      wgmma_fence();
      issue_dq(it + nend - 1);
      wgmma_wait<0>();
      free_t(it + nend - 1);
      add_fresh();
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
        float* dst = dq + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          store_pair(dst + nn * 8, acc[nn][2 * r] * scale,
                     acc[nn][2 * r + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------------ dk, dv
template <int HD, bool BIAS>
__global__ void __launch_bounds__(kFThreads, 1)
    flash_bwd_dkv_f32_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                                  __grid_constant__ const CUtensorMap tdo,
                                  __grid_constant__ const CUtensorMap tk,
                                  __grid_constant__ const CUtensorMap tv,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  const uint8_t* __restrict__ mask,
                                  const float* __restrict__ slopes, Bias bias,
                                  float* __restrict__ dk,
                                  float* __restrict__ dv, int B, int S, int H,
                                  int KV, int causal, float scale) {
  constexpr int NS = kDkvF32Stages<HD>, NT = kF32TStages, BM = kFStep;
  constexpr int UB = kFUnitB<HD>, TB = kFStepB<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  auto gen = [&](uint32_t a) { return smem_raw + (a - raw); };
  // the unit's K and V: TMA's values (hi) and their lo tiles
  const uint32_t sK = base, sKl = sK + UB, sV = sKl + UB, sVl = sV + UB;
  // natural slot s: Q (TMA's: hi), Q lo, dO (hi), dO lo, and (after all
  // the tiles) the step's 32 lse and 32 delta values; transposed slot u:
  // Q^T hi, Q^T lo, dO^T hi, dO^T lo
  const uint32_t sNat = sVl + UB, sT = sNat + NS * 4 * TB;
  auto nat = [&](int s, int k) { return sNat + (s * 4 + k) * TB; };
  auto tt = [&](int u, int k) { return sT + (u * 4 + k) * TB; };
  const uint32_t sRows = sT + NT * 4 * TB;
  // barriers as dq's
  const uint32_t bar_u = sRows + NS * kFRowsB;
  const uint32_t bar_uc = bar_u + 8, bar_ue = bar_u + 16;
  const uint32_t bar_f = bar_u + 24;
  const uint32_t bar_r = bar_f + 8 * NS, bar_en = bar_r + 8 * NS;
  const uint32_t bar_t = bar_en + 8 * NS, bar_et = bar_t + 8 * NT;
  float* rows_s = reinterpret_cast<float*>(gen(sRows));

  // a unit is a (key tile, b, KV head), the key tile the slowest index;
  // causal units run heaviest first. Its steps run over (query head of the
  // group, query tile), the query tile the fastest; a causal unit starts
  // at the tile of its first key.
  const int G = H / KV;
  const int nk = (S + kFUnit - 1) / kFUnit, nunits = nk * KV * B;
  const int nqt = (S + BM - 1) / BM;
  struct Unit { int kvh, b, k0, it0, per; };
  auto unit = [&](int u) {
    const int hb = u % (KV * B), k0 = (u / (KV * B)) * kFUnit;
    const int it0 = causal ? k0 / BM : 0;
    return Unit{hb % KV, hb / KV, k0, it0, nqt - it0};
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

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (wg == 0) {
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      // -------------------------------------------------------- producer
      if (lane != 0) return;
      int it = 0;                  // steps loaded so far, all units
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        // K and V are free once the last unit's last S^T and dP^T retired
        mbar_wait(bar_ue, (n & 1) ^ 1);
        mbar_expect_tx(bar_u, 2 * UB);
#pragma unroll
        for (int p = 0; p < HD / 32; ++p) {
          tma_load(sK + p * kFUnit * 128, &tk, bar_u, p * 32, w.kvh, w.k0,
                   w.b);
          tma_load(sV + p * kFUnit * 128, &tv, bar_u, p * 32, w.kvh, w.k0,
                   w.b);
        }
        const int nsteps = G * w.per;
        for (int i = 0; i < nsteps; ++i, ++it) {
          const int h = w.kvh * G + i / w.per;
          const int q0 = (w.it0 + i % w.per) * BM;
          const int s = it % NS;
          mbar_wait(bar_en + 8 * s, ((it / NS) & 1) ^ 1);
          mbar_expect_tx(bar_f + 8 * s, 2 * TB);
#pragma unroll
          for (int p = 0; p < HD / 32; ++p) {
            tma_load(nat(s, 0) + p * BM * 128, &tq, bar_f + 8 * s, p * 32, h,
                     q0, w.b);
            tma_load(nat(s, 2) + p * BM * 128, &tdo, bar_f + 8 * s, p * 32,
                     h, q0, w.b);
          }
        }
      }
    } else {
      // ------------------------------------------------------ converters
      const int cw = warp - 1, ctid = threadIdx.x - 32;
      constexpr int NC = 32 * kFConverters;
      int it = 0;
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        mbar_wait(bar_u, n & 1);
        lo_tile(gen(sK), gen(sKl), UB, ctid, NC);
        lo_tile(gen(sV), gen(sVl), UB, ctid, NC);
        publish(bar_uc, lane);
        const int nsteps = G * w.per;
        for (int i = 0; i < nsteps; ++i, ++it) {
          const int h = w.kvh * G + i / w.per;
          const int q0 = (w.it0 + i % w.per) * BM;
          const int s = it % NS, u = it % NT;
          // the step's lse and delta (0 past S), one value a thread, read
          // while its tiles land
          float rv = 0.f;
          const int q = q0 + (ctid & (BM - 1));
          if (ctid < 2 * BM && q < S)
            rv = (ctid < BM ? lse : delta)[((size_t)w.b * H + h) * S + q];
          // stored once the tiles landed: the consumer read the stage's
          // last rows before it freed the stage for them
          mbar_wait(bar_f + 8 * s, (it / NS) & 1);
          if (ctid < 2 * BM) rows_s[s * 2 * BM + ctid] = rv;
          lo_tile(gen(nat(s, 0)), gen(nat(s, 1)), TB, ctid, NC);
          lo_tile(gen(nat(s, 2)), gen(nat(s, 3)), TB, ctid, NC);
          publish(bar_r + 8 * s, lane);
          mbar_wait(bar_et + 8 * u, ((it / NT) & 1) ^ 1);
          transpose_step<HD, kFConverters>(gen(nat(s, 0)), gen(tt(u, 0)),
                                           gen(tt(u, 1)), cw, lane);
          transpose_step<HD, kFConverters>(gen(nat(s, 2)), gen(tt(u, 2)),
                                           gen(tt(u, 3)), cw, lane);
          publish(bar_t + 8 * u, lane);
          if (lane == 0) mbar_arrive(bar_en + 8 * s);  // Q, dO read
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumer
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
    const int g = lane >> 2, t = lane & 3;
    float dka[HD / 8][4], dva[HD / 8][4];          // the running sums
    float fk[HD / 8][4], fv[HD / 8][4];            // a step's dK and dV
    float st[BM / 8][4], dpt[BM / 8][4];           // (key, query) tiles
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];   // P^T, dS^T fragments
    // with a bias at hd 32 the step's bias fragment is loaded while its
    // products run
    constexpr bool kPrefetchBias = BIAS && HD == 32;
    float bv[BM / 8][4];

    int it = 0;                      // the ring's steps consumed, all units
    for (int n = 0; unit_of(n) < nunits; ++n) {
      const Unit w = unit(unit_of(n));
      const int b = w.b, kw0 = w.k0 + warp * 16;   // the warp's keys
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
      auto head = [&](int i) { return w.kvh * G + i / w.per; };
      auto first_query = [&](int i) { return (w.it0 + i % w.per) * BM; };
      // step i's slots: natural, transposed
      auto slot = [&](int i) { return (it + i) % NS; };
      auto tslot = [&](int i) { return (it + i) % NT; };
      auto wait_nat = [&](int i) {
        mbar_wait(bar_r + 8 * slot(i), ((it + i) / NS) & 1);
      };
      auto wait_t = [&](int i) {
        mbar_wait(bar_t + 8 * tslot(i), ((it + i) / NT) & 1);
      };
      auto free_nat = [&](int i) {
        if (lane == 0) mbar_arrive(bar_en + 8 * slot(i));
      };
      auto free_t = [&](int i) {
        if (lane == 0) mbar_arrive(bar_et + 8 * tslot(i));
      };
      // S^T = K . Q^T and dP^T = V . dO^T of step i
      auto issue_s = [&](int i) {
        const int s = slot(i);
        ss3<HD>(st, sK, sKl, nat(s, 0), nat(s, 1));
        ss3<HD>(dpt, sV, sVl, nat(s, 2), nat(s, 3));
        wgmma_commit();
      };
      // fv = P^T . dO and fk = dS^T . Q of step i over the transposed tiles
      auto issue_dkv = [&](int i) {
        const int u = tslot(i);
        rs3(fv, ph, pl, tt(u, 2), tt(u, 3), 0);
        rs3(fk, dh, dl, tt(u, 0), tt(u, 1), 0);
        wgmma_commit();
      };
      auto add_fresh = [&] {
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dka[nn][e] += fk[nn][e];
            dva[nn][e] += fv[nn][e];
          }
      };
      auto step_issued = [&](int i) {
        if constexpr (kPrefetchBias)
          load_bias_t(bv, bias.dtype, bias_matrix(head(i)), key,
                      first_query(i), t, S);
      };
      auto kv_free = [&](int i) {        // K and V after the last S^T, dP^T
        if (i == nsteps - 1 && lane == 0) mbar_arrive(bar_ue);
      };
      // step i's P^T and dS^T in place
      auto grad = [&](int i) {
        const int h = head(i), q0 = first_query(i);
        const float* ls = rows_s + slot(i) * 2 * BM;
        const float* dl2 = ls + BM;
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
            const float2 dq2 = *reinterpret_cast<const float2*>(dl2 + qc);
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
      auto pack = [&] {
        split_frags(st, ph, pl);
        split_frags(dpt, dh, dl);
      };

#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[nn][e] = dva[nn][e] = 0.f;
      mbar_wait(bar_uc, n & 1);
      for (int i = 0; i < nsteps; ++i) {
        wait_nat(i);
        wgmma_fence();
        issue_s(i);
        step_issued(i);
        wgmma_wait<0>();
        kv_free(i);
        grad(i);
        free_nat(i);          // its lse and delta rows read too
        wait_t(i);
        pack();
        wgmma_fence();
        issue_dkv(i);
        wgmma_wait<0>();
        free_t(i);
        add_fresh();
      }
      it += nsteps;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= S) continue;
        const size_t off = (((size_t)b * S + key[r]) * KV + w.kvh) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn) {
          store_pair(dk + off + nn * 8, dka[nn][2 * r] * scale,
                     dka[nn][2 * r + 1] * scale);
          store_pair(dv + off + nn * 8, dva[nn][2 * r], dva[nn][2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
bool f32_args_ok(const BwdArgs& a) {
  return a.B > 0 && a.S > 0 && a.H > 0 && a.KV > 0 && a.H % a.KV == 0 &&
         (long long)a.B * a.H * a.S < (1ll << 31) &&
         (a.hd == 32 || a.hd == 64) && a.dtype == 3 &&
         (a.bias.p == nullptr || (a.bias.dtype >= 1 && a.bias.dtype <= 3)) &&
         (a.dbias == nullptr || a.bias.p != nullptr);
}

template <int HD, bool BIAS>
cudaError_t launch_dq_f32(const BwdArgs& a, EncodeTiled enc) {
  CUtensorMap m[4];
  if (!encode_f32(enc, &m[0], a.q, a.B, a.S, a.H, HD, kFUnit) ||
      !encode_f32(enc, &m[1], a.dout, a.B, a.S, a.H, HD, kFUnit) ||
      !encode_f32(enc, &m[2], a.k, a.B, a.S, a.KV, HD, kFStep) ||
      !encode_f32(enc, &m[3], a.v, a.B, a.S, a.KV, HD, kFStep))
    return cudaErrorInvalidValue;
  constexpr int smem = dq_f32_smem_bytes<HD>();
  auto fn = flash_bwd_dq_f32_sm90_kernel<HD, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = persistent_blocks((long long)((a.S + kFUnit - 1) / kFUnit) * a.H * a.B,
                          &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kFThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.mask, a.slopes, a.bias,
      static_cast<float*>(a.dq), a.dbias, a.B, a.S, a.H, a.KV, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <int HD, bool BIAS>
cudaError_t launch_dkv_f32(const BwdArgs& a, EncodeTiled enc) {
  CUtensorMap m[4];
  if (!encode_f32(enc, &m[0], a.q, a.B, a.S, a.H, HD, kFStep) ||
      !encode_f32(enc, &m[1], a.dout, a.B, a.S, a.H, HD, kFStep) ||
      !encode_f32(enc, &m[2], a.k, a.B, a.S, a.KV, HD, kFUnit) ||
      !encode_f32(enc, &m[3], a.v, a.B, a.S, a.KV, HD, kFUnit))
    return cudaErrorInvalidValue;
  constexpr int smem = dkv_f32_smem_bytes<HD>();
  auto fn = flash_bwd_dkv_f32_sm90_kernel<HD, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = persistent_blocks(
      (long long)((a.S + kFUnit - 1) / kFUnit) * a.KV * a.B, &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kFThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.mask, a.slopes, a.bias,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.B, a.S, a.H,
      a.KV, a.causal, a.scale);
  return cudaGetLastError();
}

// LAUNCH<HD, BIAS>::run(a, enc) at the call's head dim and bias (each
// source instantiates only its own kernel)
template <template <int, bool> class LAUNCH>
int f32_dispatch(const BwdArgs& a) {
  if (!f32_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool bias = a.bias.p != nullptr;
  const cudaError_t err =
      a.hd == 32 ? (bias ? LAUNCH<32, true>::run(a, enc)
                         : LAUNCH<32, false>::run(a, enc))
                 : (bias ? LAUNCH<64, true>::run(a, enc)
                         : LAUNCH<64, false>::run(a, enc));
  return static_cast<int>(err);
}

}  // namespace
