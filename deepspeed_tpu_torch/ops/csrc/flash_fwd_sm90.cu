// Flash attention's forward for bf16 / fp16 operands on Hopper (sm_90a):
// wgmma on tensor cores with fp32 accumulation, Q, K and V brought in by TMA
// from a producer warp, two consumer warpgroups, persistent blocks that take
// the heaviest causal query tiles first.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_fwd <- _fwd_kernel (:43, pallas_call :210) and, past the TPU's
//                VMEM budget, _fwd_kernel_streamed (:436, pallas_call :514).
// One kernel streams K/V at any S, so it stands for both. The fp32 forward
// and the hd 16 one stay on the mma.sync kernel of flash_attention.cuh;
// ops/flash_attention.py routes on (dtype, hd) by a fixed table. The
// primitives (mbarriers, TMA, descriptors, wgmma, the bias loads, the
// tensor map encoder) are sm90.cuh's, shared with the backward pair
// (flash_bwd_sm90.cuh, built by flash_bwd_dq_sm90.cu and
// flash_bwd_dkv_sm90.cu); this source builds the forward alone.
//
// Function: the one of flash_attention.cuh, with its rounding points. s =
// (q . k) in fp32 from the storage-dtype operands, times 1/sqrt(hd), plus the
// bias upcast to fp32, plus slope_h * (key - query) for ALiBi; positions that
// are causal-hidden, padded out by the (B, S) key mask or past S get no
// probability; online softmax in fp32 (m starts at BIG_NEG = -2^30, the
// floor of JAX's row max); p rounded to v's dtype before p.v; o = acc /
// max(l, 1e-30) in q's dtype and lse = m + log(max(l, 1e-30)) in fp32, so a
// fully masked row gives o = 0 and lse = BIG_NEG + log(1e-30), never NaN. A
// hidden score is -inf here where the mma.sync kernel writes BIG_NEG and
// clears its probability: the row max and every probability come out the
// same, since m never drops below BIG_NEG.
//
// Layout: q, o (B, S, H, hd) and k, v (B, S, KV, hd), contiguous, the JAX
// layout; lse (B, H, S) fp32. GQA maps query head h to KV head h / (H / KV)
// by index. The bias is any (B|1, H|1, S, S) tensor whose last two dims are
// contiguous, in fp32, bf16 or fp16 whatever q's dtype, element (b, h, r, c)
// at b * sb + h * sh + r * S + c with stride 0 on a broadcast dim: it is
// never materialized.
//
// Bound (chip_smoke.py prints both terms for every shape it times): the two
// products, 2 * 2 * B * H * S^2 * hd flop halved when causal, at 989 TFLOP/s,
// against q, k, v and the bias read and o and lse written once at 3.35 TB/s.
// At hd 128 and S >= 2048 (Llama-2-7B, the streamed S 8192) the operations
// bound it; at GPT-2's S 1024 and hd 64, and with a bias (AlphaFold 2's MSA
// rows at hd 32), the bytes.
//
// Design:
// - Persistent: one block an SM (fewer if there are fewer units of work), a
//   unit being 128 query rows of one (b, h). Three warpgroups, 384 threads.
//   Warpgroup 0 is the producer: setmaxnreg gives back all but 24 of its
//   registers and one thread issues the TMA loads; warpgroups 1 and 2 take
//   240 each and own 64 query rows of the unit apiece (wgmma's m64). Keys
//   come 128 a tile; 64 at hd 128 with a bias (no preset runs it), which
//   reads the bias at the softmax. Nothing spills (phase 1 of
//   chip_smoke.py prints ptxas's counts).
// - Order: a unit's query tile is its slowest index, and causal units run
//   heaviest first (the most keys). The blocks take the units in passes of
//   gridDim.x, every other pass in reverse block order, so the block that
//   took a pass's heaviest unit takes the next pass's lightest (plain
//   strides of gridDim.x left a long causal tail).
// - Q, K and V reach shared memory through TMA (cp.async.bulk.tensor), 4-D
//   tensor maps over (hd, heads, S, B) encoded on the host for each call
//   through libcuda's cuTensorMapEncodeTiled, which the runtime hands out
//   (cudaGetDriverEntryPoint: no -lcuda). The JAX layout needs no
//   transpose; rows past S arrive as zeros, and the masks hide those keys.
//   Tiles land in wgmma's 128-byte swizzle, as panels of 64 columns (hd 64
//   one panel, hd 128 two); hd 32's 64-byte rows take the 64-byte swizzle.
// - Q is loaded once a unit, into a buffer freed when the unit's last
//   Q.K^T has retired, so the next unit's Q and first tiles arrive while
//   this one finishes. K and V go through rings of up to 4 stages (160
//   KiB of tiles at most). Each stage has a full barrier for K and one for
//   V (TMA completes them by transaction bytes), and an empty barrier for
//   each that the 8 consumer warps arrive at once the wgmma reading the
//   tile has retired: K's after Q.K^T, V's after P.V, so the next K goes
//   out while a P.V still holds its V. A wait that never completes traps
//   rather than hang the card.
// - Products: S = Q.K^T is wgmma m64n{128|64}k16 with both operands
//   K-major in shared memory; O += P.V is m64n{hd}k16 with P in registers
//   as the A operand (the accumulator fragment of S is, per warp, the
//   layout of an A fragment, rounded to v's dtype in place) and V read
//   MN-major (transposed) from the same tile K's layout gives. The role
//   branch reads the warpgroup through a shuffle, and each step's wgmma
//   follow one fence with no branch between: otherwise ptxas serializes
//   them (a fence it inserts in a path it takes for divergent).
// - Overlap: tile j's S = Q.K^T and tile j - 1's P.V are issued together
//   after one fence, and S is waited for alone, so tile j's masks and bias
//   are applied while the P.V runs; ptxas schedules the P.V's wait ahead
//   of the exponentials (pinning them before it ran slower at hd 64 and
//   128). O is rescaled after the P.V retires. The two warpgroups run
//   unsynchronized, so one group's softmax covers the other's products
//   (taking turns through named barriers measured no faster).
// - The softmax: with no bias and no ALiBi the scale folds into the
//   exponent (one FFMA and one ex2 a score); O's rescale is skipped where no
//   row of the warp has a new max (a factor of exactly 1). A tile inside S,
//   without a key mask and at or below the group's causal diagonal checks
//   no element. Elsewhere each warp turns the tile's key-liveness bytes
//   (the key mask and key < S) into ballot words, before the wait for the
//   scores so the loads overlap the products; a tile whose keys are all
//   live and all at or below the diagonal still checks none, the others
//   test one bit and, when causal, key <= query an element.
// - The bias: each thread reads the bias of its own score fragment (two
//   rows, pairs of adjacent keys) straight from device memory, as pairs
//   where the alignment allows (the two loads of a warp that cover a 32-byte
//   sector follow each other, so L1 serves the second), dtype dispatched
//   once a tile, outside the unrolled element loops. At hd 32 and 64 the
//   loads go out before the wait for the scores; at hd 128 their registers
//   are not free then.
// - Output: o and lse from registers, o in pairs.
//
// C interface (ctypes): dstpu_flash_fwd has the arguments of the mma.sync
// library's function of that name and returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for what it does not take (fp32, hd outside
// {32, 64, 128}) and cudaErrorNotSupported when libcuda gives no tensor map
// encoder.


#include <chrono>

#include "sm90.cuh"   // mbarriers, TMA, descriptors, wgmma, the bias loads

namespace {

constexpr int kBM = 128;         // query rows of a block
// keys of a streamed tile: 128, or 64 at hd 128 with a bias, whose loads
// then compete with the tiles for the consumers' registers
template <int HD, bool BIAS> constexpr int kBN = HD == 128 && BIAS ? 64 : 128;
template <int HD, bool BIAS> constexpr int kTileB = kBN<HD, BIAS> * HD * 2;
template <int HD> constexpr int kQB = kBM * HD * 2;
// stages of the K and V rings: as many as 160 KiB of tiles hold, at most 4
template <int HD, bool BIAS>
constexpr int kStages = (163840 - kQB<HD>) / (2 * kTileB<HD, BIAS>) < 4
                            ? (163840 - kQB<HD>) / (2 * kTileB<HD, BIAS>)
                            : 4;
// Q, then the K ring, then the V ring, then the barriers; 1024 bytes of
// slack align the swizzled tiles
template <int HD, bool BIAS>
constexpr int smem_bytes() {
  return 1024 + kQB<HD> + 2 * kStages<HD, BIAS> * kTileB<HD, BIAS> +
         8 * (2 + 4 * kStages<HD, BIAS>);
}

// ------------------------------------------------------------ the kernel
template <typename T, int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ slopes, Bias bias,
                          T* __restrict__ o, float* __restrict__ lse, int B,
                          int S, int H, int KV, int causal, float scale) {
  constexpr int NS = kStages<HD, BIAS>, BN = kBN<HD, BIAS>;
  constexpr int TB = kTileB<HD, BIAS>, RB = kRowB<HD>, PC = kPC<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kQB<HD>;                  // NS K tiles
  const uint32_t sV = sK + NS * TB;                  // NS V tiles
  // Q full and empty; per stage K and V full (TMA's bytes landed), K and V
  // empty (every consumer warp's product that reads the tile has retired)
  const uint32_t bar_q = sV + NS * TB;
  const uint32_t bar_eq = bar_q + 8;
  const uint32_t bar_k = bar_eq + 8;                 // NS each, 8 bytes apart
  const uint32_t bar_v = bar_k + 8 * NS;
  const uint32_t bar_ek = bar_v + 8 * NS;
  const uint32_t bar_ev = bar_ek + 8 * NS;

  // A unit of work is a (query tile, b, h), the query tile the slowest
  // index; causal units run heaviest first (the tiles with the most keys).
  // The persistent blocks take them in passes of gridDim.x units, every
  // other pass in reverse block order, so the block that took a pass's
  // heaviest unit takes the next pass's lightest: pass k's unit of block c
  // is k * gridDim.x + c, or + gridDim.x - 1 - c for odd k.
  const int nq = (S + kBM - 1) / kBM, nunits = nq * H * B;
  auto unit_of = [&](int k) {
    return k * (int)gridDim.x +
           (k & 1 ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  const int ntiles = (S + BN - 1) / BN;
  struct Unit { int h, b, q0, nend; };
  auto unit = [&](int u) {
    const int hb = u % (H * B), rank = u / (H * B);
    const int q0 = (causal ? nq - 1 - rank : rank) * kBM;
    return Unit{hb % H, hb / H, q0,
                causal ? min(ntiles, (q0 + kBM - 1) / BN + 1) : ntiles};
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

  // the warpgroup, read through a shuffle so that the compiler sees it is
  // uniform across each warp: a role branch it took for divergent would
  // serialize the wgmma of the branch
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                  // K / V tiles loaded so far, all units
      for (int n = 0; unit_of(n) < nunits; ++n) {
        const Unit w = unit(unit_of(n));
        const int kvh = w.h / (H / KV);
        // Q is free once the last unit's last Q.K^T has retired (a stage
        // or buffer's first round passes: parity 1 of a fresh barrier
        // counts as complete)
        mbar_wait(bar_eq, (n & 1) ^ 1);
        mbar_expect_tx(bar_q, kQB<HD>);
#pragma unroll
        for (int p = 0; p < HD / PC; ++p)
          tma_load(sQ + p * kBM * RB, &tq, bar_q, p * PC, w.h, w.q0, w.b);
        for (int j = 0; j < w.nend; ++j, ++it) {
          const int s = it % NS, parity = ((it / NS) & 1) ^ 1;
          // a K stage is free once the Q.K^T that read it has retired, a V
          // stage once its P.V has: K of tile j + 1 goes out while tile
          // j - 1's P.V still holds its V stage
          mbar_wait(bar_ek + 8 * s, parity);
          mbar_expect_tx(bar_k + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
            tma_load(sK + s * TB + p * BN * RB, &tk, bar_k + 8 * s, p * PC,
                     kvh, j * BN, w.b);
          mbar_wait(bar_ev + 8 * s, parity);
          mbar_expect_tx(bar_v + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
            tma_load(sV + s * TB + p * BN * RB, &tv, bar_v + 8 * s, p * PC,
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
    const uint32_t sQw = sQ + cw * 64 * RB;        // the group's rows, panel 0
    float acc[HD / 8][4];
    float sc[BN / 8][4];
    uint32_t pa[BN / 16][4];
    float m[2], l[2], corr[2];
    // the current unit's
    int h = 0, b = 0, row0 = 0, row[2] = {0, 0};
    float slope = 0.f;
    const unsigned char* bias_p = nullptr;         // its (S, S) bias matrix
    bool pairs = false;

    // The wgmma of a step are issued after one fence, with no branch
    // between them (the caller waits for the tiles first): a
    // compiler-inserted fence in a divergent path would serialize them.
    auto wait_tile = [&](uint32_t bars, int i) {
      mbar_wait(bars + 8 * (i % NS), (i / NS) & 1);
    };
    auto release = [&](uint32_t bars, int i) {
      if (lane == 0) mbar_arrive(bars + 8 * (i % NS));
    };
    // S = Q . K^T of the ring's tile i (issued, committed, not waited for)
    auto issue_qk = [&](int i) {
      const uint32_t k_tile = sK + (i % NS) * TB;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16)
        wgmma_ss(sc, desc_k<HD>(sQw, kBM, kk), desc_k<HD>(k_tile, BN, kk),
                 T());
      wgmma_commit();
    };
    // acc += P . V of the ring's tile i (issued, committed)
    auto issue_pv = [&](int i) {
      const uint32_t v_tile = sV + (i % NS) * TB;
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)
        wgmma_rs(acc, pa[c], desc<HD>(v_tile + c * 16 * RB, BN * RB), T());
      wgmma_commit();
    };
    auto zero_scores = [&] {
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
    };
    // The liveness of tile j's keys (the key mask and key < S) as bits of
    // live (bit i of word w: key j * BN + 32 w + i), and in hide whether
    // any score of the group's rows must be hidden: a tile of live keys
    // all at or below the group's causal diagonal hides none. Called
    // before the wait for the tile's scores, so the mask's loads overlap
    // the products.
    uint32_t live[BN / 32];
    bool hide = false;
    // the bias of the thread's scores of a tile; at hd <= 64 read before
    // the wait for the scores (with the key bits), so its loads overlap the
    // products; at hd 128 its registers are not free then, and it is read
    // at the softmax
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
    // the scores of the unit's key tile j in sc to probabilities, and each
    // row's correction of the running sums in corr (acc is rescaled later)
    auto softmax = [&](int j) {
      const int k0 = j * BN;
      // with nothing added to the scores, the scale folds into the
      // exponent: the max of s times scale is the max of the scaled s
      const bool fold = !BIAS && slopes == nullptr;
      if constexpr (BIAS) {
        if constexpr (!kPrefetchBias)
          load_bias<true>(bv, bias.dtype, bias_p, pairs, row, k0, t, S);
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[jn][e] = sc[jn][e] * scale + bv[jn][e];
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
            const bool keep = ((live[jn >> 2] >> (kc & 31)) & 1u) &&
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
    // rescale acc (skipped where no row of the warp has a new max: a
    // factor of exactly 1), then the probabilities to A fragments of P . V
    auto rescale_pack = [&] {
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      }
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        pa[c][0] = pack(sc[2 * c][0], sc[2 * c][1], T());
        pa[c][1] = pack(sc[2 * c][2], sc[2 * c][3], T());
        pa[c][2] = pack(sc[2 * c + 1][0], sc[2 * c + 1][1], T());
        pa[c][3] = pack(sc[2 * c + 1][2], sc[2 * c + 1][3], T());
      }
    };

    int it = 0;                      // the ring's tiles consumed, all units
    for (int n = 0; unit_of(n) < nunits; ++n) {
      const Unit w = unit(unit_of(n));
      h = w.h;
      b = w.b;
      row0 = w.q0 + cw * 64;                       // the group's first row
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

      mbar_wait(bar_q, n & 1);
      wait_tile(bar_k, it);
      zero_scores();
      wgmma_fence();
      issue_qk(it);
      key_bits(0);
      wgmma_wait<0>();
      release(bar_ek, it);
      if (nend == 1 && lane == 0) mbar_arrive(bar_eq);
      softmax(0);
      rescale_pack();
      for (int j = 1; j < nend; ++j) {
        wait_tile(bar_k, it + j);
        wait_tile(bar_v, it + j - 1);
        zero_scores();
        wgmma_fence();      // covers sc, and acc and pa of the last step
        issue_qk(it + j);
        issue_pv(it + j - 1);
        key_bits(j);
        wgmma_wait<1>();    // S of tile j is in; P . V of tile j - 1 runs on
        release(bar_ek, it + j);
        if (j == nend - 1 && lane == 0) mbar_arrive(bar_eq);  // Q is free
        softmax(j);
        wgmma_wait<0>();
        release(bar_ev, it + j - 1);
        rescale_pack();
      }
      wait_tile(bar_v, it + nend - 1);
      wgmma_fence();
      issue_pv(it + nend - 1);
      wgmma_wait<0>();
      release(bar_ev, it + nend - 1);
      it += nend;

      // the epilogue overlaps the producer's loads of the next unit
      float lq[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) lq[r] = quad_sum(l[r]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= S) continue;
        const float ls = fmaxf(lq[r], 1e-30f), inv = 1.f / ls;
        T* dst = o + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          *reinterpret_cast<uint32_t*>(dst + nn * 8) =
              pack(acc[nn][2 * r] * inv, acc[nn][2 * r + 1] * inv, T());
        if (t == 0) lse[((size_t)b * H + h) * S + row[r]] = m[r] + logf(ls);
      }
    }
  }
}


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

// q's, k's and v's tensor maps (boxes of 128 query rows, bn key rows);
// false if the encoder refuses one
bool encode_all(EncodeTiled fn, CUtensorMap (&maps)[3], const Args& a,
                int bn) {
  return encode(fn, &maps[0], a.q, a.dtype, a.B, a.S, a.H, a.hd, kBM) &&
         encode(fn, &maps[1], a.k, a.dtype, a.B, a.S, a.KV, a.hd, bn) &&
         encode(fn, &maps[2], a.v, a.dtype, a.B, a.S, a.KV, a.hd, bn);
}


template <typename T, int HD, bool BIAS>
cudaError_t launch(const Args& a, EncodeTiled enc) {
  CUtensorMap maps[3];
  if (!encode_all(enc, maps, a, kBN<HD, BIAS>)) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<HD, BIAS>();
  auto fn = flash_fwd_sm90_kernel<T, HD, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM (no more than there are work units)
  const long long units = (long long)((a.S + kBM - 1) / kBM) * a.H * a.B;
  const int blocks = (int)(units < sms ? units : sms);
  fn<<<blocks, kThreads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], a.mask, a.slopes, a.bias,
      static_cast<T*>(a.o), a.lse, a.B, a.S, a.H, a.KV, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_bias(const Args& a, EncodeTiled enc) {
  return a.bias.p != nullptr ? launch<T, HD, true>(a, enc)
                             : launch<T, HD, false>(a, enc);
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, EncodeTiled enc) {
  switch (a.hd) {
    case 32: return dispatch_bias<T, 32>(a, enc);
    case 64: return dispatch_bias<T, 64>(a, enc);
    case 128: return dispatch_bias<T, 128>(a, enc);
    default: return cudaErrorInvalidValue;
  }
}

bool args_ok(const Args& a) {
  return a.B > 0 && a.S > 0 && a.H > 0 && a.KV > 0 && a.H % a.KV == 0 &&
         (long long)((a.S + kBM - 1) / kBM) * a.H * a.B < (1ll << 31) &&
         (a.hd == 32 || a.hd == 64 || a.hd == 128) &&
         (a.dtype == 1 || a.dtype == 2) &&
         (a.bias.p == nullptr || (a.bias.dtype >= 1 && a.bias.dtype <= 3));
}

}  // namespace

// The arguments of the mma.sync library's dstpu_flash_fwd. dtype and
// bias_dtype: 1 fp16, 2 bf16, 3 fp32 (the bias only). mask: (B, S) uint8 or
// null; slopes: (H,) fp32 or null; bias: null, or element (b, h, r, c) at
// b * bias_sb + h * bias_sh + r * S + c; lse: (B, H, S) fp32 out. q, k, v
// must be 16-byte aligned.
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
  return static_cast<int>(dtype == 2 ? dispatch_hd<__nv_bfloat16>(a, enc)
                                     : dispatch_hd<__half>(a, enc));
}

// Dynamic shared memory of the kernel at head dim hd, with (bias 1) or
// without the bias (0 for a head dim it does not build): what chip_smoke.py
// prints beside ptxas's registers.
extern "C" int dstpu_flash_fwd_smem_bytes(int hd, int bias) {
  switch (hd) {
    case 32: return bias ? smem_bytes<32, true>() : smem_bytes<32, false>();
    case 64: return bias ? smem_bytes<64, true>() : smem_bytes<64, false>();
    case 128: return bias ? smem_bytes<128, true>() : smem_bytes<128, false>();
    default: return 0;
  }
}

// Host ns of encoding one call's three tensor maps (B, S, H, KV, hd, bf16),
// the mean over `iters` encodings of a 16-byte-aligned stand-in address (the
// encoder reads no device memory); -1 without an encoder.
extern "C" double dstpu_flash_fwd_encode_ns(int B, int S, int H, int KV,
                                            int hd, int iters) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || iters <= 0) return -1.0;
  const void* p = reinterpret_cast<const void*>(uintptr_t{1} << 20);
  Args a{};
  a.q = a.k = a.v = p;
  a.B = B; a.S = S; a.H = H; a.KV = KV; a.hd = hd; a.dtype = 2;
  CUtensorMap maps[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_all(fn, maps, a, 128)) return -1.0;
  const std::chrono::duration<double, std::nano> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / iters;
}
