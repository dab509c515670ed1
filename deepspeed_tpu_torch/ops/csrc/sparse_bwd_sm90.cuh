// Block-sparse attention's backward on Hopper (sm_90a) for bf16 / fp16
// operands at blocks 64 and 128, hd 32-128: the dq kernel and the dk/dv
// kernel, each persistent and warp-specialised, wgmma with fp32
// accumulation, their streamed tiles brought in by TMA from producer warps
// that walk each unit's CSR list. sparse_bwd_dq_sm90.cu builds the first,
// sparse_bwd_dkv_sm90.cu the second (two libraries, so that nvcc builds them
// side by side); the primitives are sm90.cuh's and bulk_copy.cuh's, shared
// with the sparse forward (sparse_fwd_sm90.cu) and the flash kernels.
// ops/sparse_attention.py routes blocks 64 and 128 at hd 32-128 here by a
// fixed table; blocks 16 and 32 and hd 16 stay on the mma.sync pair of
// sparse_attention.cu.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/sparse_attention.py:
//   sparse_bwd_dq  <- _dq_kernel (:223, pallas_call :328);
//   sparse_bwd_dkv <- _dkv_kernel (:252, pallas_call :338).
//
// Function: the one of sparse_attention.cu's backward, with its rounding
// points. Query block iq attends the key blocks k_idx[iq, :k_n[iq]], key
// block jk is attended by the query blocks q_idx[jk, :q_n[jk]] (int32,
// ascending, after the causal cut; entries past the count are padding and
// never read). s = (q . k) in fp32 from storage-dtype operands, times
// 1/sqrt(hd); when causal, keys past the query get p = 0 (only a list's
// diagonal entry can hold such keys: the last of a k-list, the first of a
// q-list); p = exp(s - lse) from the forward's fp32 lse; ds = p (dp -
// delta) with dp = dO . v and delta = rowsum(dO o) computed outside; dq =
// (ds rounded to k's dtype) . k, dk = (ds rounded to q's dtype)^T . q, both
// scaled by 1/sqrt(hd) once at the end; dv = (p rounded to dO's dtype)^T .
// dO. No atomics: every output row has one writer, and two calls give the
// same bits. A k-block that no q-block keeps gets dk = dv = 0.
//
// Layout: q, dO, dq (B, S, H, hd); k, v, dk, dv (B, S, KV, hd), contiguous
// (the JAX layout); lse, delta (B, H, S) fp32; S a multiple of the block.
// GQA maps query head h to KV head h / (H / KV) by index; dk/dv of a KV
// head sum its group's query heads inside one unit.
//
// Bound (chip_smoke.py phase 5c prints both terms): the kept (q, k)
// elements times 2 hd flop for each of dq's three products and dk/dv's
// four at 989 TFLOP/s, against each input read and each output written
// once at 3.35 TB/s. At the slice's shape (B 1, H 25, S 8192, hd 64, the
// Fixed layout with block 64, causal) the operations bound both kernels.
//
// Design (sparse_fwd_sm90.cu's pipelines carrying flash_bwd_sm90.cuh's tile
// math):
// - Persistent: one block an SM, 384 threads. Each consumer warpgroup is
//   its own pipeline of 64-row units, with its own producer warp (warps 0
//   and 1 of the producer warpgroup, one thread each), its own ring and
//   barriers: at block 64 the two halves of a 128-row unit would walk
//   different lists. Each pipeline takes units in passes of 2 * gridDim.x,
//   every other pass in reverse, the units ordered by rank in the layout's
//   q_order (dq) or k_order (dk/dv), widest list first, then part, batch
//   and head; ops/sparse_attention.py sparse_units() mirrors the order. At
//   phase 9's shape the busiest pipeline walks within 3% of the mean list
//   steps, so no list is split over blocks and no partial sums exist.
// - dq: a unit is 64 query rows of one (b, h); its Q and dO come in once
//   (freed when its last S and dP retired), each thread's two lse and delta
//   values go into registers. The producer walks the unit's k-list and
//   TMA-loads each named 64-key chunk of K and of V into a stage (one entry
//   at block 64, half of one at block 128). Per chunk: S = Q.K^T and dP =
//   dO.V^T (wgmma m64n64, both operands K-major in shared memory), ds in
//   registers, then dQ += dS.K with dS an A operand in registers of its own
//   and K read MN-major from the tile as TMA wrote it. Chunk j's S and dP
//   are issued with chunk j - 1's dQ product after one fence, so ds of
//   chunk j is formed while that product runs. V's stage is free after dP,
//   K's after the dQ product.
// - dk/dv: a unit is 64 keys of one (b, KV head); its K and V come in once.
//   The producer steps over (query head of the group, q-list chunk) pairs
//   and TMA-loads each 64-query chunk of Q and of dO, and the chunk's 64 lse
//   and 64 delta values as two 256-byte 1-D bulk copies into the same stage
//   (S is a multiple of the block, so every chunk's rows start on a 256-byte
//   boundary; bulk_load traps on anything else). Per step: S^T = K.Q^T and
//   dP^T = V.dO^T (K-major), P^T and dS^T in registers with lse and delta
//   read per query column from the stage, then dV += P^T.dO and dK +=
//   dS^T.Q with the tiles read MN-major. At hd <= 64 step i's S^T and dP^T
//   are issued with step i - 1's products after one fence; at hd 128 dK and
//   dV take 128 fp32 registers a thread and the products wait, as in the
//   flash dk/dv kernel. A unit whose list is empty loads nothing and writes
//   zeros.
// - Masks: only a causal list's diagonal entry tests key <= query per
//   element (the chunks whose rows reach past the unit's first row, or
//   whose queries start before its last key); at block 128 the diagonal's
//   chunk that lies wholly on the hidden side is skipped: the upper key
//   chunk for the unit's first half (dq), the first query chunk for the
//   unit's second half (dk/dv). The scale folds into the exponent.
// - Shared memory: per pipeline the unit's two tiles and the ring of
//   kDqStages / kDkvStages stages (16-bit tiles, dk/dv's stages with their
//   512 bytes of rows after every pipeline's tiles, so that each tile stays
//   on its swizzle's 1024-byte boundary), then the barriers.
//   ops/sparse_attention.py sparse_bwd_plan() repeats these numbers.
//
// C interface (ctypes): dstpu_sparse_bwd_dq / dstpu_sparse_bwd_dkv take the
// arguments of sparse_attention.cu's functions of those names and return
// cudaGetLastError() after the launch, cudaErrorInvalidValue for what they
// do not take (blocks other than 64 and 128, hd outside {32, 64, 128},
// fp32) and cudaErrorNotSupported when libcuda gives no tensor map encoder.

#pragma once

#include "sm90.cuh"   // mbarriers, TMA, bulk copies, descriptors, wgmma

namespace {

constexpr int kBRows = 64;        // rows of a unit and of a streamed chunk
constexpr int kBPipes = 2;        // pipelines a block: consumer warpgroups
template <int HD> constexpr int kBTileB = kBRows * HD * 2;   // a 16-bit tile
constexpr int kRowsB = 2 * kBRows * 4;   // a dk/dv stage's lse and delta rows
// stages of each pipeline's ring: as many as its half of the block's shared
// memory holds, at most 8
template <int HD> constexpr int kDqStages = HD == 32 ? 8 : HD == 64 ? 6 : 2;
template <int HD> constexpr int kDkvStages = HD == 32 ? 8 : HD == 64 ? 5 : 2;
// a pipeline's tiles (dq: Q, dO and its K and V ring; dk/dv: K, V and its Q
// and dO ring), dk/dv's rows, and its barriers (dq: Q full and empty, four
// a stage; dk/dv: K / V full and empty, two a stage)
template <int HD>
constexpr int kDqPipeB = 2 * kBTileB<HD> + 2 * kDqStages<HD> * kBTileB<HD>;
template <int HD> constexpr int kDqBars = 8 * (2 + 4 * kDqStages<HD>);
template <int HD>
constexpr int kDkvPipeB = 2 * kBTileB<HD> + 2 * kDkvStages<HD> * kBTileB<HD>;
template <int HD> constexpr int kDkvRowsB = kDkvStages<HD> * kRowsB;
template <int HD> constexpr int kDkvBars = 8 * (2 + 2 * kDkvStages<HD>);
// 1024 bytes of slack align the swizzled tiles
template <int HD>
constexpr int sparse_dq_smem_bytes() {
  return 1024 + kBPipes * (kDqPipeB<HD> + kDqBars<HD>);
}
template <int HD>
constexpr int sparse_dkv_smem_bytes() {
  return 1024 + kBPipes * (kDkvPipeB<HD> + kDkvRowsB<HD> + kDkvBars<HD>);
}
static_assert(sparse_dq_smem_bytes<32>() <= 232448, "sparse dq hd 32 smem");
static_assert(sparse_dq_smem_bytes<64>() <= 232448, "sparse dq hd 64 smem");
static_assert(sparse_dq_smem_bytes<128>() <= 232448, "sparse dq hd 128 smem");
static_assert(sparse_dkv_smem_bytes<32>() <= 232448, "sparse dkv hd 32 smem");
static_assert(sparse_dkv_smem_bytes<64>() <= 232448, "sparse dkv hd 64 smem");
static_assert(sparse_dkv_smem_bytes<128>() <= 232448,
              "sparse dkv hd 128 smem");

// ds (or p) of a thread's accumulator fragment, rounded to T, as the A
// fragments of a product over its 64 columns
template <typename T>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&x)[8][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][0] = pack(x[2 * c][0], x[2 * c][1], T());
    a[c][1] = pack(x[2 * c][2], x[2 * c][3], T());
    a[c][2] = pack(x[2 * c + 1][0], x[2 * c + 1][1], T());
    a[c][3] = pack(x[2 * c + 1][2], x[2 * c + 1][3], T());
  }
}

// ------------------------------------------------------------------ dq
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                              __grid_constant__ const CUtensorMap tdo,
                              __grid_constant__ const CUtensorMap tk,
                              __grid_constant__ const CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq,
                              const int* __restrict__ k_idx,
                              const int* __restrict__ k_n,
                              const int* __restrict__ order, int A, int B,
                              int S, int H, int KV, int block, int causal,
                              float scale) {
  constexpr int NS = kDqStages<HD>;
  constexpr int TB = kBTileB<HD>, RB = kRowB<HD>, PC = kPC<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  // the role, read through a shuffle so that the compiler sees it uniform
  // across each warp: a role branch it took for divergent would serialize
  // the wgmma of the branch
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
  const int lane = threadIdx.x & 31;
  // producer warp w (w < kBPipes) feeds consumer warpgroup w + 1
  const int pipe = wg == 0 ? warp : wg - 1;
  const uint32_t sQ = base + pipe * kDqPipeB<HD>;
  const uint32_t sDO = sQ + TB;
  const uint32_t sK = sDO + TB;                      // NS K tiles
  const uint32_t sV = sK + NS * TB;                  // NS V tiles
  const uint32_t bars = base + kBPipes * kDqPipeB<HD> + pipe * kDqBars<HD>;
  const uint32_t bar_q = bars, bar_eq = bars + 8;
  const uint32_t bar_k = bars + 16;                  // NS each, 8 bytes apart
  const uint32_t bar_v = bar_k + 8 * NS;
  const uint32_t bar_ek = bar_v + 8 * NS;
  const uint32_t bar_ev = bar_ek + 8 * NS;

  // A unit is 64 query rows: part p of q-block order[rank] of (b, h), the
  // rank the slowest index, then the part, b and h, taken in passes of the
  // 2 * gridDim.x pipelines, every other pass in reverse.
  const int parts = block / kBRows;
  const int nunits = (S / block) * parts * H * B;
  const int npipes = kBPipes * (int)gridDim.x;
  const int me = kBPipes * (int)blockIdx.x + pipe;
  auto unit_at = [&](int k) {
    return k * npipes + (k & 1 ? npipes - 1 - me : me);
  };
  // A unit's keys come in chunks of 64: chunk c is part c % parts of its
  // list's entry c / parts.
  struct Unit { int h, b, q0, n, nchunks; const int* idx; };
  auto unit = [&](int u) {
    const int hb = u % (H * B), rest = u / (H * B);
    const int part = rest % parts, iq = order[rest / parts];
    const int n = k_n[iq];
    const int* idx = k_idx + (size_t)iq * A;
    // a causal diagonal 128-block's upper half is above every query of
    // its lower half
    const bool skip = causal && parts == 2 && part == 0 && idx[n - 1] == iq;
    return Unit{hb % H, hb / H, iq * block + part * kBRows, n,
                n * parts - (skip ? 1 : 0), idx};
  };

  if (threadIdx.x < kBPipes) {
    // thread p initializes pipeline p's barriers
    const uint32_t pb = base + kBPipes * kDqPipeB<HD> + threadIdx.x * kDqBars<HD>;
    mbar_init(pb, 1);
    mbar_init(pb + 8, 4);
    for (int s = 0; s < NS; ++s) {
      mbar_init(pb + 16 + 8 * s, 1);
      mbar_init(pb + 16 + 8 * (NS + s), 1);
      mbar_init(pb + 16 + 8 * (2 * NS + s), 4);
      mbar_init(pb + 16 + 8 * (3 * NS + s), 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp < kBPipes && lane == 0) {
      int it = 0;                  // K / V chunks loaded so far, all units
      for (int n = 0; unit_at(n) < nunits; ++n) {
        const Unit w = unit(unit_at(n));
        const int kvh = w.h / (H / KV);
        // Q and dO are free once the last unit's last S and dP retired (a
        // fresh barrier's parity 1 counts as complete)
        mbar_wait(bar_eq, (n & 1) ^ 1);
        mbar_expect_tx(bar_q, 2 * TB);
#pragma unroll
        for (int p = 0; p < HD / PC; ++p) {
          tma_load(sQ + p * kBRows * RB, &tq, bar_q, p * PC, w.h, w.q0, w.b);
          tma_load(sDO + p * kBRows * RB, &tdo, bar_q, p * PC, w.h, w.q0,
                   w.b);
        }
        for (int c = 0; c < w.nchunks; ++c, ++it) {
          const int s = it % NS, parity = ((it / NS) & 1) ^ 1;
          const int k0 = w.idx[c / parts] * block + (c % parts) * kBRows;
          // a V stage is free once the dP that read it has retired, a K
          // stage once its dQ product has
          mbar_wait(bar_ev + 8 * s, parity);
          mbar_expect_tx(bar_v + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
            tma_load(sV + s * TB + p * kBRows * RB, &tv, bar_v + 8 * s,
                     p * PC, kvh, k0, w.b);
          mbar_wait(bar_ek + 8 * s, parity);
          mbar_expect_tx(bar_k + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
            tma_load(sK + s * TB + p * kBRows * RB, &tk, bar_k + 8 * s,
                     p * PC, kvh, k0, w.b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int g = lane >> 2, t = lane & 3;
    float acc[HD / 8][4];
    float sc[8][4], dp[8][4];
    uint32_t pa[4][4];
    int row[2] = {0, 0};
    float lse2[2], dlt[2];         // lse * log2(e) and delta of each row
    bool diag = false;             // the chunk tests key <= query
    int kbase = 0;                 // its first key, where it does

    auto wait_tile = [&](uint32_t bar, int i) {
      mbar_wait(bar + 8 * (i % NS), (i / NS) & 1);
    };
    auto release = [&](uint32_t bar, int i) {
      if (lane == 0) mbar_arrive(bar + 8 * (i % NS));
    };
    // S = Q . K^T and dP = dO . V^T of the ring's chunk i, one group (the
    // first k step writes the accumulators: nothing is zeroed)
    auto issue_s = [&](int i) {
      const uint32_t k_tile = sK + (i % NS) * TB, v_tile = sV + (i % NS) * TB;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16)
        wgmma_ss(sc, desc_k<HD>(sQ, kBRows, kk),
                 desc_k<HD>(k_tile, kBRows, kk), kk > 0, T());
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16)
        wgmma_ss(dp, desc_k<HD>(sDO, kBRows, kk),
                 desc_k<HD>(v_tile, kBRows, kk), kk > 0, T());
      wgmma_commit();
    };
    // acc += dS . K of the ring's chunk i (K read MN-major); the unit's
    // first chunk writes acc
    auto issue_dq = [&](int i, int first) {
      const uint32_t k_tile = sK + (i % NS) * TB;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_rs(acc, pa[c], desc<HD>(k_tile + c * 16 * RB, kBRows * RB),
                 !first || c > 0, T());
      wgmma_commit();
    };
    // the scores and dP of a chunk to ds, in sc
    auto grad = [&] {
      const float c = scale * kLog2e;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[jn][e], c, -lse2[e >> 1]));
          if (diag) {
            const int key = kbase + 8 * jn + 2 * t + (e & 1);
            p = key <= row[e >> 1] ? p : 0.f;
          }
          sc[jn][e] = p * (dp[jn][e] - dlt[e >> 1]);
        }
    };

    int it = 0;                      // the ring's chunks consumed, all units
    for (int n = 0; unit_at(n) < nunits; ++n) {
      const Unit w = unit(unit_at(n));
      const int row0 = w.q0;
      row[0] = row0 + warp * 16 + g;
      row[1] = row[0] + 8;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t i = ((size_t)w.b * H + w.h) * S + row[r];
        lse2[r] = lse[i] * kLog2e;
        dlt[r] = delta[i];
      }
      // only the list's last entry can hold keys past a query: its chunks'
      // first keys from its block, read once
      const int last = (w.n - 1) * parts;
      const int last0 = w.idx[w.n - 1] * block;
      auto masks = [&](int c) {
        diag = false;
        if (causal && c >= last) {
          kbase = last0 + (c - last) * kBRows;
          diag = kbase + kBRows - 1 > row0;
        }
      };
      const int nend = w.nchunks;

      mbar_wait(bar_q, n & 1);
      wait_tile(bar_k, it);
      wait_tile(bar_v, it);
      wgmma_fence();
      issue_s(it);
      masks(0);
      wgmma_wait<0>();
      release(bar_ev, it);
      if (nend == 1 && lane == 0) mbar_arrive(bar_eq);
      grad();
      pack_frags<T>(pa, sc);
      for (int j = 1; j < nend; ++j) {
        wait_tile(bar_k, it + j);
        wait_tile(bar_v, it + j);
        wgmma_fence();      // covers sc, dp, and acc and pa of the last chunk
        issue_s(it + j);
        issue_dq(it + j - 1, j == 1);
        masks(j);
        wgmma_wait<1>();    // S, dP of chunk j are in; chunk j - 1's dQ runs
        release(bar_ev, it + j);
        if (j == nend - 1 && lane == 0) mbar_arrive(bar_eq);  // Q, dO free
        grad();
        wgmma_wait<0>();
        release(bar_ek, it + j - 1);
        pack_frags<T>(pa, sc);
      }
      wgmma_fence();
      issue_dq(it + nend - 1, nend == 1);
      wgmma_wait<0>();
      release(bar_ek, it + nend - 1);
      it += nend;

      // the epilogue overlaps the producer's loads of the next unit
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        T* dst = dq + (((size_t)w.b * S + row[r]) * H + w.h) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          *reinterpret_cast<uint32_t*>(dst + nn * 8) =
              pack(acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale, T());
      }
    }
  }
}

// ------------------------------------------------------------------ dk, dv
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_bwd_dkv_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                               __grid_constant__ const CUtensorMap tdo,
                               __grid_constant__ const CUtensorMap tk,
                               __grid_constant__ const CUtensorMap tv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv,
                               const int* __restrict__ q_idx,
                               const int* __restrict__ q_n,
                               const int* __restrict__ order, int A, int B,
                               int S, int H, int KV, int block, int causal,
                               float scale) {
  constexpr int NS = kDkvStages<HD>;
  constexpr int TB = kBTileB<HD>, RB = kRowB<HD>, PC = kPC<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int pipe = wg == 0 ? warp : wg - 1;
  const uint32_t sK = base + pipe * kDkvPipeB<HD>;
  const uint32_t sV = sK + TB;
  const uint32_t sQ = sV + TB;                       // NS Q tiles
  const uint32_t sDO = sQ + NS * TB;                 // NS dO tiles
  // per stage 64 lse then 64 delta values, after every pipeline's tiles
  const uint32_t sRows =
      base + kBPipes * kDkvPipeB<HD> + pipe * kDkvRowsB<HD>;
  const uint32_t bars = base + kBPipes * (kDkvPipeB<HD> + kDkvRowsB<HD>) +
                        pipe * kDkvBars<HD>;
  const uint32_t bar_kv = bars, bar_ekv = bars + 8;
  const uint32_t bar_f = bars + 16;                  // NS each
  const uint32_t bar_e = bar_f + 8 * NS;
  const float* rows_s =                              // its generic address
      reinterpret_cast<const float*>(smem_raw + (sRows - smem_u32(smem_raw)));

  // A unit is 64 keys: part p of k-block order[rank] of (b, KV head), the
  // rank the slowest index, then the part, b and the KV head. Its steps run
  // over (query head of the group, chunk of its q-list), the chunk the
  // fastest; chunk c is part c % parts of the list's entry c / parts.
  const int G = H / KV;
  const int parts = block / kBRows;
  const int nunits = (S / block) * parts * KV * B;
  const int npipes = kBPipes * (int)gridDim.x;
  const int me = kBPipes * (int)blockIdx.x + pipe;
  auto unit_at = [&](int k) {
    return k * npipes + (k & 1 ? npipes - 1 - me : me);
  };
  struct Unit { int kvh, b, k0, n, nchunks, skip; const int* idx; };
  auto unit = [&](int u) {
    const int hb = u % (KV * B), rest = u / (KV * B);
    const int part = rest % parts, jk = order[rest / parts];
    const int n = q_n[jk];
    const int* idx = q_idx + (size_t)jk * A;
    // a causal diagonal 128-block's first query chunk lies wholly before
    // the keys of its second half
    const int skip =
        causal && parts == 2 && part == 1 && n > 0 && idx[0] == jk ? 1 : 0;
    return Unit{hb % KV, hb / KV, jk * block + part * kBRows, n,
                n * parts - skip, skip, idx};
  };

  if (threadIdx.x < kBPipes) {
    const uint32_t pb = base + kBPipes * (kDkvPipeB<HD> + kDkvRowsB<HD>) +
                        threadIdx.x * kDkvBars<HD>;
    mbar_init(pb, 1);
    mbar_init(pb + 8, 4);
    for (int s = 0; s < NS; ++s) {
      mbar_init(pb + 16 + 8 * s, 1);
      mbar_init(pb + 16 + 8 * (NS + s), 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp < kBPipes && lane == 0) {
      int it = 0;                  // steps loaded so far, all units
      int ku = 0;                  // units with a step, whose K / V came in
      for (int n = 0; unit_at(n) < nunits; ++n) {
        const Unit w = unit(unit_at(n));
        const int nsteps = G * w.nchunks;
        if (nsteps == 0) continue;           // no q-block keeps its keys
        // K and V are free once the last unit's last S^T and dP^T retired
        mbar_wait(bar_ekv, (ku & 1) ^ 1);
        mbar_expect_tx(bar_kv, 2 * TB);
#pragma unroll
        for (int p = 0; p < HD / PC; ++p) {
          tma_load(sK + p * kBRows * RB, &tk, bar_kv, p * PC, w.kvh, w.k0,
                   w.b);
          tma_load(sV + p * kBRows * RB, &tv, bar_kv, p * PC, w.kvh, w.k0,
                   w.b);
        }
        ++ku;
        for (int i = 0; i < nsteps; ++i, ++it) {
          const int h = w.kvh * G + i / w.nchunks;
          const int c = i % w.nchunks + w.skip;
          const int q0 = w.idx[c / parts] * block + (c % parts) * kBRows;
          const int s = it % NS, parity = ((it / NS) & 1) ^ 1;
          // a stage is free once both products that read it retired
          mbar_wait(bar_e + 8 * s, parity);
          mbar_expect_tx(bar_f + 8 * s, 2 * TB + kRowsB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p) {
            tma_load(sQ + s * TB + p * kBRows * RB, &tq, bar_f + 8 * s,
                     p * PC, h, q0, w.b);
            tma_load(sDO + s * TB + p * kBRows * RB, &tdo, bar_f + 8 * s,
                     p * PC, h, q0, w.b);
          }
          const size_t r = ((size_t)w.b * H + h) * S + q0;
          bulk_load(sRows + s * kRowsB, lse + r, kRowsB / 2, bar_f + 8 * s);
          bulk_load(sRows + s * kRowsB + kRowsB / 2, delta + r, kRowsB / 2,
                    bar_f + 8 * s);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int g = lane >> 2, t = lane & 3;
    float dka[HD / 8][4], dva[HD / 8][4];
    float st[8][4], dpt[8][4];                     // (key, query) tiles
    uint32_t pp[4][4], pd[4][4];
    bool diag = false;             // the step tests key <= query
    int qbase = 0;                 // its first query, where it does
    // Without a step's products overlapping the next step's S^T and dP^T at
    // hd 128: dK and dV take 128 fp32 registers a thread there
    constexpr bool kOverlap = HD <= 64;

    int it = 0, ku = 0;              // as the producer counts them
    for (int n = 0; unit_at(n) < nunits; ++n) {
      const Unit w = unit(unit_at(n));
      const int key[2] = {w.k0 + warp * 16 + g, w.k0 + warp * 16 + g + 8};
      const int nsteps = G * w.nchunks;
      if (nsteps == 0) {
        // a k-block no q-block keeps: dk = dv = 0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t off =
              (((size_t)w.b * S + key[r]) * KV + w.kvh) * HD + 2 * t;
#pragma unroll
          for (int nn = 0; nn < HD / 8; ++nn) {
            *reinterpret_cast<uint32_t*>(dk + off + nn * 8) = 0u;
            *reinterpret_cast<uint32_t*>(dv + off + nn * 8) = 0u;
          }
        }
        continue;
      }
      // only the first entry of a causal q-list can hold queries before the
      // unit's keys: its chunks' first queries from its block, read once
      const int first0 = w.idx[0] * block;
      auto stage = [&](int i) { return (it + i) % NS; };
      auto masks = [&](int i) {
        const int c = i % w.nchunks + w.skip;
        diag = false;
        if (causal && c < parts) {
          qbase = first0 + c * kBRows;
          diag = qbase < w.k0 + kBRows - 1;
        }
      };
      auto wait_step = [&](int i) {
        mbar_wait(bar_f + 8 * stage(i), ((it + i) / NS) & 1);
      };
      // S^T = K . Q^T and dP^T = V . dO^T of step i, one group
      auto issue_s = [&](int i) {
        const uint32_t q_tile = sQ + stage(i) * TB;
        const uint32_t do_tile = sDO + stage(i) * TB;
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16)
          wgmma_ss(st, desc_k<HD>(sK, kBRows, kk),
                   desc_k<HD>(q_tile, kBRows, kk), kk > 0, T());
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16)
          wgmma_ss(dpt, desc_k<HD>(sV, kBRows, kk),
                   desc_k<HD>(do_tile, kBRows, kk), kk > 0, T());
        wgmma_commit();
      };
      // dV += P^T . dO and dK += dS^T . Q of step i (the unit's first step
      // writes them)
      auto issue_dkv = [&](int i) {
        const uint32_t q_tile = sQ + stage(i) * TB;
        const uint32_t do_tile = sDO + stage(i) * TB;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wgmma_rs(dva, pp[c], desc<HD>(do_tile + c * 16 * RB, kBRows * RB),
                   i > 0 || c > 0, T());
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wgmma_rs(dka, pd[c], desc<HD>(q_tile + c * 16 * RB, kBRows * RB),
                   i > 0 || c > 0, T());
        wgmma_commit();
      };
      auto release = [&](int i) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * stage(i));
      };
      auto kv_free = [&](int i) {        // K and V after the last S^T, dP^T
        if (i == nsteps - 1 && lane == 0) mbar_arrive(bar_ekv);
      };
      // step i's P^T and dS^T in place, lse and delta read per query column
      // from the stage's rows
      auto grad = [&](int i) {
        const float* ls = rows_s + stage(i) * (kRowsB / 4);
        const float* dl = ls + kBRows;
        const float c = scale * kLog2e;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int qc = 8 * jn + 2 * t;                  // query column
          const float2 lq = *reinterpret_cast<const float2*>(ls + qc);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + qc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(st[jn][e], c,
                               -(e & 1 ? lq.y : lq.x) * kLog2e));
            if (diag) p = key[e >> 1] <= qbase + qc + (e & 1) ? p : 0.f;
            st[jn][e] = p;
            dpt[jn][e] = p * (dpt[jn][e] - (e & 1 ? d2.y : d2.x));
          }
        }
      };

      mbar_wait(bar_kv, ku & 1);
      if constexpr (kOverlap) {
        // step i's S^T and dP^T go out with step i - 1's dV and dK after
        // one fence; step i's P^T and dS^T are formed while those run
        wait_step(0);
        wgmma_fence();
        issue_s(0);
        masks(0);
        wgmma_wait<0>();
        kv_free(0);
        grad(0);
        pack_frags<T>(pp, st);
        pack_frags<T>(pd, dpt);
        for (int i = 1; i < nsteps; ++i) {
          wait_step(i);
          wgmma_fence();
          issue_s(i);
          issue_dkv(i - 1);
          masks(i);
          wgmma_wait<1>();
          kv_free(i);
          grad(i);
          wgmma_wait<0>();
          release(i - 1);
          pack_frags<T>(pp, st);
          pack_frags<T>(pd, dpt);
        }
        wgmma_fence();
        issue_dkv(nsteps - 1);
        wgmma_wait<0>();
        release(nsteps - 1);
      } else {
        for (int i = 0; i < nsteps; ++i) {
          wait_step(i);
          wgmma_fence();
          issue_s(i);
          masks(i);
          wgmma_wait<0>();
          kv_free(i);
          grad(i);
          pack_frags<T>(pp, st);
          pack_frags<T>(pd, dpt);
          wgmma_fence();
          issue_dkv(i);
          wgmma_wait<0>();
          release(i);
        }
      }
      it += nsteps;
      ++ku;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t off =
            (((size_t)w.b * S + key[r]) * KV + w.kvh) * HD + 2 * t;
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
struct SparseBwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  const int *idx, *cnt, *order;
  int A, B, S, H, KV, hd, block, causal, dtype;
  float scale;
  cudaStream_t stream;
};

bool sparse_bwd_args_ok(const SparseBwdArgs& a) {
  return (a.block == 64 || a.block == 128) && a.B > 0 && a.S > 0 &&
         a.S % a.block == 0 && a.H > 0 && a.KV > 0 && a.H % a.KV == 0 &&
         a.A > 0 && (long long)a.B * a.H * a.S < (1ll << 31) &&
         (a.hd == 32 || a.hd == 64 || a.hd == 128) &&
         (a.dtype == 1 || a.dtype == 2);
}

// the four tensor maps (q, dO, k, v), boxes of one head's 64 rows
bool sparse_bwd_maps(const SparseBwdArgs& a, EncodeTiled enc, CUtensorMap* m) {
  return encode(enc, &m[0], a.q, a.dtype, a.B, a.S, a.H, a.hd, kBRows) &&
         encode(enc, &m[1], a.dout, a.dtype, a.B, a.S, a.H, a.hd, kBRows) &&
         encode(enc, &m[2], a.k, a.dtype, a.B, a.S, a.KV, a.hd, kBRows) &&
         encode(enc, &m[3], a.v, a.dtype, a.B, a.S, a.KV, a.hd, kBRows);
}

template <typename T, int HD>
cudaError_t launch_sparse_dq(const SparseBwdArgs& a, EncodeTiled enc) {
  CUtensorMap m[4];
  if (!sparse_bwd_maps(a, enc, m)) return cudaErrorInvalidValue;
  constexpr int smem = sparse_dq_smem_bytes<HD>();
  auto fn = sparse_bwd_dq_sm90_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM, no more than there are pairs of units
  const long long units = (long long)(a.S / kBRows) * a.H * a.B;
  int blocks = 0;
  err = persistent_blocks((units + kBPipes - 1) / kBPipes, &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<T*>(a.dq), a.idx,
      a.cnt, a.order, a.A, a.B, a.S, a.H, a.KV, a.block, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_sparse_dkv(const SparseBwdArgs& a, EncodeTiled enc) {
  CUtensorMap m[4];
  if (!sparse_bwd_maps(a, enc, m)) return cudaErrorInvalidValue;
  constexpr int smem = sparse_dkv_smem_bytes<HD>();
  auto fn = sparse_bwd_dkv_sm90_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long units = (long long)(a.S / kBRows) * a.KV * a.B;
  int blocks = 0;
  err = persistent_blocks((units + kBPipes - 1) / kBPipes, &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.idx, a.cnt, a.order, a.A, a.B, a.S, a.H, a.KV,
      a.block, a.causal, a.scale);
  return cudaGetLastError();
}

// LAUNCH<T, HD>::run(a, enc) at the call's dtype and head dim (each source
// instantiates only its own kernel)
template <template <typename, int> class LAUNCH>
int sparse_bwd_dispatch(const SparseBwdArgs& a) {
  if (!sparse_bwd_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto by_hd = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    switch (a.hd) {
      case 32: return LAUNCH<T, 32>::run(a, enc);
      case 64: return LAUNCH<T, 64>::run(a, enc);
      default: return LAUNCH<T, 128>::run(a, enc);
    }
  };
  return static_cast<int>(a.dtype == 2 ? by_hd(__nv_bfloat16())
                                       : by_hd(__half()));
}

}  // namespace
