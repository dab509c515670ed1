// Block-sparse attention's forward on Hopper (sm_90a) for bf16 / fp16
// operands at blocks 64 and 128, hd 32-128: wgmma with fp32 accumulation,
// Q, K and V brought in by TMA from producer warps that walk each unit's
// CSR list, persistent blocks that take the widest lists first. The
// primitives (mbarriers, TMA, descriptors, wgmma, the tensor map encoder)
// are sm90.cuh's, shared with the flash kernels. ops/sparse_attention.py
// routes blocks 64 and 128 at hd 32-128 here by a fixed table; blocks 16
// and 32 and hd 16 stay on the mma.sync forward of sparse_attention.cu,
// which keeps the backward pair.
//
// Replaces the TPU kernel of deepspeed_tpu/ops/sparse_attention.py:
//   sparse_fwd <- _fwd_kernel (:184, pallas_call :310).
//
// Function: the one of sparse_attention.cu's forward, with its rounding
// points. Query block iq attends the key blocks k_idx[iq, :k_n[iq]] (int32,
// ascending, after the causal cut; entries past k_n are padding and never
// read). s = (q . k) in fp32 from storage-dtype operands, times 1/sqrt(hd);
// when causal, keys past the query get no probability (only a list's
// diagonal entry can hold such keys); online softmax in fp32; p rounded to
// v's dtype before p . v; o = acc / max(l, 1e-30) in q's dtype and lse = m
// + log(max(l, 1e-30)) in fp32. No atomics: two calls give the same bits.
//
// Layout: q, o (B, S, H, hd) and k, v (B, S, KV, hd), contiguous (the JAX
// layout); lse (B, H, S) fp32; S a multiple of the block. GQA maps query
// head h to KV head h / (H / KV) by index.
//
// Bound (chip_smoke.py phase 5c prints both terms): the kept (q, k)
// elements times 2 hd flop for each of the two products at 989 TFLOP/s,
// against q, k, v and the lists read and o and lse written once at 3.35
// TB/s. At the slice's shape (B 1, H 25, S 8192, hd 64, the Fixed layout
// with block 64, causal) the operations bound it.
//
// Design (flash_fwd_sm90.cu's, walking a list instead of a row of tiles):
// - The unit is 64 query rows of one (b, h): a q-block at block 64, half
//   of one at block 128. At block 64 the two halves of a 128-row unit would
//   have different lists, so the two consumer warpgroups could not share
//   K / V tiles as the dense kernel's do. So each consumer warpgroup is its
//   own pipeline: its own units, its own K / V ring and barriers, fed by its
//   own producer warp (warps 0 and 1 of the producer warpgroup, one thread
//   each). One code path serves both blocks; at block 128 the two halves of
//   a q-block run on two pipelines and read the same K / V tiles, the second
//   read mostly from L2. Rejected: one consumer warpgroup a block with more
//   blocks an SM (each block would then hold a producer warpgroup of its
//   own and the 227 KiB would be split the same way).
// - Keys come in chunks of 64: one list entry at block 64, half of one at
//   block 128; a streamed tile is two chunks (128 keys, the dense kernel's
//   tile: m64n128 products, half as many softmax steps as one-chunk tiles),
//   one at hd 128, where two 128-key stages would not fit beside the other
//   pipeline's. The producer reads each chunk's list entry from device
//   memory (an L1 / L2 hit after the first) and loads its 64 rows through
//   TMA (4-D tensor maps over the JAX layout, encoded per call) into its
//   half of the tile: k-block jk sits at row jk * block. A tile's second
//   chunk past the list's end is a copy of its first, whose keys the
//   consumers hide. The upper half of a diagonal 128-block is entirely
//   above the first half's queries when causal, and that chunk is skipped.
// - Persistent: one block an SM, 384 threads; each pipeline takes units in
//   passes of the 2 * gridDim.x pipelines, every other pass in reverse, the
//   units ordered by rank in the layout's q_order (widest list first: the
//   heaviest units start first and the narrow ones fill in behind them),
//   then part, batch and head. ops/sparse_attention.py sparse_fwd_units()
//   mirrors the order, and a CPU test holds it to cover every unit once.
// - Products: S = Q . K^T is wgmma m64n{128|64}k16 with both operands
//   K-major in shared memory, started with scale-d 0; O += P . V is
//   m64n{hd}k16 with P
//   from registers (the accumulator fragment of S, rounded to v's dtype)
//   and V read MN-major from the tile as TMA wrote it. Tile j's S and tile
//   j - 1's P . V are issued after one fence, S waited for alone, so tile
//   j's softmax runs while the P . V does.
// - Masks: only a causal list's last entry can hold keys past a query; its
//   chunks test key <= query an element, every other chunk none but a
//   copy past the list's end, hidden whole. The scale folds into the
//   exponent (one FFMA and one ex2 a score).
// - Shared memory: per pipeline Q (64 rows) and kSparseStages<HD> stages of
//   K and V tiles, each with full and empty barriers; the consumer warps
//   release a K stage after its S, a V stage after its P . V.
//   ops/sparse_attention.py sparse_fwd_plan() repeats these numbers.
//
// C interface (ctypes): dstpu_sparse_fwd takes the arguments of
// sparse_attention.cu's function of that name and returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for what it
// does not take (blocks other than 64 and 128, hd outside {32, 64, 128},
// fp32) and cudaErrorNotSupported when libcuda gives no tensor map encoder.

#include "sm90.cuh"   // mbarriers, TMA, descriptors, wgmma, unit order

namespace {

constexpr int kSRows = 64;       // query rows of a unit, keys of a chunk
constexpr int kPipes = 2;        // pipelines a block: consumer warpgroups
// keys of a streamed tile: two 64-key chunks, or one at hd 128 (where two
// stages of 128-key tiles would not fit beside the other pipeline's)
template <int HD> constexpr int kSKeys = HD == 128 ? 64 : 128;
template <int HD> constexpr int kSQB = kSRows * HD * 2;          // Q
template <int HD> constexpr int kSTileB = kSKeys<HD> * HD * 2;   // K or V
// stages of each pipeline's K and V rings: as many as its half of the
// block's shared memory holds, at most 4
template <int HD> constexpr int kSparseStages = HD == 32 ? 4 : 3;
// a pipeline's Q and rings, and its barriers (Q full and empty; per stage
// K and V full and empty)
template <int HD>
constexpr int kPipeB = kSQB<HD> + 2 * kSparseStages<HD> * kSTileB<HD>;
template <int HD> constexpr int kPipeBars = 8 * (2 + 4 * kSparseStages<HD>);
// the pipelines' tiles, then their barriers; 1024 bytes of slack align the
// swizzled tiles
template <int HD>
constexpr int sparse_smem_bytes() {
  return 1024 + kPipes * (kPipeB<HD> + kPipeBars<HD>);
}
static_assert(sparse_smem_bytes<128>() <= 232448, "sparse fwd hd 128 smem");

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv,
                           T* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ k_idx,
                           const int* __restrict__ k_n,
                           const int* __restrict__ order, int A, int B, int S,
                           int H, int KV, int block, int causal,
                           float scale) {
  constexpr int NS = kSparseStages<HD>, BN = kSKeys<HD>;
  constexpr int CH = BN / kSRows;                    // chunks a tile
  constexpr int QB = kSQB<HD>, TB = kSTileB<HD>, RB = kRowB<HD>, PC = kPC<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  // the role, read through a shuffle so that the compiler sees it uniform
  // across each warp: a role branch it took for divergent would serialize
  // the wgmma of the branch
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
  const int lane = threadIdx.x & 31;
  // the pipeline: producer warp w (w < kPipes) feeds consumer warpgroup
  // w + 1 (producer warps 2 and 3 have none and idle)
  const int pipe = wg == 0 ? warp : wg - 1;
  const uint32_t sQ = base + pipe * kPipeB<HD>;
  const uint32_t sK = sQ + QB;                       // NS K tiles
  const uint32_t sV = sK + NS * TB;                  // NS V tiles
  const uint32_t bars = base + kPipes * kPipeB<HD> + pipe * kPipeBars<HD>;
  const uint32_t bar_q = bars, bar_eq = bars + 8;
  const uint32_t bar_k = bars + 16;                  // NS each, 8 bytes apart
  const uint32_t bar_v = bar_k + 8 * NS;
  const uint32_t bar_ek = bar_v + 8 * NS;
  const uint32_t bar_ev = bar_ek + 8 * NS;

  // A unit is 64 query rows: part p of q-block order[rank] of (b, h), the
  // rank the slowest index, then the part, b and h. The pipelines take
  // them in passes of 2 * gridDim.x, every other pass in reverse, as
  // unit_of does for blocks.
  const int parts = block / kSRows;
  const int nunits = (S / block) * parts * H * B;
  const int npipes = kPipes * (int)gridDim.x;
  const int me = kPipes * (int)blockIdx.x + pipe;
  auto unit_at = [&](int k) {
    return k * npipes + (k & 1 ? npipes - 1 - me : me);
  };
  // A unit's keys come in chunks of 64: chunk c is part c % parts of its
  // list's entry c / parts; a tile holds CH chunks.
  struct Unit { int h, b, q0, n, nchunks, ntiles; const int* idx; };
  auto unit = [&](int u) {
    const int hb = u % (H * B), rest = u / (H * B);
    const int part = rest % parts, iq = order[rest / parts];
    const int n = k_n[iq];
    const int* idx = k_idx + (size_t)iq * A;
    // a causal diagonal 128-block's upper half is above every query of
    // its lower half
    const bool skip = causal && parts == 2 && part == 0 && idx[n - 1] == iq;
    const int nchunks = n * parts - (skip ? 1 : 0);
    return Unit{hb % H, hb / H, iq * block + part * kSRows, n, nchunks,
                (nchunks + CH - 1) / CH, idx};
  };
  // the first key of the unit's chunk c
  auto key0 = [&](const Unit& w, int c) {
    return w.idx[c / parts] * block + (c % parts) * kSRows;
  };

  if (threadIdx.x < kPipes) {
    // thread p initializes pipeline p's barriers
    const uint32_t pb =
        base + kPipes * kPipeB<HD> + threadIdx.x * kPipeBars<HD>;
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
    if (warp < kPipes && lane == 0) {
      int it = 0;                  // K / V tiles loaded so far, all units
      for (int n = 0; unit_at(n) < nunits; ++n) {
        const Unit w = unit(unit_at(n));
        const int kvh = w.h / (H / KV);
        // Q is free once the last unit's last Q.K^T has retired (a fresh
        // barrier's parity 1 counts as complete)
        mbar_wait(bar_eq, (n & 1) ^ 1);
        mbar_expect_tx(bar_q, QB);
#pragma unroll
        for (int p = 0; p < HD / PC; ++p)
          tma_load(sQ + p * kSRows * RB, &tq, bar_q, p * PC, w.h, w.q0, w.b);
        for (int j = 0; j < w.ntiles; ++j, ++it) {
          const int s = it % NS, parity = ((it / NS) & 1) ^ 1;
          // the tile's chunks; past the list's end a copy of its first
          // chunk, whose keys the consumers hide (finite values: p = 0
          // times them is 0)
          int k0[CH];
#pragma unroll
          for (int h = 0; h < CH; ++h)
            k0[h] = key0(w, CH * j + h < w.nchunks ? CH * j + h : CH * j);
          // a K stage is free once the Q.K^T that read it has retired, a V
          // stage once its P.V has
          mbar_wait(bar_ek + 8 * s, parity);
          mbar_expect_tx(bar_k + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
#pragma unroll
            for (int h = 0; h < CH; ++h)
              tma_load(sK + s * TB + (p * BN + h * kSRows) * RB, &tk,
                       bar_k + 8 * s, p * PC, kvh, k0[h], w.b);
          mbar_wait(bar_ev + 8 * s, parity);
          mbar_expect_tx(bar_v + 8 * s, TB);
#pragma unroll
          for (int p = 0; p < HD / PC; ++p)
#pragma unroll
            for (int h = 0; h < CH; ++h)
              tma_load(sV + s * TB + (p * BN + h * kSRows) * RB, &tv,
                       bar_v + 8 * s, p * PC, kvh, k0[h], w.b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int g = lane >> 2, t = lane & 3;
    float acc[HD / 8][4];
    float sc[BN / 8][4];
    uint32_t pa[BN / 16][4];
    float m[2], l[2], corr[2];
    int row[2] = {0, 0};

    auto wait_tile = [&](uint32_t bar, int i) {
      mbar_wait(bar + 8 * (i % NS), (i / NS) & 1);
    };
    auto release = [&](uint32_t bar, int i) {
      if (lane == 0) mbar_arrive(bar + 8 * (i % NS));
    };
    // S = Q . K^T of the ring's tile i (issued, committed, not waited for)
    auto issue_qk = [&](int i) {
      const uint32_t k_tile = sK + (i % NS) * TB;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16)
        wgmma_ss(sc, desc_k<HD>(sQ, kSRows, kk), desc_k<HD>(k_tile, BN, kk),
                 kk > 0, T());
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
    // the scores of a tile to probabilities, and each row's correction of
    // the running sums in corr (acc is rescaled later); chunk h's keys from
    // k0[h] are all hidden where dead[h] and test key <= query where
    // diag[h]
    auto softmax = [&](const int (&k0)[CH], const bool (&dead)[CH],
                       const bool (&diag)[CH], bool hide) {
      if (hide) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = jn / 8;            // the chunk of key column jn
            const int key = k0[h] + 8 * (jn % 8) + 2 * t + (e & 1);
            const bool keep = !dead[h] && (!diag[h] || key <= row[e >> 1]);
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
        mx[r] = fmaxf(m[r], quad_max(mx[r]) * scale);
        corr[r] = ex2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ms[r] = mx[r] * kLog2e;
      }
      const float c = scale * kLog2e;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sc[jn][e], c, -ms[e >> 1]));
          sc[jn][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
    };
    // rescale acc (skipped where no row of the warp has a new max), then
    // the probabilities to A fragments of P . V
    auto rescale_pack = [&] {
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nn][e] *= corr[e >> 1];
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
    for (int n = 0; unit_at(n) < nunits; ++n) {
      const Unit w = unit(unit_at(n));
      const int row0 = w.q0;
      row[0] = row0 + warp * 16 + g;
      row[1] = row[0] + 8;
      // only the list's last entry can hold keys past a query: its chunks'
      // first keys from its block, read once
      const int last = (w.n - 1) * parts;
      const int last0 = w.idx[w.n - 1] * block;
      int k0[CH];
      bool dead[CH], diag[CH];
      // tile j's masks: which chunks lie past the list's end (dead) or
      // reach past the unit's first query (diag), and whether any does
      auto masks = [&](int j) {
        bool any = false;
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          const int c = CH * j + h;
          dead[h] = c >= w.nchunks;
          diag[h] = false;
          if (causal && c >= last && !dead[h]) {
            k0[h] = last0 + (c - last) * kSRows;
            diag[h] = k0[h] + kSRows - 1 > row0;
          }
          any = any || dead[h] || diag[h];
        }
        return any;
      };
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = kBigNeg;
        l[r] = 0.f;
      }
      const int nend = w.ntiles;

      mbar_wait(bar_q, n & 1);
      wait_tile(bar_k, it);
      wgmma_fence();
      issue_qk(it);
      bool hide = masks(0);
      wgmma_wait<0>();
      release(bar_ek, it);
      if (nend == 1 && lane == 0) mbar_arrive(bar_eq);
      softmax(k0, dead, diag, hide);
      rescale_pack();
      for (int j = 1; j < nend; ++j) {
        wait_tile(bar_k, it + j);
        wait_tile(bar_v, it + j - 1);
        wgmma_fence();      // covers sc, and acc and pa of the last step
        issue_qk(it + j);
        issue_pv(it + j - 1);
        hide = masks(j);
        wgmma_wait<1>();    // S of tile j is in; P . V of tile j - 1 runs on
        release(bar_ek, it + j);
        if (j == nend - 1 && lane == 0) mbar_arrive(bar_eq);  // Q is free
        softmax(k0, dead, diag, hide);
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
        const float ls = fmaxf(lq[r], 1e-30f), inv = 1.f / ls;
        T* dst = o + (((size_t)w.b * S + row[r]) * H + w.h) * HD + 2 * t;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          *reinterpret_cast<uint32_t*>(dst + nn * 8) =
              pack(acc[nn][2 * r] * inv, acc[nn][2 * r + 1] * inv, T());
        if (t == 0)
          lse[((size_t)w.b * H + w.h) * S + row[r]] = m[r] + logf(ls);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int *idx, *cnt, *order;
  int A, B, S, H, KV, hd, block, causal, dtype;
  float scale;
  cudaStream_t stream;
};

bool args_ok(const Args& a) {
  return (a.block == 64 || a.block == 128) && a.B > 0 && a.S > 0 &&
         a.S % a.block == 0 && a.H > 0 && a.KV > 0 && a.H % a.KV == 0 &&
         a.A > 0 && (long long)a.B * a.H * a.S < (1ll << 31) &&
         (a.hd == 32 || a.hd == 64 || a.hd == 128) &&
         (a.dtype == 1 || a.dtype == 2);
}

template <typename T, int HD>
cudaError_t launch(const Args& a, EncodeTiled enc) {
  CUtensorMap maps[3];
  if (!encode(enc, &maps[0], a.q, a.dtype, a.B, a.S, a.H, HD, kSRows) ||
      !encode(enc, &maps[1], a.k, a.dtype, a.B, a.S, a.KV, HD, kSRows) ||
      !encode(enc, &maps[2], a.v, a.dtype, a.B, a.S, a.KV, HD, kSRows))
    return cudaErrorInvalidValue;
  constexpr int smem = sparse_smem_bytes<HD>();
  auto fn = sparse_fwd_sm90_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM, no more than there are pairs of units
  const long long units = (long long)(a.S / kSRows) * a.H * a.B;
  int blocks = 0;
  err = persistent_blocks((units + kPipes - 1) / kPipes, &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kThreads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<T*>(a.o), a.lse, a.idx, a.cnt,
      a.order, a.A, a.B, a.S, a.H, a.KV, a.block, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, EncodeTiled enc) {
  switch (a.hd) {
    case 32: return launch<T, 32>(a, enc);
    case 64: return launch<T, 64>(a, enc);
    default: return launch<T, 128>(a, enc);
  }
}

}  // namespace

// dtype: 1 fp16, 2 bf16. k_idx (nq, A) / k_n (nq,) int32: the kept k-blocks
// of each q-block; order (nq,) int32: the q-blocks widest list first. lse:
// (B, H, S) fp32 out. q, k, v must be 16-byte aligned.
extern "C" int dstpu_sparse_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, const int* k_idx,
                                const int* k_n, const int* order, int A, int B,
                                int S, int H, int KV, int hd, int block,
                                int causal, int dtype, float scale,
                                void* stream) {
  const Args a{q, k, v, o, lse, k_idx, k_n, order, A, B, S, H, KV, hd, block,
               causal, dtype, scale, static_cast<cudaStream_t>(stream)};
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  return static_cast<int>(dtype == 2 ? dispatch_hd<__nv_bfloat16>(a, enc)
                                     : dispatch_hd<__half>(a, enc));
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build): ops/sparse_attention.py sparse_fwd_plan() must agree.
extern "C" int dstpu_sparse_fwd_smem_bytes(int hd) {
  switch (hd) {
    case 32: return sparse_smem_bytes<32>();
    case 64: return sparse_smem_bytes<64>();
    case 128: return sparse_smem_bytes<128>();
    default: return 0;
  }
}
