// The backward of the fused softmax cross-entropy over the unembedding on
// Hopper (sm_90a): dx, dW and db in one call, bf16 operands, fp32
// accumulation, every product on wgmma with its operands brought in by TMA
// from a producer warp.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/xent.py:
//   _dx_kernel (:110) and _dw_kernel (:128, which also emits db), both
//   launched by _bwd_kernels (:300, pallas_calls :315 and :332).
// The TPU needs two kernels only because a Pallas output block may be
// revisited on consecutive grid steps alone; here one call forms each
// logits tile once and feeds it to all three outputs.
//
// Function (the rounding points of the Pallas kernels and of
// xent_bwd_plain): x (T, d), W (V, d) in the embedding table's layout, bias
// (V,) in x's dtype or null, targets (T,) int32, lse and g (T,) fp32.
//   logits = x . W^T in fp32 from the bf16 operands, plus float(bias);
//   dl = (exp(logits - lse) - onehot) * g in fp32, 0 on columns >= V; a
//   target outside [0, V) matches nothing, a row with g = 0 gives 0;
//   dl rounded to bf16 before dx = dl . W and dW = dl^T . x (fp32 sums,
//   bf16 out); db = the fp32 sum over tokens of the unrounded dl.
// No (T, V) tensor is formed; no atomics, every sum in a fixed order, so
// repeated calls are bit-identical.
//
// Bound: one recompute of the logits and two products, 6 T V d operations
// at 989 TFLOP/s (GPT-2 1.5B's head, T 4092, V 50257, d 1600: 1996 us;
// BERT-large's, T 8192, V 30522, d 1024: 1553 us; T 8191: 3996 us), far
// above the bytes of x, W, dx and dW at 3.35 TB/s: bound by operations.
//
// Design. The vocabulary is walked in chunks of vc rows (a multiple of 256,
// 8192 by default: ops/xent.py xent_bwd_plan), two launches a chunk c:
//   (a) xent_dl_kernel: dl_c = softmax-backward(x . W_c^T + b_c), a GEMM
//       over d in tiles of 256 tokens x 128 vocab rows; its epilogue applies
//       bias, lse, g, the onehot and the mask in fp32, stores dl_c as bf16
//       into a (T, vc) scratch and the tile's fp32 column sums of the
//       unrounded dl, one row per 256-token tile, into a (ceil(T / 256), vc)
//       scratch.
//   (b) xent_prod_kernel, one grid over two kinds of 256 x 128 tiles:
//       dW_c = dl_c^T . x, the whole contraction over T inside the tile's
//       loop, written once as bf16; the tiles of the first 128 columns sum
//       db_c from (a)'s partials in token-tile order. And dx += dl_c . W_c
//       into an fp32 (T, d) buffer: the first chunk stores, the middle ones
//       read, add and store, the last writes bf16 dx (one chunk: dx
//       directly, no buffer).
// The scratch (dl_c, db partials, the dx buffer) does not grow with V; the
// wrapper caches it per device (GPT-2's head: 94 MB, BERT's 169 MB, T 8191's
// 188 MB).
//
// Every launch is persistent: one block an SM, each taking the next tile as
// it frees up from a counter the launch leaves at 0 ((b)'s kind with the
// longer contraction first; which block computes a tile changes nothing of
// its result). A block has 288 threads: two consumer warpgroups, each
// owning 128 rows of the tile as two m64n128k16 products a 16-deep step,
// and a producer warp, one thread of which issues the TMA loads. ptxas
// gives the consumers 168 registers (a producer warpgroup and setmaxnreg
// did not raise it); the 128 of the accumulator leave (a)'s epilogue room
// only with its rows' target, lse and g and its columns' bias in shared
// memory. A tile's contraction streams in slabs of 64 through a ring of 4
// stages of 48 KB (A 256 x 64, B 128 x 64, 2-D TMA boxes of 64 x 64 in the
// 128-byte swizzle) on full / empty mbarriers; a consumer keeps one slab's
// products in flight (wgmma.wait_group 1) and frees the slab before it. The
// ring runs on across tiles, so the next tile's loads overlap this tile's
// epilogue.
// Sums start with wgmma's scale-d 0 (no zeroed accumulators) and the role
// branch is warp-uniform: ptxas injects no warpgroup wait.
// Operand layouts: (a) both K-major; (b)'s B (x's or W's rows, d
// contiguous) MN-major through wgmma's transpose bit; dx's A (dl_c rows)
// K-major, dW's A = dl_c^T read MN-major from the same (T, vc) scratch
// through the transpose bit, so (a) stores dl_c once, in one layout.
// TMA fills rows past T, V or d with zeros; the epilogues mask them.
//
// Probes on an H100 (PERF.md §6): the widest chunk was fastest (fewer
// launches, tails and passes over the dx buffer; 8192 against 2048 rows:
// GPT-2's head 3.7 against 5.1 ms); a call spends ~36% in (a) at GPT-2's
// head, ~42% at BERT's, whose 16 slabs of d a tile weigh less against the
// epilogue. (a)'s rows and bias read from device memory in the epilogue
// cost BERT's head 6-8%; staged in shared memory before the contraction, no
// longer.
//
// C interface (ctypes): dstpu_xent_bwd runs the whole call (every chunk)
// and returns cudaGetLastError() after its launches, cudaErrorInvalidValue
// for what it does not take, cudaErrorNotSupported when libcuda gives no
// tensor map encoder.

#include "sm90.cuh"   // mbarriers, TMA, descriptors, wgmma fences, pack

namespace {

typedef __nv_bfloat16 bf16;

// two consumer warpgroups (warps 0-7), then one producer warp
constexpr int kBlockThreads = 288;
constexpr int kConsumers = 256;
constexpr int kBM = 256;         // rows of a tile: two consumer groups of 128
constexpr int kBN = 128;         // columns of a tile
constexpr int kBK = 64;          // contraction slab: one 128-byte swizzle row
constexpr int kBox = 64 * 64 * 2;          // one 64 x 64 TMA box, 8 KB
constexpr int kAB = kBM * kBK * 2;         // A slab, 32 KB
constexpr int kStage = kAB + kBN * kBK * 2;   // + B slab, 48 KB
constexpr int kNS = 4;           // stages of the ring
constexpr int kRed = 8 * kBN * 4;          // (a)'s column-sum exchange
// (a)'s rows' (lse, g) pairs and targets, then its columns' bias
constexpr int kRows = (3 * kBM + kBN) * 4;
// the ring, red, rows, then the barriers: full and empty a stage, full and
// empty for each of the two slots of tile indices, then those two slots
constexpr int kSmem = 1024 + kNS * kStage + kRed + kRows + 16 * kNS + 32 + 8;

struct Args {
  const bf16* bias;
  const int* tgt;
  const float* lse;
  const float* g;
  bf16* dl;          // (T, vc) scratch
  float* dbpart;     // (ceil(T / kBM), vc) scratch
  float* dxacc;      // (T, d) fp32, null with one chunk
  bf16* dx;
  bf16* dw;
  float* db;
  int* ctr;          // the tile counter: 0 before and after each launch
  int T, V, d, vc;
  int v0, vw;        // this chunk's first vocab row and its rows
  int first, last;   // the first / last chunk
};

// d (m64 x n128 fp32) (+)= A . B for 16 k, both from shared memory through
// their descriptors; TA / TB: A / B MN-major (read transposed). accumulate
// 0 writes d = A . B without reading d.
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[16][4], uint64_t da,
                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The tiles of a launch. (a): 256 tokens x 128 vocab rows of the chunk,
// contraction over d. (b): the dW tiles (256 vocab rows x 128 columns of d,
// contraction over T) and the dx tiles (256 tokens x 128 columns of d,
// contraction over the chunk's vw rows), the kind with the longer
// contraction first.
struct Tile {
  int kind;          // 0 logits, 1 dW, 2 dx
  int r0, c0;        // first row and column of the tile
  int nk;            // slabs of the contraction
};

template <int MODE>
__device__ __forceinline__ int tile_count(const Args& a) {
  const int ntt = (a.T + kBM - 1) / kBM, ndt = (a.d + kBN - 1) / kBN;
  if (MODE == 0) return ntt * ((a.vw + kBN - 1) / kBN);
  return ((a.vw + kBM - 1) / kBM + ntt) * ndt;
}

template <int MODE>
__device__ __forceinline__ Tile tile_of(const Args& a, int u) {
  const int ndt = (a.d + kBN - 1) / kBN;
  if (MODE == 0) {
    const int nvt = (a.vw + kBN - 1) / kBN;
    return Tile{0, (u / nvt) * kBM, (u % nvt) * kBN, (a.d + kBK - 1) / kBK};
  }
  const int nw = (a.vw + kBM - 1) / kBM * ndt;
  const int nx = (a.T + kBM - 1) / kBM * ndt;
  const int nkw = (a.T + kBK - 1) / kBK, nkx = (a.vw + kBK - 1) / kBK;
  const bool wfirst = nkw >= nkx;
  if (wfirst ? u < nw : u >= nx) {
    if (!wfirst) u -= nx;
    return Tile{1, (u / ndt) * kBM, (u % ndt) * kBN, nkw};
  }
  if (wfirst) u -= nw;
  return Tile{2, (u / ndt) * kBM, (u % ndt) * kBN, nkx};
}

// the descriptor of a tile in TMA's 128-byte swizzle: 8-row groups 1024
// bytes apart; `lead` the stride of 64-column panels (MN-major operands)
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lead) {
  return desc<64>(addr, lead);
}

// 32-bit shared-memory accesses (a generic pointer costs two registers)
__device__ __forceinline__ void st_shared(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// the thread's index read anew: what an epilogue derives from it is not
// computed before the contraction and kept (spilled) across it
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One tile's contraction for a consumer warpgroup: acc[m] = rows (2 cw + m)
// * 64 .. + 64 of the tile. A K-major (TA 0): 256 rows of 128 bytes; A
// MN-major (TA 1): 4 panels of 64 rows (k) x 64 columns (m). B K-major (TB
// 0): 128 rows of 128 bytes; B MN-major (TB 1): 2 panels of 64 k rows x 64
// columns.
template <int TA, int TB>
__device__ __forceinline__ void contract(float (&acc)[2][16][4], int nk,
                                         int cw, int lane, uint32_t ring,
                                         uint32_t full, uint32_t empty,
                                         int& it) {
  for (int k = 0; k < nk; ++k, ++it) {
    const int s = it % kNS;
    mbar_wait(full + 8 * s, (it / kNS) & 1);
    const uint32_t sa = ring + s * kStage, sb = sa + kAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const uint64_t db =
          TB ? sdesc(sb + kk * 128, kBox) : sdesc(sb + kk * 2, 16);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t pa = sa + (2 * cw + m) * kBox;
        const uint64_t da =
            TA ? sdesc(pa + kk * 128, kBox) : sdesc(pa + kk * 2, 16);
        mma<TA, TB>(acc[m], da, db, k | kk);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();          // slab k - 1's products have retired
    if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kNS));
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kNS));
}

// (a)'s epilogue: dl of the thread's fragment, stored as bf16; the tile's
// column sums of the unrounded dl into dbpart[row tile][columns]. The rows'
// target, lse and g and the columns' bias come from shared memory (`rows`,
// written before the contraction) at each use: held in registers beside
// the 128 of the accumulator they spilled.
__device__ __forceinline__ void dl_epilogue(const Args& a, const Tile& tl,
                                            float (&acc)[2][16][4],
                                            uint32_t red, uint32_t rows) {
  consumer_sync();                              // rows are written
  const int tid = fresh_tid();
  const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = cw * 128 + warp * 16 + g;      // the thread's first row
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = tl.c0 + 8 * j + 2 * t;        // column in the chunk
    const int v = a.v0 + c;
    float cs[2] = {0.f, 0.f};
    const float2 bp = ld_shared2(rows + 4 * (3 * kBM + 8 * j + 2 * t));
    const float bv[2] = {bp.x, bp.y};
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr + m * 64 + 8 * h, row = tl.r0 + r;
        const float2 lg = ld_shared2(rows + 8 * r);      // (lse, g)
        const int tg = __float_as_int(ld_shared(rows + 4 * (2 * kBM + r)));
        const float ls = lg.x, gg = lg.y;
        float dl[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float p = __expf(acc[m][j][2 * h + b] + bv[b] - ls);
          const float one = v + b == tg ? 1.f : 0.f;
          dl[b] = row < a.T && v + b < a.V ? (p - one) * gg : 0.f;
          cs[b] += dl[b];
        }
        // T * vc < 2^31 (the host checks): a 32-bit offset
        if (row < a.T)
          *reinterpret_cast<uint32_t*>(a.dl + (uint32_t)(row * a.vc + c)) =
              pack(dl[0], dl[1], bf16());
      }
    // over the warp's 8 row groups, then the 8 warps in order through red
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float s = cs[b];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0)
        st_shared(red + 4 * ((cw * 4 + warp) * kBN + 8 * j + 2 * t + b), s);
    }
  }
  consumer_sync();
  const int i = tid;
  if (i < kBN) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += ld_shared(red + 4 * (w * kBN + i));
    a.dbpart[(size_t)(tl.r0 / kBM) * a.vc + tl.c0 + i] = s;
  }
  consumer_sync();            // red is free for the next tile
}

// (b)'s epilogues: dW rows of the chunk (and db), or dx rows
__device__ __forceinline__ void prod_epilogue(const Args& a, const Tile& tl,
                                              float (&acc)[2][16][4], int cw,
                                              int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int rb = tl.r0 + cw * 128 + warp * 16 + g;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rb + m * 64 + 8 * h;
      if (tl.kind == 1 ? row >= a.vw : row >= a.T) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = tl.c0 + 8 * j + 2 * t;   // d % 16 == 0: col + 1 < d
        if (col >= a.d) continue;
        float2 v = make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        if (tl.kind == 1) {
          *reinterpret_cast<uint32_t*>(a.dw + (size_t)(a.v0 + row) * a.d +
                                       col) = pack(v.x, v.y, bf16());
          continue;
        }
        const size_t o = (size_t)row * a.d + col;
        if (!a.first) {
          const float2 p = *reinterpret_cast<const float2*>(a.dxacc + o);
          v.x += p.x;
          v.y += p.y;
        }
        if (a.last)
          *reinterpret_cast<uint32_t*>(a.dx + o) = pack(v.x, v.y, bf16());
        else
          *reinterpret_cast<float2*>(a.dxacc + o) = v;
      }
    }
  if (tl.kind == 1 && tl.c0 == 0) {
    // db of the tile's vocab rows: (a)'s partials in token-tile order
    const int r = tl.r0 + threadIdx.x;
    if (r < a.vw) {
      const int ntt = (a.T + kBM - 1) / kBM;
      float s = 0.f;
      for (int q = 0; q < ntt; ++q) s += a.dbpart[(size_t)q * a.vc + r];
      a.db[a.v0 + r] = s;
    }
  }
}

// The next tile of this block: the counter's count past the first
// gridDim.x tiles (each block's own). A launch makes exactly ntiles
// fetches (its real tiles past the first gridDim.x, then one past the end
// a block), so the fetch that reads ntiles - 1 is the last: it sets the
// counter back to 0 for the next launch.
__device__ __forceinline__ int next_tile(int* ctr, int ntiles) {
  const int v = atomicAdd(ctr, 1);
  if (v == ntiles - 1) atomicExch(ctr, 0);
  return v + gridDim.x;
}

// MODE 0: launch (a), MODE 1: launch (b). Maps: x (T, d), W (V, d) and the
// dl scratch (T, vc), boxes of 64 x 64. Tiles go to the blocks as they
// free up (the first gridDim.x by block index, the rest through a counter),
// in order: (b)'s longer dW tiles first. The producer thread takes each
// tile and passes its index to the consumers through two slots in shared
// memory on their own full / empty barriers; an index past the end stops
// them all. Which block computes a tile changes nothing of its result.
template <int MODE>
__device__ __forceinline__ void xent_bwd_body(const CUtensorMap* mx,
                                              const CUtensorMap* mw,
                                              const CUtensorMap* mdl,
                                              const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t red = ring + kNS * kStage, rows = red + kRed;
  const uint32_t full = rows + kRows;
  const uint32_t empty = full + 8 * kNS;
  const uint32_t tfull = empty + 8 * kNS, tempty = tfull + 16;
  const uint32_t slots = tempty + 16;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(tfull + 8 * s, 1);
      mbar_init(tempty + 8 * s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup through a shuffle: warp-uniform to the compiler, so the
  // role branch serializes no wgmma
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x != kConsumers) return;
    int it = 0, u = blockIdx.x;
    for (int n = 0;; ++n) {
      // hand the tile's index on (a slot's first round passes)
      mbar_wait(tempty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
      st_shared(slots + 4 * (n & 1), __int_as_float(u));
      mbar_arrive(tfull + 8 * (n & 1));
      // the tile count is derived from the arguments where it is used: kept
      // from the kernel's start, it spilled
      if (u >= tile_count<MODE>(a)) break;
      const int next = next_tile(a.ctr, tile_count<MODE>(a));
      const Tile tl = tile_of<MODE>(a, u);
      for (int k = 0; k < tl.nk; ++k, ++it) {
        const int s = it % kNS;
        // a stage's first round passes: parity 1 of a fresh barrier
        mbar_wait(empty + 8 * s, ((it / kNS) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t sa = ring + s * kStage, sb = sa + kAB;
        mbar_expect_tx(bar, kStage);
        const int k0 = k * kBK;
        if (tl.kind == 0) {         // x rows . W_c rows, both K-major
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tma_load_2d(sa + i * kBox, mx, bar, k0, tl.r0 + 64 * i);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            tma_load_2d(sb + i * kBox, mw, bar, k0, a.v0 + tl.c0 + 64 * i);
        } else if (tl.kind == 1) {  // dl_c^T (MN-major) . x rows
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tma_load_2d(sa + i * kBox, mdl, bar, tl.r0 + 64 * i, k0);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            tma_load_2d(sb + i * kBox, mx, bar, tl.c0 + 64 * i, k0);
        } else {                    // dl_c rows (K-major) . W_c rows
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tma_load_2d(sa + i * kBox, mdl, bar, k0, tl.r0 + 64 * i);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            tma_load_2d(sb + i * kBox, mw, bar, tl.c0 + 64 * i, a.v0 + k0);
        }
      }
      u = next;
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  const int cw = wg;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) & 3, 0);
  const int lane = threadIdx.x & 31;
  float acc[2][16][4];
  int it = 0;
  for (int n = 0;; ++n) {
    mbar_wait(tfull + 8 * (n & 1), (n >> 1) & 1);
    const int u = __float_as_int(ld_shared(slots + 4 * (n & 1)));
    __syncwarp();
    if (lane == 0) mbar_arrive(tempty + 8 * (n & 1));
    if (u >= tile_count<MODE>(a)) break;
    const Tile tl = tile_of<MODE>(a, u);
    if (MODE == 0) {
      // the tile's rows' target, lse and g and its columns' bias into
      // shared memory, one row and one column a consumer thread (the last
      // epilogue's closing barrier freed the space). Held in registers
      // across the contraction, they spilled; read from device memory in
      // the epilogue, the bias's latency cost BERT's head 5% of a call.
      const int i = threadIdx.x, row = tl.r0 + i, v = a.v0 + tl.c0 + i;
      const bool in = row < a.T;
      st_shared(rows + 8 * i, in ? a.lse[row] : 0.f);
      st_shared(rows + 8 * i + 4, in ? a.g[row] : 0.f);
      st_shared(rows + 4 * (2 * kBM + i), __int_as_float(in ? a.tgt[row] : -1));
      if (i < kBN)
        st_shared(rows + 4 * (3 * kBM + i),
                  a.bias != nullptr && v < a.V ? __bfloat162float(a.bias[v])
                                               : 0.f);
      contract<0, 0>(acc, tl.nk, cw, lane, ring, full, empty, it);
      // the epilogue's offsets computed anew from the tile's origin (as
      // from the thread's index): values the compiler derived before the
      // contraction and kept across it spilled
      Tile te = tl;
      asm volatile("" : "+r"(te.r0), "+r"(te.c0));
      dl_epilogue(a, te, acc, red, rows);
    } else {
      if (tl.kind == 1)
        contract<1, 1>(acc, tl.nk, cw, lane, ring, full, empty, it);
      else
        contract<0, 1>(acc, tl.nk, cw, lane, ring, full, empty, it);
      prod_epilogue(a, tl, acc, cw, warp, lane);
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    xent_dl_kernel(__grid_constant__ const CUtensorMap mx,
                   __grid_constant__ const CUtensorMap mw,
                   __grid_constant__ const CUtensorMap mdl, const Args a) {
  xent_bwd_body<0>(&mx, &mw, &mdl, a);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    xent_prod_kernel(__grid_constant__ const CUtensorMap mx,
                     __grid_constant__ const CUtensorMap mw,
                     __grid_constant__ const CUtensorMap mdl, const Args a) {
  xent_bwd_body<1>(&mx, &mw, &mdl, a);
}

// a row-major (rows, cols) bf16 matrix as a 2-D tensor map, boxes of 64
// columns x 64 rows in the 128-byte swizzle
bool encode_2d(EncodeTiled fn, CUtensorMap* map, const void* p, int rows,
               int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_all(EncodeTiled fn, CUtensorMap (&maps)[3], const void* x,
                const void* w, const void* dl, int T, int V, int d, int vc) {
  return encode_2d(fn, &maps[0], x, T, d) && encode_2d(fn, &maps[1], w, V, d) &&
         encode_2d(fn, &maps[2], dl, T, vc);
}

}  // namespace

// x (T, d), w (V, d), bias (V,) or null: bf16, 16-byte aligned; tgt (T,)
// int32; lse, g (T,) fp32; dx (T, d), dw (V, d) bf16 out; db (V,) fp32 out
// (always written). Scratch: dl (T, vc) bf16, dbpart (ceil(T / 256), vc)
// fp32, dxacc (T, d) fp32 (unused, may be null, when vc >= V), ctr one
// int32, 0 (every launch leaves it 0). vc: the chunk, a multiple of 256.
extern "C" int dstpu_xent_bwd(const void* x, const void* w, const void* bias,
                              const int* tgt, const float* lse, const float* g,
                              void* dx, void* dw, float* db, void* dl,
                              float* dbpart, float* dxacc, int* ctr, int T,
                              int V, int d, int vc, void* stream) {
  if (T <= 0 || V <= 0 || d <= 0 || d % 16 || vc <= 0 || vc % kBM ||
      (long long)T * vc >= (1ll << 31) || (vc < V && dxacc == nullptr) ||
      ctr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[3];
  if (!encode_all(enc, maps, x, w, dl, T, V, d, vc))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  cudaError_t err = fit_smem<xent_dl_kernel>(kSmem, kBlockThreads, &per_sm);
  if (err == cudaSuccess)
    err = fit_smem<xent_prod_kernel>(kSmem, kBlockThreads, &per_sm);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntt = (T + kBM - 1) / kBM, ndt = (d + kBN - 1) / kBN;
  for (int v0 = 0; v0 < V; v0 += vc) {
    const int vw = V - v0 < vc ? V - v0 : vc;
    const Args a{static_cast<const bf16*>(bias), tgt, lse, g,
                 static_cast<bf16*>(dl), dbpart, dxacc,
                 static_cast<bf16*>(dx), static_cast<bf16*>(dw), db, ctr,
                 T, V, d, vc, v0, vw, v0 == 0, v0 + vc >= V};
    const int t0 = ntt * ((vw + kBN - 1) / kBN);
    const int t1 = ((vw + kBM - 1) / kBM + ntt) * ndt;
    xent_dl_kernel<<<t0 < sms ? t0 : sms, kBlockThreads, kSmem, st>>>(
        maps[0], maps[1], maps[2], a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    xent_prod_kernel<<<t1 < sms ? t1 : sms, kBlockThreads, kSmem, st>>>(
        maps[0], maps[1], maps[2], a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// Dynamic shared memory of both kernels: what chip_smoke.py prints beside
// ptxas's registers.
extern "C" int dstpu_xent_bwd_smem_bytes() { return kSmem; }
