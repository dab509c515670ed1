// Block-sparse attention forward and backward on Hopper (sm_90a), bf16 /
// fp16 operands with fp32 accumulation, on tensor cores through mma.sync
// m16n8k16 (the tile products of attention_tiles.cuh, shared with the flash
// kernels).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/sparse_attention.py:
//   sparse_fwd     <- _fwd_kernel (:184);
//   sparse_bwd_dq  <- _dq_kernel (:223);
//   sparse_bwd_dkv <- _dkv_kernel (:252).
// The TPU rides its CSR lists in as scalar-prefetch operands and loops a
// grid step over them; here every block reads its own list entries into
// shared memory and walks them.
//
// Function (the same rounding points as the Pallas kernels): the sequence is
// cut into blocks of `block` positions; query block iq attends key block jk
// where the layout keeps (iq, jk). k_idx (nq, A) / k_n (nq,) list the kept
// k-blocks of each q-block in ascending order, q_idx / q_n the transpose
// (int32; entries past k_n are padding and are never read). s = (q . k) in
// fp32 from storage-dtype operands, times 1/sqrt(hd); when causal, keys past
// the query get BIG_NEG = -2^30 and probability 0 (the causal cut has
// already dropped the k-blocks above the diagonal, so only the diagonal
// block masks); online softmax in fp32; p rounded to v's dtype before p.v;
// o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). Backward: p =
// exp(s - lse), ds = p (dp - delta) with delta = rowsum(dO o) computed
// outside in fp32; ds rounded to k's / q's dtype before its products, p to
// dO's before p^T dO; dq and dk scaled by 1/sqrt(hd) once at the end.
//
// Layout: q, o, dO, dq are (B, S, H, hd); k, v, dk, dv are (B, S, KV, hd),
// contiguous (the JAX layout); lse and delta (B, H, S) fp32. GQA maps query
// head h to KV head h / (H / KV) by index; dk/dv of a KV head sum its
// group's query heads inside one block. No atomics: results repeat bit for
// bit.
//
// Bound (at the slice's shape, B 1, H 25, S 8192, hd 64, the Fixed layout
// with block 64, causal, bf16): the kept (q, k) elements times 2 hd flop for
// each of 2 (forward), 3 (dq) or 4 (dk/dv) products at 989 TFLOP/s, against
// each operand read and each output written once at 3.35 TB/s; the larger of
// the two (chip_smoke.py phase 5c prints both). 45.5% of the causal elements
// are kept there, so all three are bound by operations.
//
// Design, simple first (the flash kernels' structure over a list):
// - A block owns one q-block (forward, dq) or one k-block (dk/dv), block/16
//   warps of 16 rows each: 1, 2, 4 or 8 warps for blocks 16, 32, 64, 128.
//   One block never spans several layout blocks, so it walks one list and
//   needs no per-element layout mask; the SM packs several small blocks.
// - The other operand streams through shared memory in gathered tiles of 64
//   rows: row f of the block's walk is position idx[f / block] * block +
//   f % block, so a tile holds 64 / block list entries (block <= 64) or half
//   of one (block 128), and the tile products are the flash kernels' 64-row
//   ones at every block size. Rows past the list's end are zero-filled
//   copies and masked. Only tiles that touch the diagonal entry (the last of
//   a causal k-list, the first of a causal q-list) or the list's end check
//   elements; the others keep every element. cp.async double buffers the
//   tiles.
// - Load imbalance: under the Fixed layout a global row keeps every block
//   below it and a local row 1-4, so list lengths differ by up to 100x. The
//   grid runs (head, batch, rank) with the rank as the slowest index, and
//   the wrapper passes the blocks in order of decreasing list length: the
//   widest rows start first and the short ones fill in behind them (longest
//   processing time first). On an H100 at the slice's shape (chip_smoke.py
//   phase 5c) that made the forward and dq 27% and 23% faster than natural
//   block order; dk/dv did not change, since the Fixed layout's widest
//   columns are its first ones and natural order already starts them first.
// TMA, wgmma and warp specialisation are later work.
//
// C interface (ctypes): each function returns cudaGetLastError() after its
// launch, or cudaErrorInvalidValue for what it does not take (dtype other
// than fp16/bf16, hd not in {16, 32, 64, 128}, block not in {16, 32, 64,
// 128}, S not a multiple of block).

#include "attention_tiles.cuh"

namespace {

constexpr int kMaxThreads = 256;   // block 128: 8 warps

// position of row f of a walk over `n` list entries (sIdx, in shared
// memory), or -1 past the list's end; lgb = log2(block)
__device__ __forceinline__ int walk_pos(const int* sIdx, int n, int lgb,
                                        int f) {
  const int e = f >> lgb;
  return e < n ? (sIdx[e] << lgb) + (f & ((1 << lgb) - 1)) : -1;
}

// rows [r0, r0 + rows) of head h of a contiguous (B, S, NH, HD) tensor into
// a (rows, HD + 8) shared tile (cp.async; the caller commits the group)
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* sm, const T* __restrict__ g,
                                          int b, int r0, int rows, int S,
                                          int NH, int h) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    cp_async16(sm + r * (HD + 8) + c,
               g + (((size_t)b * S + r0 + r) * NH + h) * HD + c, 16);
  }
}

// rows [f0, f0 + 64) of the walk over sIdx of head h into a (64, HD + 8)
// shared tile; rows past the list's end are zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_walk(T* sm, const T* __restrict__ g,
                                          int b, int S, int NH, int h,
                                          const int* sIdx, int n, int lgb,
                                          int f0) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int pos = walk_pos(sIdx, n, lgb, f0 + r);
    const T* src = pos >= 0 ? g + (((size_t)b * S + pos) * NH + h) * HD + c : g;
    cp_async16(sm + r * (HD + 8) + c, src, pos >= 0 ? 16 : 0);
  }
}

// this block's list (row `which` of a padded (n_rows, A) int32 array) into
// shared memory; returns its length
__device__ __forceinline__ int load_list(int* sIdx, const int* __restrict__ idx,
                                         const int* __restrict__ cnt, int which,
                                         int A) {
  const int n = cnt[which];
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    sIdx[e] = idx[(size_t)which * A + e];
  __syncthreads();
  return n;
}

// ------------------------------------------------------------------ forward
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
    sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ k_idx,
                      const int* __restrict__ k_n,
                      const int* __restrict__ order, int A, int S, int H,
                      int KV, int lgb, int causal, float scale) {
  constexpr int LD = HD + 8;
  const int blk = 1 << lgb;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + blk * LD;             // 2 stages of gathered (K, V) tiles
  int* sIdx = reinterpret_cast<int*>(sKV + 4 * kTile * LD);
  const int h = blockIdx.x, b = blockIdx.y, iq = order[blockIdx.z];
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * blk;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int n = load_list(sIdx, k_idx, k_n, iq, A);

  load_rows<T, HD>(sQ, q, b, q0, blk, S, H, h);
  load_walk<T, HD>(sKV, k, b, S, KV, kvh, sIdx, n, lgb, 0);
  load_walk<T, HD>(sKV + kTile * LD, v, b, S, KV, kvh, sIdx, n, lgb, 0);
  cp_async_commit();
  float m[2] = {kBigNeg, kBigNeg}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  const int nsteps = (n * blk + kTile - 1) / kTile;
  // tiles from here on touch the diagonal entry (causal) or the list's end
  const int edge = causal ? (n - 1) * blk : n * blk;
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      T* next = sKV + ((s + 1) & 1) * 2 * kTile * LD;
      load_walk<T, HD>(next, k, b, S, KV, kvh, sIdx, n, lgb, (s + 1) * kTile);
      load_walk<T, HD>(next + kTile * LD, v, b, S, KV, kvh, sIdx, n, lgb,
                       (s + 1) * kTile);
      cp_async_commit();
      cp_async_wait_sync<1>();
    } else {
      cp_async_wait_sync<0>();
    }
    const T* sK = sKV + (s & 1) * 2 * kTile * LD;
    const T* sV = sK + kTile * LD;
    float sc[8][4];
    gemm_rows<T, HD>(sc, sQ + warp * 16 * LD, sK, lane);
    const bool interior = (s + 1) * kTile <= edge;
    uint32_t keep = ~0u;                   // bit 4j + e
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (!interior) {
          const int key = walk_pos(sIdx, n, lgb,
                                   s * kTile + j * 8 + 2 * t + (e & 1));
          const bool live = key >= 0 && (!causal || key <= row[e >> 1]);
          x = live ? x : kBigNeg;
          keep &= ~((uint32_t)!live << (4 * j + e));
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (keep >> (4 * j + e)) & 1u
                            ? __expf(sc[j][e] - mx[e >> 1]) : 0.f;
        sc[j][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(psum[r]);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr[e >> 1];
    gemm_p<T, HD>(acc, sc, sV, lane);
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = fmaxf(l[r], 1e-30f), inv = 1.f / ls;
    T* dst = o + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + c * 8) =
          pack(acc[c][2 * r] * inv, acc[c][2 * r + 1] * inv, T());
    if (t == 0) lse[((size_t)b * H + h) * S + row[r]] = m[r] + logf(ls);
  }
}

// ------------------------------------------------------------------ dq
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
    sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         const int* __restrict__ k_idx,
                         const int* __restrict__ k_n,
                         const int* __restrict__ order, int A, int S, int H,
                         int KV, int lgb, int causal, float scale) {
  constexpr int LD = HD + 8;
  const int blk = 1 << lgb;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + blk * LD;
  T* sKV = sDO + blk * LD;            // 2 stages of gathered (K, V) tiles
  int* sIdx = reinterpret_cast<int*>(sKV + 4 * kTile * LD);
  const int h = blockIdx.x, b = blockIdx.y, iq = order[blockIdx.z];
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * blk;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = ((size_t)b * H + h) * S + row[r];
    lse_r[r] = lse[i];
    delta_r[r] = delta[i];
  }
  const int n = load_list(sIdx, k_idx, k_n, iq, A);

  load_rows<T, HD>(sQ, q, b, q0, blk, S, H, h);
  load_rows<T, HD>(sDO, dout, b, q0, blk, S, H, h);
  load_walk<T, HD>(sKV, k, b, S, KV, kvh, sIdx, n, lgb, 0);
  load_walk<T, HD>(sKV + kTile * LD, v, b, S, KV, kvh, sIdx, n, lgb, 0);
  cp_async_commit();
  float acc[HD / 8][4];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  const int nsteps = (n * blk + kTile - 1) / kTile;
  const int edge = causal ? (n - 1) * blk : n * blk;
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      T* next = sKV + ((s + 1) & 1) * 2 * kTile * LD;
      load_walk<T, HD>(next, k, b, S, KV, kvh, sIdx, n, lgb, (s + 1) * kTile);
      load_walk<T, HD>(next + kTile * LD, v, b, S, KV, kvh, sIdx, n, lgb,
                       (s + 1) * kTile);
      cp_async_commit();
      cp_async_wait_sync<1>();
    } else {
      cp_async_wait_sync<0>();
    }
    const T* sK = sKV + (s & 1) * 2 * kTile * LD;
    const T* sV = sK + kTile * LD;
    float sc[8][4], dp[8][4];
    gemm_rows<T, HD>(sc, sQ + warp * 16 * LD, sK, lane);
    gemm_rows<T, HD>(dp, sDO + warp * 16 * LD, sV, lane);
    const bool interior = (s + 1) * kTile <= edge;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool live = true;
        if (!interior) {
          const int key = walk_pos(sIdx, n, lgb,
                                   s * kTile + j * 8 + 2 * t + (e & 1));
          live = key >= 0 && (!causal || key <= row[e >> 1]);
        }
        const float p = live ? __expf(sc[j][e] * scale - lse_r[e >> 1]) : 0.f;
        sc[j][e] = p * (dp[j][e] - delta_r[e >> 1]);      // ds
      }
    gemm_p<T, HD>(acc, sc, sK, lane);
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* dst = dq + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + c * 8) =
          pack(acc[c][2 * r] * scale, acc[c][2 * r + 1] * scale, T());
  }
}

// ------------------------------------------------------------------ dk, dv
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
    sparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, const int* __restrict__ q_idx,
                          const int* __restrict__ q_n,
                          const int* __restrict__ order, int A, int S, int H,
                          int KV, int lgb, int causal, float scale) {
  constexpr int LD = HD + 8;
  const int blk = 1 << lgb;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + blk * LD;
  T* sQD = sV + blk * LD;             // 2 stages of gathered (Q, dO) tiles
  float* sRows = reinterpret_cast<float*>(sQD + 4 * kTile * LD);  // 2 x (lse, delta)
  int* sIdx = reinterpret_cast<int*>(sRows + 4 * kTile);
  const int kvh = blockIdx.x, b = blockIdx.y, jk = order[blockIdx.z];
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = jk * blk;
  // this thread's two keys (the rows of its C fragments)
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;
  const int n = load_list(sIdx, q_idx, q_n, jk, A);

  // steps run over (query head of the group, tile of the walk) pairs
  const int per = (n * blk + kTile - 1) / kTile, nsteps = G * per;
  // copies of step i's gathered Q, dO (async) and lse, delta rows into
  // stage i & 1
  auto prefetch = [&](int i) {
    const int h = kvh * G + i / per, f0 = (i % per) * kTile;
    T* st = sQD + (i & 1) * 2 * kTile * LD;
    load_walk<T, HD>(st, q, b, S, H, h, sIdx, n, lgb, f0);
    load_walk<T, HD>(st + kTile * LD, dout, b, S, H, h, sIdx, n, lgb, f0);
    float* rows = sRows + (i & 1) * 2 * kTile;
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      const int pos = walk_pos(sIdx, n, lgb, f0 + r);
      const size_t idx = ((size_t)b * H + h) * S + pos;
      rows[r] = pos >= 0 ? lse[idx] : 0.f;
      rows[kTile + r] = pos >= 0 ? delta[idx] : 0.f;
    }
  };
  // a k-block that no q-block keeps (q_n 0) takes no step: dk = dv = 0
  if (nsteps > 0) {
    load_rows<T, HD>(sK, k, b, k0, blk, S, KV, kvh);
    load_rows<T, HD>(sV, v, b, k0, blk, S, KV, kvh);
    prefetch(0);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % per;
    if (i + 1 < nsteps) {
      prefetch(i + 1);
      cp_async_commit();
      cp_async_wait_sync<1>();
    } else {
      cp_async_wait_sync<0>();
    }
    const T* sQ = sQD + (i & 1) * 2 * kTile * LD;
    const T* sDO = sQ + kTile * LD;
    const float* sLse = sRows + (i & 1) * 2 * kTile;
    const float* sDelta = sLse + kTile;
    {
      float sc[8][4], dp[8][4];  // transposed tiles: (key, query)
      gemm_rows<T, HD>(sc, sK + warp * 16 * LD, sQ, lane);
      gemm_rows<T, HD>(dp, sV + warp * 16 * LD, sDO, lane);
      // the diagonal entry is the first of a causal q-list
      const bool interior = (!causal || s * kTile >= blk) &&
                            (s + 1) * kTile <= n * blk;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);
          bool live = true;
          if (!interior) {
            const int query = walk_pos(sIdx, n, lgb, s * kTile + qi);
            live = query >= 0 && (!causal || key[e >> 1] <= query);
          }
          const float p = live ? __expf(sc[j][e] * scale - sLse[qi]) : 0.f;
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sDelta[qi]);       // ds
        }
      gemm_p<T, HD>(dva, sc, sDO, lane);
      gemm_p<T, HD>(dka, dp, sQ, lane);
    }
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = (((size_t)b * S + key[r]) * KV + kvh) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dk + off + c * 8) =
          pack(dka[c][2 * r] * scale, dka[c][2 * r + 1] * scale, T());
      *reinterpret_cast<uint32_t*>(dv + off + c * 8) =
          pack(dva[c][2 * r], dva[c][2 * r + 1], T());
    }
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dk, *dv;
  float* lse_out;
  const int *idx, *cnt, *order;
  int A, B, S, H, KV, block, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch(int which, const Args& a) {
  constexpr int LD = HD + 8;
  const int lgb = __builtin_ctz(a.block);
  const dim3 threads(2 * a.block);     // block / 16 warps
  const int nblocks = a.S / a.block;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const size_t list = (size_t)a.A * sizeof(int);
  cudaError_t err;
  if (which == 0) {
    const size_t smem = (a.block + 4 * kTile) * LD * sizeof(T) + list;
    auto fn = sparse_fwd_kernel<T, HD>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<dim3(a.H, a.B, nblocks), threads, smem, a.stream>>>(
        q, k, v, static_cast<T*>(a.o), a.lse_out, a.idx, a.cnt, a.order, a.A,
        a.S, a.H, a.KV, lgb, a.causal, a.scale);
  } else if (which == 1) {
    const size_t smem = (2 * a.block + 4 * kTile) * LD * sizeof(T) + list;
    auto fn = sparse_bwd_dq_kernel<T, HD>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<dim3(a.H, a.B, nblocks), threads, smem, a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.o), a.idx, a.cnt,
        a.order, a.A, a.S, a.H, a.KV, lgb, a.causal, a.scale);
  } else {
    const size_t smem = (2 * a.block + 4 * kTile) * LD * sizeof(T) +
                        4 * kTile * sizeof(float) + list;
    auto fn = sparse_bwd_dkv_kernel<T, HD>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<dim3(a.KV, a.B, nblocks), threads, smem, a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.idx, a.cnt, a.order, a.A, a.S, a.H, a.KV,
        lgb, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int which, int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, int hd, int dtype, const Args& a) {
  const bool block_ok = a.block == 16 || a.block == 32 || a.block == 64 ||
                        a.block == 128;
  if (!block_ok || a.B <= 0 || a.S <= 0 || a.S % a.block != 0 || a.H <= 0 ||
      a.KV <= 0 || a.H % a.KV != 0 || a.A <= 0 || a.B > 65535 ||
      a.S / a.block > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return static_cast<int>(dispatch_hd<__half>(which, hd, a));
  if (dtype == 2)
    return static_cast<int>(dispatch_hd<__nv_bfloat16>(which, hd, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 1 fp16, 2 bf16. k_idx (nq, A) / k_n (nq,) int32: the kept k-blocks
// of each q-block; order (nq,) int32: the q-blocks in launch order.
// lse: (B, H, S) fp32 out.
extern "C" int dstpu_sparse_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, const int* k_idx,
                                const int* k_n, const int* order, int A, int B,
                                int S, int H, int KV, int hd, int block,
                                int causal, int dtype, float scale,
                                void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, nullptr, lse,
         k_idx, k_n, order, A, B, S, H, KV, block, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, hd, dtype, a);
}

// dout, dq: (B, S, H, hd); lse, delta: (B, H, S) fp32; lists as above.
extern "C" int dstpu_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq,
                                   const int* k_idx, const int* k_n,
                                   const int* order, int A, int B, int S,
                                   int H, int KV, int hd, int block,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr,
         k_idx, k_n, order, A, B, S, H, KV, block, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, hd, dtype, a);
}

// dk, dv: (B, S, KV, hd), each KV head the sum over its group of query
// heads; q_idx (nk, A) / q_n (nk,): the q-blocks that keep each k-block;
// order (nk,): the k-blocks in launch order.
extern "C" int dstpu_sparse_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, const int* q_idx,
                                    const int* q_n, const int* order, int A,
                                    int B, int S, int H, int KV, int hd,
                                    int block, int causal, int dtype,
                                    float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, nullptr,
         q_idx, q_n, order, A, B, S, H, KV, block, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(2, hd, dtype, a);
}
