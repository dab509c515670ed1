// Flash attention forward and backward on Hopper (sm_90a), bf16 / fp16
// operands with fp32 accumulation, on tensor cores through mma.sync m16n8k16.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_fwd     <- _fwd_kernel (:43) and, past the TPU's VMEM budget,
//                    _fwd_kernel_streamed (:436);
//   flash_bwd_dq  <- _make_bwd_dq_kernel (:228) / _make_bwd_dq_kernel_streamed
//                    (:533);
//   flash_bwd_dkv <- _make_bwd_dkv_kernel (:285) /
//                    _make_bwd_dkv_kernel_streamed (:581).
// The TPU splits each kernel in two by VMEM size; here one kernel streams K/V
// (or Q/dO) through shared memory tile by tile at any S.
//
// Function (the same rounding points as the Pallas kernels):
//   s = (q . k) in fp32 from storage-dtype operands, times 1/sqrt(hd), plus
//   slope_h * (key - query) for ALiBi; positions that are causal-hidden,
//   padded out by the (B, S) key mask or past S are set to BIG_NEG = -2^30
//   and given probability 0; online softmax in fp32 (m, l, acc); p rounded to
//   v's dtype before p.v; o = acc / max(l, 1e-30) and lse = m + log(max(l,
//   1e-30)), so a fully masked row gives o = 0, never NaN.
//   Backward: p = exp(s - lse) recomputed, dp = dO.v, ds = p (dp - delta) with
//   delta = rowsum(dO o) computed outside in fp32; ds rounded to k's / q's
//   dtype before its products; dq and dk scaled by 1/sqrt(hd) once at the end.
//
// Layout: q, o, dO, dq are (B, S, H, hd); k, v, dk, dv are (B, S, KV, hd),
// all contiguous (the JAX layout: no transposes); lse and delta (B, H, S)
// fp32. GQA maps query head h to KV head h / (H / KV) by index; dk/dv of a
// KV head sum its group's query heads inside one block (no atomics).
//
// Bound (at the slice's shape, B 4, H 25, S 1024, hd 64, causal, bf16):
// the matmul FLOPs at 989 TFLOP/s, 2 products for the forward, 3 for dq and
// 4 for dk/dv, each 2*B*H*S^2*hd halved when causal, against the bytes read
// and written once at 3.35 TB/s; the larger of the two (chip_smoke.py prints
// both for every call it times). At hd 64 the forward is bound by bytes,
// dq and dk/dv by operations.
//
// Design, simple first: one block of 4 warps per (query tile of 64 rows,
// head, batch) for the forward and dq, per (key tile of 64, KV head, batch)
// for dk/dv; each warp owns 16 rows. The block's own tile and each streamed
// 64-row tile are staged in shared memory (rows padded by 16 bytes, so the
// ldmatrix fragment loads are free of bank conflicts); every product is
// mma.sync with the score tile kept in registers, reused as the A operand of
// the next product without a trip through shared memory (the tile products
// live in attention_tiles.cuh, shared with sparse_attention.cu). Causal
// blocks stop at (forward, dq) or start from (dk/dv) the diagonal tile; the
// mask inside the tile does the rest (tiles off the diagonal, inside S and
// unmasked skip the per-element checks), and the ragged tail past S is
// zero-filled and masked. exp is the fast __expf (ex2.approx, ~2 ulp of
// fp32). The streamed tiles are double buffered: cp.async copies the next
// tile while the current one is computed. TMA, warp specialisation and
// wgmma are later work.
//
// C interface (ctypes): each function returns cudaGetLastError() after its
// launch, or cudaErrorInvalidValue for what it does not take (dtype other
// than fp16/bf16, hd not in {16, 32, 64, 128}).

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps, 16 rows each

// rows [r0, r0 + 64) of head h of a contiguous (B, S, NH, HD) tensor into a
// (64, HD + 8) shared tile, asynchronously (cp.async, 16 bytes a thread per
// copy); rows past S are zero-filled. The caller commits the group.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g,
                                          int b, int r0, int S, int NH, int h) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool valid = r0 + r < S;
    const T* src = valid ? g + (((size_t)b * S + r0 + r) * NH + h) * HD + c : g;
    cp_async16(sm + r * (HD + 8) + c, src, valid ? 16 : 0);
  }
}

__device__ __forceinline__ bool key_live(const uint8_t* __restrict__ mask,
                                         int b, int S, int key) {
  return key < S && (mask == nullptr || mask[(size_t)b * S + key] != 0);
}

// ------------------------------------------------------------------ forward
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ slopes, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int KV, int causal,
                     float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + kTile * LD;           // 2 stages of (K, V)
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {qt * kTile + warp * 16 + g, qt * kTile + warp * 16 + g + 8};
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  load_tile<T, HD>(sQ, q, b, qt * kTile, S, H, h);
  load_tile<T, HD>(sKV, k, b, 0, S, KV, kvh);
  load_tile<T, HD>(sKV + kTile * LD, v, b, 0, S, KV, kvh);
  cp_async_commit();
  float m[2] = {kBigNeg, kBigNeg}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = (S + kTile - 1) / kTile;
  const int nend = causal ? min(ntiles, qt + 1) : ntiles;
  for (int jt = 0; jt < nend; ++jt) {
    const int k0 = jt * kTile;
    // the next tile's copies run while this one is computed
    if (jt + 1 < nend) {
      T* next = sKV + ((jt + 1) & 1) * 2 * kTile * LD;
      load_tile<T, HD>(next, k, b, k0 + kTile, S, KV, kvh);
      load_tile<T, HD>(next + kTile * LD, v, b, k0 + kTile, S, KV, kvh);
      cp_async_commit();
      cp_async_wait_sync<1>();
    } else {
      cp_async_wait_sync<0>();
    }
    const T* sK = sKV + (jt & 1) * 2 * kTile * LD;
    const T* sV = sK + kTile * LD;
    float s[8][4];
    gemm_rows<T, HD>(s, sQ + warp * 16 * LD, sK, lane);
    // a tile below the diagonal, inside S and unmasked keeps every element
    const bool interior = mask == nullptr && k0 + kTile <= S &&
                          (!causal || jt < qt);
    uint32_t keep = ~0u;                   // bit 4j + e
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1), r = row[e >> 1];
        float x = s[j][e] * scale;
        if (slopes != nullptr) x += slope * (float)(key - r);
        if (!interior) {
          const bool live = key_live(mask, b, S, key) &&
                            (!causal || key <= r);
          x = live ? x : kBigNeg;
          keep &= ~((uint32_t)!live << (4 * j + e));
        }
        s[j][e] = x;
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
                            ? __expf(s[j][e] - mx[e >> 1]) : 0.f;
        s[j][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(psum[r]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    gemm_p<T, HD>(acc, s, sV, lane);
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float ls = fmaxf(l[r], 1e-30f), inv = 1.f / ls;
    T* dst = o + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv, T());
    if (t == 0) lse[((size_t)b * H + h) * S + row[r]] = m[r] + logf(ls);
  }
}

// ------------------------------------------------------------------ dq
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ slopes, T* __restrict__ dq,
                        int S, int H, int KV, int causal, float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kTile * LD;
  T* sKV = sDO + kTile * LD;          // 2 stages of (K, V)
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {qt * kTile + warp * 16 + g, qt * kTile + warp * 16 + g + 8};
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = ((size_t)b * H + h) * S + row[r];
    lse_r[r] = row[r] < S ? lse[i] : 0.f;
    delta_r[r] = row[r] < S ? delta[i] : 0.f;
  }
  load_tile<T, HD>(sQ, q, b, qt * kTile, S, H, h);
  load_tile<T, HD>(sDO, dout, b, qt * kTile, S, H, h);
  load_tile<T, HD>(sKV, k, b, 0, S, KV, kvh);
  load_tile<T, HD>(sKV + kTile * LD, v, b, 0, S, KV, kvh);
  cp_async_commit();
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = (S + kTile - 1) / kTile;
  const int nend = causal ? min(ntiles, qt + 1) : ntiles;
  for (int jt = 0; jt < nend; ++jt) {
    const int k0 = jt * kTile;
    if (jt + 1 < nend) {
      T* next = sKV + ((jt + 1) & 1) * 2 * kTile * LD;
      load_tile<T, HD>(next, k, b, k0 + kTile, S, KV, kvh);
      load_tile<T, HD>(next + kTile * LD, v, b, k0 + kTile, S, KV, kvh);
      cp_async_commit();
      cp_async_wait_sync<1>();
    } else {
      cp_async_wait_sync<0>();
    }
    const T* sK = sKV + (jt & 1) * 2 * kTile * LD;
    const T* sV = sK + kTile * LD;
    float s[8][4], dp[8][4];
    gemm_rows<T, HD>(s, sQ + warp * 16 * LD, sK, lane);
    gemm_rows<T, HD>(dp, sDO + warp * 16 * LD, sV, lane);
    const bool interior = mask == nullptr && k0 + kTile <= S &&
                          (qt + 1) * kTile <= S && (!causal || jt < qt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1), r = row[e >> 1];
        float x = s[j][e] * scale;
        if (slopes != nullptr) x += slope * (float)(key - r);
        const bool live = interior || (r < S && key_live(mask, b, S, key) &&
                                       (!causal || key <= r));
        const float p = live ? __expf(x - lse_r[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);     // ds
      }
    gemm_p<T, HD>(acc, s, sK, lane);
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    T* dst = dq + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale, T());
  }
}

// ------------------------------------------------------------------ dk, dv
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ slopes, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int KV, int causal,
                         float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * LD;
  T* sQD = sV + kTile * LD;           // 2 stages of (Q, dO)
  float* sRows = reinterpret_cast<float*>(sQD + 4 * kTile * LD);  // 2 x (lse, delta)
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's two keys (the rows of its C fragments)
  const int key[2] = {kt * kTile + warp * 16 + g, kt * kTile + warp * 16 + g + 8};
  const bool live_key[2] = {key_live(mask, b, S, key[0]),
                            key_live(mask, b, S, key[1])};
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // steps run over (query head of the group, query tile) pairs; causal
  // blocks start at the diagonal tile
  const int nq = (S + kTile - 1) / kTile;
  const int it0 = causal ? kt : 0, per = nq - it0, nsteps = G * per;
  // copies of step i's Q, dO (async) and lse, delta rows into stage i & 1
  auto prefetch = [&](int i) {
    const int h = kvh * G + i / per, q0 = (it0 + i % per) * kTile;
    T* st = sQD + (i & 1) * 2 * kTile * LD;
    load_tile<T, HD>(st, q, b, q0, S, H, h);
    load_tile<T, HD>(st + kTile * LD, dout, b, q0, S, H, h);
    float* rows = sRows + (i & 1) * 2 * kTile;
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const size_t idx = ((size_t)b * H + h) * S + q0 + r;
      rows[r] = q0 + r < S ? lse[idx] : 0.f;
      rows[kTile + r] = q0 + r < S ? delta[idx] : 0.f;
    }
  };
  load_tile<T, HD>(sK, k, b, kt * kTile, S, KV, kvh);
  load_tile<T, HD>(sV, v, b, kt * kTile, S, KV, kvh);
  prefetch(0);
  cp_async_commit();
  for (int i = 0; i < nsteps; ++i) {
    const int h = kvh * G + i / per, it = it0 + i % per, q0 = it * kTile;
    const float slope = slopes != nullptr ? slopes[h] : 0.f;
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
      float s[8][4], dp[8][4];   // transposed tiles: (key, query)
      gemm_rows<T, HD>(s, sK + warp * 16 * LD, sQ, lane);
      gemm_rows<T, HD>(dp, sV + warp * 16 * LD, sDO, lane);
      const bool interior = mask == nullptr && q0 + kTile <= S &&
                            (kt + 1) * kTile <= S && (!causal || it > kt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1), query = q0 + qi;
          const int kk = key[e >> 1];
          float x = s[j][e] * scale;
          if (slopes != nullptr) x += slope * (float)(kk - query);
          const bool live = interior || (live_key[e >> 1] && query < S &&
                                         (!causal || kk <= query));
          const float p = live ? __expf(x - sLse[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sDelta[qi]);       // ds
        }
      gemm_p<T, HD>(dva, s, sDO, lane);
      gemm_p<T, HD>(dka, dp, sQ, lane);
    }
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    const size_t off = (((size_t)b * S + key[r]) * KV + kvh) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale, T());
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack(dva[n][2 * r], dva[n][2 * r + 1], T());
    }
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  const uint8_t* mask;
  const float* slopes;
  void *o, *dk, *dv;
  float* lse_out;
  int B, S, H, KV, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch(int which, const Args& a) {
  constexpr int LD = HD + 8;
  const dim3 block(kThreads);
  const int tiles = (a.S + kTile - 1) / kTile;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == 0) {
    const size_t smem = 5 * kTile * LD * sizeof(T);
    auto fn = flash_fwd_kernel<T, HD>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<dim3(tiles, a.H, a.B), block, smem, a.stream>>>(
        q, k, v, a.mask, a.slopes, static_cast<T*>(a.o), a.lse_out, a.S, a.H,
        a.KV, a.causal, a.scale);
  } else if (which == 1) {
    const size_t smem = 6 * kTile * LD * sizeof(T);
    auto fn = flash_bwd_dq_kernel<T, HD>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<dim3(tiles, a.H, a.B), block, smem, a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, a.mask, a.slopes,
        static_cast<T*>(a.o), a.S, a.H, a.KV, a.causal, a.scale);
  } else {
    const size_t smem = 6 * kTile * LD * sizeof(T) + 4 * kTile * sizeof(float);
    auto fn = flash_bwd_dkv_kernel<T, HD>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<dim3(tiles, a.KV, a.B), block, smem, a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, a.mask, a.slopes,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.H, a.KV, a.causal,
        a.scale);
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
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 ||
      a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return static_cast<int>(dispatch_hd<__half>(which, hd, a));
  if (dtype == 2)
    return static_cast<int>(dispatch_hd<__nv_bfloat16>(which, hd, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 1 fp16, 2 bf16. mask: (B, S) uint8 or null; slopes: (H,) fp32 or
// null; lse: (B, H, S) fp32 out.
extern "C" int dstpu_flash_fwd(const void* q, const void* k, const void* v,
                               const uint8_t* mask, const float* slopes,
                               void* o, float* lse, int B, int S, int H,
                               int KV, int hd, int causal, int dtype,
                               float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, mask, slopes, o, nullptr,
         nullptr, lse, B, S, H, KV, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, hd, dtype, a);
}

// dout, dq: (B, S, H, hd); lse, delta: (B, H, S) fp32.
extern "C" int dstpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const uint8_t* mask,
                                  const float* slopes, void* dq, int B, int S,
                                  int H, int KV, int hd, int causal, int dtype,
                                  float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, mask, slopes, dq, nullptr, nullptr,
         nullptr, B, S, H, KV, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, hd, dtype, a);
}

// dk, dv: (B, S, KV, hd), each KV head the sum over its group of query heads.
extern "C" int dstpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, const uint8_t* mask,
                                   const float* slopes, void* dk, void* dv,
                                   int B, int S, int H, int KV, int hd,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  Args a{q, k, v, dout, lse, delta, mask, slopes, nullptr, dk, dv, nullptr,
         B, S, H, KV, causal, scale, static_cast<cudaStream_t>(stream)};
  return run(2, hd, dtype, a);
}
