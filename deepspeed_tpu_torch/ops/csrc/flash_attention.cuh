// Flash attention on Hopper (sm_90a) for fp32 and for 16-bit hd 16, forward
// and backward: bf16 / fp16 operands on tensor cores through mma.sync
// m16n8k16 with fp32 accumulation, fp32 operands through 3xTF32 mma.sync
// m16n8k8; an optional additive score bias, and its gradient. For bf16 /
// fp16 at hd 32-128 the forward is flash_fwd_sm90.cu's and the backward
// pair flash_bwd_sm90.cuh's (built by flash_bwd_dq_sm90.cu and
// flash_bwd_dkv_sm90.cu: wgmma, TMA, warp specialisation); for fp32 the
// forward at hd 32-128 is flash_fwd_f32_sm90.cu's and the backward pair at
// hd 32 and 64 flash_bwd_f32_sm90.cuh's (3xTF32 on wgmma);
// ops/flash_attention.py routes each launch by (kernel, dtype, hd) through
// fixed tables.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py, for
// fp32 and 16-bit hd 16:
//   flash_fwd     <- _fwd_kernel (:43) and, past the TPU's VMEM budget,
//                    _fwd_kernel_streamed (:436);
//   flash_bwd_dq  <- _make_bwd_dq_kernel (:228) / _make_bwd_dq_kernel_streamed
//                    (:533), dbias included;
//   flash_bwd_dkv <- _make_bwd_dkv_kernel (:285) /
//                    _make_bwd_dkv_kernel_streamed (:581).
// The TPU splits each kernel in two by VMEM size; here one kernel streams K/V
// (or Q/dO) through shared memory tile by tile at any S.
//
// Function (the same rounding points as the Pallas kernels):
//   s = (q . k) in fp32 from storage-dtype operands, times 1/sqrt(hd), plus
//   the bias upcast to fp32, plus slope_h * (key - query) for ALiBi (the
//   order of _masked_scores :114); positions that are causal-hidden, padded
//   out by the (B, S) key mask or past S are set to BIG_NEG = -2^30 and given
//   probability 0; online softmax in fp32 (m, l, acc); p rounded to v's
//   dtype before p.v; o = acc / max(l, 1e-30) and lse = m + log(max(l,
//   1e-30)), so a fully masked row gives o = 0, never NaN.
//   Backward: p = exp(s - lse) recomputed, dp = dO.v, ds = p (dp - delta) with
//   delta = rowsum(dO o) computed outside in fp32; ds rounded to k's / q's
//   dtype before its products; dq and dk scaled by 1/sqrt(hd) once at the end.
//   dbias = ds rounded to the bias's dtype (JAX :270).
//
// Layout: q, o, dO, dq are (B, S, H, hd); k, v, dk, dv are (B, S, KV, hd),
// all contiguous (the JAX layout: no transposes); lse and delta (B, H, S)
// fp32. GQA maps query head h to KV head h / (H / KV) by index; dk/dv of a
// KV head sum its group's query heads inside one block (no atomics).
// The bias is any (B|1, H|1, S, S) tensor whose last two dims are
// contiguous, in fp32, bf16 or fp16 whatever q's dtype: element (b, h, r, c)
// lies at b * sb + h * sh + r * S + c, with stride 0 on a broadcast dim, so
// an (S, S) or (H, S, S) bias is never materialized. For each streamed
// tile a warp copies the bias slice of its own score fragments, upcast to
// fp32, into its (16, 64) scratch in shared memory (coalesced reads of the
// JAX kernel's (block, S) row slices for the forward and dq, of the (S,
// block) column slices, transposed, for dk/dv); the dtype is dispatched
// once per copy, outside the unrolled element loops (a switch on it for
// every element took ptxas ~360 s more). dbias is a full contiguous (B, H,
// S, S) tensor in the bias's dtype, written by the dq kernel through the
// same scratch: a block owns its 64 query rows of one (b, h), so every
// element has one writer and no atomics; the key tiles a causal block
// skips are written as zeros (JAX :245-248), and nothing is written past
// S. The wrapper sums dbias over a broadcast dim.
//
// Bound (at the slice's shape, B 4, H 25, S 1024, hd 64, causal, bf16):
// the matmul FLOPs at 989 TFLOP/s, 2 products for the forward, 3 for dq and
// 4 for dk/dv, each 2*B*H*S^2*hd halved when causal, against the bytes read
// and written once at 3.35 TB/s (the bias as stored, dbias as written); the
// larger of the two (chip_smoke.py prints both for every call it times). At
// hd 64 the forward is bound by bytes, dq and dk/dv by operations; a full
// (B, H, S, S) bias at hd 32 makes all three bound by bytes.
//
// Design, simple first (the 16-bit kernels at hd 32-128 have since moved to
// flash_fwd_sm90.cu and flash_bwd_sm90.cuh, which take wgmma, TMA and warp
// specialisation): one
// block of 4 warps per (query tile of 64 rows, head, batch) for the forward
// and dq, per (key tile of 64, KV head, batch) for dk/dv; each warp owns 16
// rows. The block's own tile and each streamed 64-row tile are staged in
// shared memory (rows padded by 16 bytes, so the fragment loads are free of
// bank conflicts); every product is mma.sync
// with the score tile kept in registers, reused as the A operand of the
// next product without a trip through shared memory (the 16-bit tile
// products live in attention_tiles.cuh, shared with sparse_attention.cu).
// fp32 operands take the same tiles at twice the bytes, plus the (16, 64)
// fp32 scratch per warp (2 stages still fit at hd 128: 216 KiB for dk/dv);
// their products split each operand into a high and a low tf32 part and
// sum three tf32 products (hi.hi + hi.lo + lo.hi), which keeps about
// fp32's accuracy where one tf32 product keeps ~1e-3; sums across key
// tiles are fp32 adds outside the tensor cores.
// Causal blocks stop at (forward, dq) or start from (dk/dv) the diagonal
// tile; the mask inside the tile does the rest (tiles off the diagonal,
// inside S and unmasked skip the per-element checks), and the ragged tail
// past S is zero-filled and masked. exp is the fast __expf (ex2.approx, ~2
// ulp of fp32). The streamed tiles are double buffered: cp.async copies the
// next tile while the current one is computed. The bias is a template
// flag, so the kernels without it keep their code. The fp32 backward at hd
// 16 and 128 and hd 16 still wait for the wgmma redesign (ROADMAP.md queue
// 2).
//
// Two sources include this header, so that nvcc builds them side by side:
// flash_attention.cu instantiates the bf16 / fp16 kernels at hd 16 (12:
// forward, dq and dk/dv, with and without the bias) and
// flash_attention_f32.cu the fp32 ones (10: the forward at hd 16, dq and
// dk/dv at hd 16 and 128); each becomes its own library with the C
// interface below.
//
// C interface (ctypes): each function returns cudaGetLastError() after its
// launch, or cudaErrorInvalidValue for what it does not take (a dtype its
// library does not instantiate, hd not in {16, 32, 64, 128}, 16-bit
// operands at hd 32-128, the fp32 forward at hd 32-128 and the fp32
// backward at hd 32 and 64).

#pragma once

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps, 16 rows each

// elements per row of a shared (64, HD) tile: HD plus 16 bytes of padding
template <typename T, int HD>
__host__ __device__ constexpr int row_len() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

// rows [r0, r0 + 64) of head h of a contiguous (B, S, NH, HD) tensor into a
// (64, row_len) shared tile, asynchronously (cp.async, 16 bytes a thread per
// copy); rows past S are zero-filled. The caller commits the group.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g,
                                          int b, int r0, int S, int NH, int h) {
  constexpr int E = 16 / sizeof(T), LD = row_len<T, HD>();
  constexpr int kChunks = HD / E;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * E;
    const bool valid = r0 + r < S;
    const T* src = valid ? g + (((size_t)b * S + r0 + r) * NH + h) * HD + c : g;
    cp_async16(sm + r * LD + c, src, valid ? 16 : 0);
  }
}

__device__ __forceinline__ bool key_live(const uint8_t* __restrict__ mask,
                                         int b, int S, int key) {
  return key < S && (mask == nullptr || mask[(size_t)b * S + key] != 0);
}

// ------------------------------------------------------- fp32 tile products
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at about fp32 accuracy (3xTF32): the small terms first; lo.lo
// (~2^-22 of the product) is dropped
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// gemm_rows of attention_tiles.cuh for fp32 tiles (rows of HD + 4): the
// same C fragments, from m16n8k8, whose A fragment holds (row g | g + 8,
// col t | t + 4) and B fragment (k t | t + 4, n g). The k loop stays rolled:
// three tf32 products per fragment make the unrolled code ~15x the 16-bit
// products', and ptxas's time grows faster than the code.
template <int HD>
__device__ __forceinline__ void gemm_rows_f32(float (&c)[8][4],
                                              const float* sA,
                                              const float* sB, int lane) {
  constexpr int LD = HD + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ah[4], al[4];
    split_tf32(sA[g * LD + kk + t], ah[0], al[0]);
    split_tf32(sA[(g + 8) * LD + kk + t], ah[1], al[1]);
    split_tf32(sA[g * LD + kk + t + 4], ah[2], al[2]);
    split_tf32(sA[(g + 8) * LD + kk + t + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* r = sB + (j * 8 + g) * LD + kk + t;
      const float b[2] = {r[0], r[4]};
      mma3(c[j], ah, al, b);
    }
  }
}

// rows of a warp's fp32 scratch: 64 columns plus 16 bytes of padding
constexpr int kScoreLd = kTile + 4;

// a score tile in C fragments into the warp's (16, 64) fp32 scratch
__device__ __forceinline__ void scores_to_scratch(float* sP,
                                                  const float (&p)[8][4],
                                                  int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();                    // the warp's last reads of sP are done
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(sP + g * kScoreLd + 8 * j + 2 * t) =
        make_float2(p[j][0], p[j][1]);
    *reinterpret_cast<float2*>(sP + (g + 8) * kScoreLd + 8 * j + 2 * t) =
        make_float2(p[j][2], p[j][3]);
  }
  __syncwarp();
}

// gemm_p of attention_tiles.cuh for fp32 tiles. The score tile goes
// through the warp's scratch, so the loop over key chunks stays rolled (see
// gemm_rows_f32). Each output n-tile sums its 8 key chunks in a fresh
// fragment and adds it to acc with an fp32 add: the tensor cores do not
// round their fp32 sums to nearest, and a chain over every key of a long
// row drifts (1.2e-4 of max at S 4096 on an H100 when acc itself was the
// accumulator). The C fragment holds keys 8j + 2t and + 1 where the A
// fragment wants k t and t + 4: k t stands for key 8j + 2t and k t + 4 for
// key 8j + 2t + 1 in both operands, a permutation of the 8 keys that
// leaves the sum as it is and keeps the B reads free of bank conflicts.
template <int HD>
__device__ __forceinline__ void gemm_p_f32(float (&acc)[HD / 8][4],
                                           const float (&p)[8][4],
                                           const float* sB, float* sP,
                                           int lane) {
  constexpr int LD = HD + 4;
  const int g = lane >> 2, t = lane & 3;
  scores_to_scratch(sP, p, lane);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      const float2 lo = *reinterpret_cast<const float2*>(
          sP + g * kScoreLd + 8 * j + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(
          sP + (g + 8) * kScoreLd + 8 * j + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(lo.x, ah[0], al[0]);
      split_tf32(hi.x, ah[1], al[1]);
      split_tf32(lo.y, ah[2], al[2]);
      split_tf32(hi.y, ah[3], al[3]);
      const float* r = sB + (8 * j + 2 * t) * LD + n * 8 + g;
      const float b[2] = {r[0], r[LD]};
      mma3(c, ah, al, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

template <typename T, int HD>
__device__ __forceinline__ void tile_rows(float (&c)[8][4], const T* sA,
                                          const T* sB, int lane) {
  if constexpr (std::is_same_v<T, float>)
    gemm_rows_f32<HD>(c, sA, sB, lane);
  else
    gemm_rows<T, HD>(c, sA, sB, lane);
}

// sP: the warp's fp32 score scratch (fp32 operands only)
template <typename T, int HD>
__device__ __forceinline__ void tile_p(float (&acc)[HD / 8][4],
                                       const float (&p)[8][4], const T* sB,
                                       float* sP, int lane) {
  if constexpr (std::is_same_v<T, float>)
    gemm_p_f32<HD>(acc, p, sB, sP, lane);
  else
    gemm_p<T, HD>(acc, p, sB, lane);
}

// bytes of the fp32 scratch a block of 4 warps needs: fp32 operands stage
// their scores there, a bias its tiles
template <typename T, bool BIAS>
constexpr size_t scratch_bytes() {
  return std::is_same_v<T, float> || BIAS
             ? 4 * 16 * kScoreLd * sizeof(float) : 0;
}

// two adjacent outputs, the lower index first
__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}
template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack(lo, hi, T());
}

// ------------------------------------------------------------------ bias
// element (b, h, r, c) of the bias at p[b * sb + h * sh + r * S + c]
struct Bias {
  const void* p;
  long long sb, sh;
  int dtype;                 // 1 fp16, 2 bf16, 3 fp32
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__half* p, float x) {
  *p = __float2half(x);
}
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the (16, 64) bias slice of a warp's score fragments into its fp32
// scratch, upcast, 0 outside S: rows [r0, r0 + 16) x columns [c0, c0 + 64)
// of the (S, S) matrix at p + base; with TRANS the (64, 16) slice rows [r0,
// r0 + 64) x columns [c0, c0 + 16), transposed (dk/dv's fragments hold
// keys in rows). Lanes walk the slice's rows, so reads are coalesced.
template <typename B, bool TRANS>
__device__ __forceinline__ void bias_slice(float* sP,
                                           const B* __restrict__ p,
                                           size_t base, int r0, int c0,
                                           int S, int lane) {
#pragma unroll 4
  for (int i = lane; i < 16 * kTile; i += 32) {
    const int r = TRANS ? i / 16 : i / kTile, c = TRANS ? i % 16 : i % kTile;
    const int gr = r0 + r, gc = c0 + c;
    const float x = gr < S && gc < S ? to_f32(p[base + (size_t)gr * S + gc])
                                     : 0.f;
    sP[TRANS ? c * kScoreLd + r : r * kScoreLd + c] = x;
  }
}

template <bool TRANS>
__device__ __forceinline__ void load_bias(float* sP, const Bias& bias,
                                          size_t base, int r0, int c0, int S,
                                          int lane) {
  __syncwarp();                    // the warp's last reads of sP are done
  if (bias.dtype == 2)
    bias_slice<__nv_bfloat16, TRANS>(
        sP, static_cast<const __nv_bfloat16*>(bias.p), base, r0, c0, S, lane);
  else if (bias.dtype == 1)
    bias_slice<__half, TRANS>(sP, static_cast<const __half*>(bias.p), base,
                              r0, c0, S, lane);
  else
    bias_slice<float, TRANS>(sP, static_cast<const float*>(bias.p), base, r0,
                             c0, S, lane);
  __syncwarp();
}

// the warp's (16, 64) scratch (rows [r0, r0 + 16) x columns [c0, c0 + 64)
// of the (S, S) matrix at p + base) to dbias in its dtype, inside S only
template <typename B>
__device__ __forceinline__ void dbias_slice(B* __restrict__ p,
                                            const float* sP, size_t base,
                                            int r0, int c0, int S, int lane) {
#pragma unroll 4
  for (int i = lane; i < 16 * kTile; i += 32) {
    const int r = i / kTile, c = i % kTile, gr = r0 + r, gc = c0 + c;
    if (gr < S && gc < S)
      from_f32(p + base + (size_t)gr * S + gc, sP[r * kScoreLd + c]);
  }
}

__device__ __forceinline__ void store_dbias(void* p, int dtype,
                                            const float* sP, size_t base,
                                            int r0, int c0, int S, int lane) {
  if (dtype == 2)
    dbias_slice(static_cast<__nv_bfloat16*>(p), sP, base, r0, c0, S, lane);
  else if (dtype == 1)
    dbias_slice(static_cast<__half*>(p), sP, base, r0, c0, S, lane);
  else
    dbias_slice(static_cast<float*>(p), sP, base, r0, c0, S, lane);
}

// ------------------------------------------------------------------ forward
template <typename T, int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ slopes, Bias bias,
                     T* __restrict__ o, float* __restrict__ lse, int S, int H,
                     int KV, int causal, float scale) {
  constexpr int LD = row_len<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + kTile * LD;           // 2 stages of (K, V)
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sP = reinterpret_cast<float*>(sKV + 4 * kTile * LD) +
              warp * 16 * kScoreLd;   // fp32 operands or a bias only
  const int row[2] = {qt * kTile + warp * 16 + g, qt * kTile + warp * 16 + g + 8};
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const size_t bias0 = BIAS ? (size_t)(b * bias.sb + h * bias.sh) : 0;

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
    tile_rows<T, HD>(s, sQ + warp * 16 * LD, sK, lane);
    if constexpr (BIAS)
      load_bias<false>(sP, bias, bias0, qt * kTile + warp * 16, k0, S, lane);
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
        if constexpr (BIAS)
          x += sP[(g + 8 * (e >> 1)) * kScoreLd + j * 8 + 2 * t + (e & 1)];
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
    tile_p<T, HD>(acc, s, sV, sP, lane);
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float ls = fmaxf(l[r], 1e-30f), inv = 1.f / ls;
    T* dst = o + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(dst + n * 8, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0) lse[((size_t)b * H + h) * S + row[r]] = m[r] + logf(ls);
  }
}

// ------------------------------------------------------------------ dq
template <typename T, int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ slopes, Bias bias,
                        T* __restrict__ dq, void* __restrict__ dbias, int S,
                        int H, int KV, int causal, float scale) {
  constexpr int LD = row_len<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kTile * LD;
  T* sKV = sDO + kTile * LD;          // 2 stages of (K, V)
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sP = reinterpret_cast<float*>(sKV + 4 * kTile * LD) +
              warp * 16 * kScoreLd;   // fp32 operands or a bias only
  const int row[2] = {qt * kTile + warp * 16 + g, qt * kTile + warp * 16 + g + 8};
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const size_t bias0 = BIAS ? (size_t)(b * bias.sb + h * bias.sh) : 0;
  const size_t dbias0 = ((size_t)b * H + h) * S * S;
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
    tile_rows<T, HD>(s, sQ + warp * 16 * LD, sK, lane);
    tile_rows<T, HD>(dp, sDO + warp * 16 * LD, sV, lane);
    if constexpr (BIAS)
      load_bias<false>(sP, bias, bias0, qt * kTile + warp * 16, k0, S, lane);
    const bool interior = mask == nullptr && k0 + kTile <= S &&
                          (qt + 1) * kTile <= S && (!causal || jt < qt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1), r = row[e >> 1];
        float x = s[j][e] * scale;
        if constexpr (BIAS)
          x += sP[(g + 8 * (e >> 1)) * kScoreLd + j * 8 + 2 * t + (e & 1)];
        if (slopes != nullptr) x += slope * (float)(key - r);
        const bool live = interior || (r < S && key_live(mask, b, S, key) &&
                                       (!causal || key <= r));
        const float p = live ? __expf(x - lse_r[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);     // ds
      }
    if constexpr (BIAS) {
      if (dbias != nullptr) {                          // dbias = ds
        scores_to_scratch(sP, s, lane);
        store_dbias(dbias, bias.dtype, sP, dbias0, qt * kTile + warp * 16,
                    k0, S, lane);
      }
    }
    tile_p<T, HD>(acc, s, sK, sP, lane);
    __syncthreads();                       // this stage is consumed
  }
  if constexpr (BIAS) {
    // the key tiles past the causal diagonal: dbias 0, so every element of
    // dbias has been written once
    const int c0 = nend * kTile, w = S - c0;
    if (dbias != nullptr && w > 0) {
      __syncwarp();
      for (int i = lane; i < 16 * kScoreLd; i += 32) sP[i] = 0.f;
      __syncwarp();
      for (int c = c0; c < S; c += kTile)
        store_dbias(dbias, bias.dtype, sP, dbias0, qt * kTile + warp * 16, c,
                    S, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    T* dst = dq + (((size_t)b * S + row[r]) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(dst + n * 8, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------------ dk, dv
template <typename T, int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ slopes, Bias bias,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                         int KV, int causal, float scale) {
  constexpr int LD = row_len<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * LD;
  T* sQD = sV + kTile * LD;           // 2 stages of (Q, dO)
  float* sRows = reinterpret_cast<float*>(sQD + 4 * kTile * LD);  // 2 x (lse, delta)
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sP = sRows + 4 * kTile + warp * 16 * kScoreLd;  // as above
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
    const size_t bias0 = BIAS ? (size_t)(b * bias.sb + h * bias.sh) : 0;
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
      tile_rows<T, HD>(s, sK + warp * 16 * LD, sQ, lane);
      tile_rows<T, HD>(dp, sV + warp * 16 * LD, sDO, lane);
      if constexpr (BIAS)
        load_bias<true>(sP, bias, bias0, q0, kt * kTile + warp * 16, S, lane);
      const bool interior = mask == nullptr && q0 + kTile <= S &&
                            (kt + 1) * kTile <= S && (!causal || it > kt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1), query = q0 + qi;
          const int kk = key[e >> 1];
          float x = s[j][e] * scale;
          if constexpr (BIAS)
            x += sP[(g + 8 * (e >> 1)) * kScoreLd + qi];
          if (slopes != nullptr) x += slope * (float)(kk - query);
          const bool live = interior || (live_key[e >> 1] && query < S &&
                                         (!causal || kk <= query));
          const float p = live ? __expf(x - sLse[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sDelta[qi]);       // ds
        }
      tile_p<T, HD>(dva, s, sDO, sP, lane);
      tile_p<T, HD>(dka, dp, sQ, sP, lane);
    }
    __syncthreads();                       // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    const size_t off = (((size_t)b * S + key[r]) * KV + kvh) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store2(dk + off + n * 8, dka[n][2 * r] * scale,
             dka[n][2 * r + 1] * scale);
      store2(dv + off + n * 8, dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  const uint8_t* mask;
  const float* slopes;
  Bias bias;
  void *o, *dk, *dv, *dbias;
  float* lse_out;
  int B, S, H, KV, causal;
  float scale;
  cudaStream_t stream;
};

// the kernels this header builds: at hd 16 all of them, and the fp32
// backward (BWD) at hd 128 (the 16-bit forward and backward at hd 32-128
// are flash_fwd_sm90.cu's and flash_bwd_sm90.cuh's, the fp32 forward at hd
// 32-128 flash_fwd_f32_sm90.cu's, the fp32 backward at hd 32 and 64
// flash_bwd_f32_sm90.cuh's)
template <typename T, int HD, bool BWD>
constexpr bool here() {
  return HD == 16 || (std::is_same_v<T, float> && BWD && HD == 128);
}

template <typename T, int HD, bool BIAS>
cudaError_t launch(int which, const Args& a) {
  // the backward's instances include the forward's
  if constexpr (!here<T, HD, true>()) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int LD = row_len<T, HD>();
    const dim3 block(kThreads);
    const int tiles = (a.S + kTile - 1) / kTile;
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    cudaError_t err;
    if (which == 0) {
      if constexpr (!here<T, HD, false>()) {
        return cudaErrorInvalidValue;
      } else {
        const size_t smem =
            5 * kTile * LD * sizeof(T) + scratch_bytes<T, BIAS>();
        auto fn = flash_fwd_kernel<T, HD, BIAS>;
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        fn<<<dim3(tiles, a.H, a.B), block, smem, a.stream>>>(
            q, k, v, a.mask, a.slopes, a.bias, static_cast<T*>(a.o),
            a.lse_out, a.S, a.H, a.KV, a.causal, a.scale);
      }
    } else if (which == 1) {
      const size_t smem =
          6 * kTile * LD * sizeof(T) + scratch_bytes<T, BIAS>();
      auto fn = flash_bwd_dq_kernel<T, HD, BIAS>;
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      fn<<<dim3(tiles, a.H, a.B), block, smem, a.stream>>>(
          q, k, v, dout, a.lse_in, a.delta, a.mask, a.slopes, a.bias,
          static_cast<T*>(a.o), a.dbias, a.S, a.H, a.KV, a.causal, a.scale);
    } else {
      const size_t smem = 6 * kTile * LD * sizeof(T) +
                          4 * kTile * sizeof(float) + scratch_bytes<T, BIAS>();
      auto fn = flash_bwd_dkv_kernel<T, HD, BIAS>;
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      fn<<<dim3(tiles, a.KV, a.B), block, smem, a.stream>>>(
          q, k, v, dout, a.lse_in, a.delta, a.mask, a.slopes, a.bias,
          static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.H, a.KV,
          a.causal, a.scale);
    }
    return cudaGetLastError();
  }
}

template <typename T, int HD>
cudaError_t dispatch_bias(int which, const Args& a) {
  return a.bias.p != nullptr ? launch<T, HD, true>(which, a)
                             : launch<T, HD, false>(which, a);
}

template <typename T>
cudaError_t dispatch_hd(int which, int hd, const Args& a) {
  switch (hd) {
    case 16: return dispatch_bias<T, 16>(which, a);
    case 32: return dispatch_bias<T, 32>(which, a);
    case 64: return dispatch_bias<T, 64>(which, a);
    case 128: return dispatch_bias<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

// the arguments no kernel takes
bool args_ok(const Args& a) {
  return a.B > 0 && a.S > 0 && a.H > 0 && a.KV > 0 && a.H % a.KV == 0 &&
         a.B <= 65535 && a.H <= 65535 &&
         (a.bias.p == nullptr || (a.bias.dtype >= 1 && a.bias.dtype <= 3)) &&
         (a.dbias == nullptr || a.bias.p != nullptr);
}

// the launch of the dtypes a translation unit instantiates: defined by
// flash_attention.cu (bf16, fp16) and flash_attention_f32.cu (fp32)
int run(int which, int hd, int dtype, const Args& a);

}  // namespace

// dtype and bias_dtype: 1 fp16, 2 bf16, 3 fp32. mask: (B, S) uint8 or null;
// slopes: (H,) fp32 or null; bias: null, or element (b, h, r, c) at
// b * bias_sb + h * bias_sh + r * S + c; lse: (B, H, S) fp32 out.
extern "C" int dstpu_flash_fwd(const void* q, const void* k, const void* v,
                               const uint8_t* mask, const float* slopes,
                               const void* bias, void* o, float* lse, int B,
                               int S, int H, int KV, int hd, int causal,
                               int dtype, int bias_dtype, long long bias_sb,
                               long long bias_sh, float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, mask, slopes,
         Bias{bias, bias_sb, bias_sh, bias_dtype}, o, nullptr, nullptr,
         nullptr, lse, B, S, H, KV, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, hd, dtype, a);
}

// dout, dq: (B, S, H, hd); lse, delta: (B, H, S) fp32; dbias: null, or a
// contiguous (B, H, S, S) tensor of the bias's dtype, every element written.
extern "C" int dstpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const uint8_t* mask,
                                  const float* slopes, const void* bias,
                                  void* dq, void* dbias, int B, int S, int H,
                                  int KV, int hd, int causal, int dtype,
                                  int bias_dtype, long long bias_sb,
                                  long long bias_sh, float scale,
                                  void* stream) {
  Args a{q, k, v, dout, lse, delta, mask, slopes,
         Bias{bias, bias_sb, bias_sh, bias_dtype}, dq, nullptr, nullptr,
         dbias, nullptr, B, S, H, KV, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, hd, dtype, a);
}

// dk, dv: (B, S, KV, hd), each KV head the sum over its group of query heads.
extern "C" int dstpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, const uint8_t* mask,
                                   const float* slopes, const void* bias,
                                   void* dk, void* dv, int B, int S, int H,
                                   int KV, int hd, int causal, int dtype,
                                   int bias_dtype, long long bias_sb,
                                   long long bias_sh, float scale,
                                   void* stream) {
  Args a{q, k, v, dout, lse, delta, mask, slopes,
         Bias{bias, bias_sb, bias_sh, bias_dtype}, nullptr, dk, dv, nullptr,
         nullptr, B, S, H, KV, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(2, hd, dtype, a);
}
