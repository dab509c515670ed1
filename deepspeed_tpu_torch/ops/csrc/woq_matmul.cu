// Weight-only-quantized GEMMs on Hopper (sm_90a): int8 or row-pair-packed
// int4 weights, fp32 group scales, dequantized inside the product.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/woq_matmul.py:
// - _matmul_kernel (:62, x @ W, W (K, N)): per group g of group_size rows,
//   an fp32 partial sum_k x[m,k] * q[k,n] with q cast to x's dtype, then
//   acc += partial * scale[g,n] in fp32, one rounding to the output dtype;
// - _matmul_t_kernel (:130, x @ W.T, W (V, K), the tied head): the table is
//   dequantized as q[v,k] * scale[g(v),k] in fp32, ROUNDED to x's dtype,
//   then contracted with x in fp32.
// Both keep those orders of operations; only the order of the fp32 sums
// differs from the TPU kernels and the plain versions.
//
// Bound. Decode calls these with M = batch rows (4 on the main path) and
// K, N in the thousands: 2*M flops per weight byte read (4*M for int4),
// far under the H100's ~295 flop/byte ridge. They are bound by bytes:
// (q + scale + x + out) / 3.35 TB/s. Every q byte is read once.
//
// dstpu_woq_matmul_mma, x @ W on the tensor cores, for bf16 / fp16 x with
// N % 16 == 0 and 16-row-aligned groups (ops/woq_matmul.py woq_route):
// - swap-AB on mma.sync m16n8k16: the weight's columns are the A operand's
//   16 rows, x's rows (up to 8, zero past M) its n8; M 9-16 takes two n8
//   tiles in the same pass over the weight, larger M more 16-row blocks;
// - the A operand is q itself in x's dtype, exact: an int8 register pairs
//   the same byte of two adjacent rows (k, k + 1) by one prmt, an int4
//   register is one packed byte (rows 2r, 2r + 1), and a lop3 puts the
//   integer under a 16-bit exponent (0x64 / 0x43: 1024 + u / 128 + u) that
//   one packed fma removes; bf16 int8 (7 mantissa bits) takes one more
//   lop3, the exponent that corrects the sign. No element is scaled or
//   rounded: a group's k16 steps sum in fresh fp32 fragments (even and odd
//   steps apart, two chains) and its scale folds in once, acc += part *
//   scale, as the TPU kernel;
// - a unit is 128 columns x a k range (whole groups) x 16 rows of x; a
//   producer warp streams it through a ring of TMA stages from 2-D tensor
//   maps (q: 128 columns x 128 k; x: two 64-k boxes, zero past M and K),
//   encoded on the host per call, in the 128-byte swizzle; 8 consumer warps
//   own 16 columns each (2 bytes a lane a row: no bank conflict) and
//   release each stage through an mbarrier;
// - split-K in one launch: ops/woq_matmul.py woq_split_plan sizes the k
//   ranges from the shapes (at least 512 rows, at most three blocks an SM);
//   every block writes fp32 partials to a workspace the wrapper caches per
//   device and takes a ticket, and the column tile's last block sums them
//   in split order and resets the ticket: no second launch, no allocation
//   a call, the same result every run.
// What the H100 showed (PERF.md, PR 10): the stream, not the arithmetic,
// sets the time at int8 (a build that skipped the products ran little
// faster there), while int4, half the bytes, runs further from its bound
// because the per-element instructions then show. A ring of 2 int8
// stages ran as fast as 4 or faster; k ranges under 512 rows paid more in
// merges and first-copy latency than they gained in blocks; warps of 32
// columns (4-byte reads, two A tiles) ran int4 faster and int8 slower than
// these 16-column ones.
//
// dstpu_woq_matmul (the rest of woq_route: fp32 x, a ragged N, groups not
// 16-row aligned), on the CUDA cores:
// - a block owns a tile of 128 output columns for up to MT rows of x; each
//   lane owns 4 adjacent columns and reads them as one 4-byte load per
//   weight row, so a warp reads 128 contiguous bytes of each row;
// - the 8 warps of a block take whole groups (warp w: groups g0 + w, g0 +
//   w + 8, ...), so a group's partial is finished in one warp's registers
//   before its scale multiplies it; a warp loads 32 rows (16 packed int4
//   rows) at once before it computes, 128 bytes in flight per lane;
// - x rows enter 32 at a time, one value per lane, and reach the other
//   lanes by shuffle;
// - split-K: ceil(G / 8) blocks share a column tile. The 8 warps' sums
//   merge through shared memory in warp order; with more than one split
//   each block writes fp32 partials and a second kernel adds the splits in
//   order. No atomics: the result does not change from run to run.
//
// dstpu_woq_matmul_t_mma, x @ W.T on the tensor cores, for bf16 / fp16 x
// with K % 16 == 0 (ops/woq_matmul.py woq_t_route picks it). Per element
// the old kernel spent ~9 instructions on the CUDA cores (bound by issue,
// not bytes); this one dequantizes into mma.sync operands:
// - persistent blocks walk 16-row tiles of W (16 int8 rows or 8 packed
//   int4 rows); a producer warp streams each tile in stages of up to 1024
//   k columns, one 1-D bulk copy (cp.async.bulk) per staged row into rows
//   padded by 16 bytes (so the fragment reads are free of bank conflicts),
//   into a ring of ~32 KB whose stages complete mbarriers; the consumers
//   release a stage through a second mbarrier. Three blocks fit an SM (72
//   registers a thread): the kernel waits on loads more than it issues, so
//   warps count more than a deeper ring;
// - x's rows (up to 8, zero beyond M: the n8 of one m16n8k16 product) are
//   loaded once a block into shared memory, the scale row goes through L1;
//   with G > 1 a tile lies inside one group (the route asks gs % 16 == 0);
// - 8 consumer warps split each stage's k columns, 128 a warp; a lane owns
//   16 contiguous k of two rows and turns each byte or nibble into fp32 by
//   the exponent trick (prmt into 0x4B0000xx, one fsub: exactly the
//   integer), multiplies by the fp32 scale and rounds to x's dtype with a
//   packed cvt: the A operand, in the TPU kernel's rounding points. The k
//   order inside a 16-k product is permuted the same way in A and B, and
//   int4's rows are permuted so a lane's two rows are one packed byte; the
//   epilogue undoes the row permutation;
// - each warp keeps its tile's fp32 accumulators over all stages, in two
//   chains of dependent products (one for each of a lane's two 16-k
//   pieces); the 8 warps' sums are added in warp order through shared
//   memory, so the result does not change from run to run.
// On the H100 its copies do not set its time: whole-tile copies, rings of
// 32-128 KB and 32-row tiles (half the x and scale loads an element) ran
// no faster than this layout; dropping the dequantization's instructions
// did.
// dstpu_woq_matmul_t (the rest of woq_t_route: fp32 x, K not a multiple of
// 16 or above 8192, 16-row tiles across scale groups): one warp per ROWS
// rows of W (ROWS/2 packed int4 rows, so a warp unpacks both rows of a
// byte); its lanes stride K four elements at a time and a warp butterfly
// reduces each row's sum. x and the scale rows are re-read by every warp
// through L1.
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launches, or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"   // mma (m16n8k16), pack
#include "bulk_copy.cuh"         // mbarriers, bulk copies, TMA, fit_smem

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;  // columns per block of the x @ W kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the dequantized weight in the activation dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 4 bytes row[c0 .. c0+3] of a row of `cols` bytes (zeros past the end);
// one aligned 4-byte load when the row length is a multiple of 4.
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ row,
                                          int c0, int cols, bool vec) {
  if (vec && c0 + 3 < cols)
    return __ldg(reinterpret_cast<const uint32_t*>(row + c0));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c0 + c < cols) v |= (uint32_t)(uint8_t)__ldg(row + c0 + c) << (8 * c);
  return v;
}

// signed value of byte c of a 4-byte word: int8, or the low / high nibble
__device__ __forceinline__ int byte_at(uint32_t w, int c) {
  return (int)(int8_t)(w >> (8 * c));
}
__device__ __forceinline__ int nibble_lo(uint32_t w, int c) {
  return ((int)(int8_t)((w >> (8 * c)) << 4)) >> 4;
}
__device__ __forceinline__ int nibble_hi(uint32_t w, int c) {
  return ((int)(int8_t)(w >> (8 * c))) >> 4;
}

// ------------------------------------------------------------ x @ W (K, N)
template <typename TX, typename TO, int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
    woq_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, TO* __restrict__ out,
                      float* __restrict__ ws, int M, int K, int N, int G,
                      int gs, int groups_per_split) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kTileN + lane * 4;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int g_begin = split * groups_per_split;
  const int g_end = min(G, g_begin + groups_per_split);
  const bool vec = (N & 3) == 0;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int g = g_begin + warp; g < g_end; g += kWarps) {
    float part[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[m][c] = 0.f;

    for (int r0 = 0; r0 < gs; r0 += 32) {
      const int k0 = g * gs + r0;
      const int rows = min(32, gs - r0);
      float xr[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xr[m] = (lane < rows && m0 + m < M)
                    ? to_f32(x[(size_t)(m0 + m) * K + k0 + lane])
                    : 0.f;
      if constexpr (BITS == 8) {
        uint32_t w[32];
#pragma unroll
        for (int r = 0; r < 32; ++r)
          w[r] = r < rows ? load4(q + (size_t)(k0 + r) * N, n0, N, vec) : 0u;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = __shfl_sync(kFull, xr[m], r);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part[m][c] = fmaf(xv, (float)byte_at(w[r], c), part[m][c]);
          }
        }
      } else {
        // packed row p holds rows 2p (low nibble) and 2p + 1 (high); gs is
        // even, so k0 is even and a chunk never splits a pair
        uint32_t w[16];
#pragma unroll
        for (int p = 0; p < 16; ++p)
          w[p] = 2 * p < rows
                     ? load4(q + (size_t)(k0 / 2 + p) * N, n0, N, vec)
                     : 0u;
#pragma unroll
        for (int p = 0; p < 16; ++p) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xlo = __shfl_sync(kFull, xr[m], 2 * p);
            const float xhi = __shfl_sync(kFull, xr[m], 2 * p + 1);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              part[m][c] = fmaf(xlo, (float)nibble_lo(w[p], c), part[m][c]);
              part[m][c] = fmaf(xhi, (float)nibble_hi(w[p], c), part[m][c]);
            }
          }
        }
      }
    }
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[c] = n0 + c < N ? scale[(size_t)g * N + n0 + c] : 0.f;
    // acc += partial * scale, two roundings as in the reference (no fma)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[m][c] = __fadd_rn(acc[m][c], __fmul_rn(part[m][c], s[c]));
  }

  // merge the warps' sums in warp order
  __shared__ float red[kWarps][MT][kTileN];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * kTileN; idx += kThreads) {
    const int m = idx / kTileN, col = idx - m * kTileN;
    const int n = blockIdx.x * kTileN + col;
    if (m0 + m >= M || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][m][col];
    if (gridDim.y == 1)
      out[(size_t)(m0 + m) * N + n] = from_f32<TO>(sum);
    else
      ws[((size_t)split * M + m0 + m) * N + n] = sum;
  }
}

// out = sum over the splits, in split order
template <typename TO>
__global__ void woq_reduce_kernel(const float* __restrict__ ws,
                                  TO* __restrict__ out, int splits,
                                  size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += ws[(size_t)s * count + i];
    out[i] = from_f32<TO>(sum);
  }
}

template <typename TX, typename TO, int BITS, int MT>
cudaError_t launch_matmul(const void* x, const int8_t* q, const float* scale,
                          void* out, float* ws, int M, int K, int N, int gs,
                          int splits, cudaStream_t st) {
  const int G = K / gs;
  const int per = (G + splits - 1) / splits;
  const dim3 grid((N + kTileN - 1) / kTileN, splits, (M + MT - 1) / MT);
  woq_matmul_kernel<TX, TO, BITS, MT><<<grid, kThreads, 0, st>>>(
      static_cast<const TX*>(x), q, scale, static_cast<TO*>(out), ws, M, K,
      N, G, gs, per);
  if (splits > 1) {
    const size_t count = (size_t)M * N;
    const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256
                                                        : 4096);
    woq_reduce_kernel<TO><<<blocks, 256, 0, st>>>(ws, static_cast<TO*>(out),
                                                  splits, count);
  }
  return cudaGetLastError();
}

// rows of x per block: 1, 4 or 8 (M above 8 takes several row tiles, each
// reading the weight again)
template <typename TX, typename TO, int BITS>
cudaError_t dispatch_matmul_m(const void* x, const int8_t* q,
                              const float* scale, void* out, float* ws, int M,
                              int K, int N, int gs, int splits,
                              cudaStream_t st) {
  if (M == 1)
    return launch_matmul<TX, TO, BITS, 1>(x, q, scale, out, ws, M, K, N, gs,
                                          splits, st);
  if (M <= 4)
    return launch_matmul<TX, TO, BITS, 4>(x, q, scale, out, ws, M, K, N, gs,
                                          splits, st);
  return launch_matmul<TX, TO, BITS, 8>(x, q, scale, out, ws, M, K, N, gs,
                                        splits, st);
}

template <typename TX, typename TO>
cudaError_t dispatch_matmul_bits(int bits, const void* x, const int8_t* q,
                                 const float* scale, void* out, float* ws,
                                 int M, int K, int N, int gs, int splits,
                                 cudaStream_t st) {
  if (bits == 8)
    return dispatch_matmul_m<TX, TO, 8>(x, q, scale, out, ws, M, K, N, gs,
                                        splits, st);
  return dispatch_matmul_m<TX, TO, 4>(x, q, scale, out, ws, M, K, N, gs,
                                      splits, st);
}

// ------------------------------------------ x @ W (K, N) on the tensor cores
// swap-AB: out^T (N x M) = W^T (N x K) . x^T (K x M) on mma.sync m16n8k16,
// the weight's columns as the A operand's rows, x's rows (zero past M) as
// the n8 of B (the header gives the layout and the reasons).
constexpr int kMmWarps = 8;                      // consumer warps
constexpr int kMmThreads = (kMmWarps + 1) * 32;  // and the producer warp
constexpr int kMmTileN = 128;     // columns of a unit: one 128-byte box row
constexpr int kMmStageK = 128;    // k of a ring stage
constexpr int kMmMaxStages = 8;

// q's box: 128 columns of 128 rows (int8) or 64 packed rows (int4); x's:
// 64 k (128 bytes) of 8 * MT rows, two a stage. Every box is a multiple of
// 1024 bytes, so each starts on the 128-byte swizzle's 1024-byte period.
template <int BITS> constexpr int kQBoxRows = BITS == 8 ? 128 : 64;
template <int BITS> constexpr int kQBoxBytes = kQBoxRows<BITS> * 128;
template <int MT> constexpr int kXBoxBytes = 8 * MT * 128;
template <int BITS, int MT>
constexpr int kMmStageBytes = kQBoxBytes<BITS> + 2 * kXBoxBytes<MT>;

// the consumer warps' barrier (the producer warp has left)
__device__ __forceinline__ void mm_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kMmWarps * 32) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t lds16(const unsigned char* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n"
      : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

// a * b + c on two 16-bit lanes, one rounding (exact on these integers)
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c,
                                         __half) {
  uint32_t d;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c,
                                         __nv_bfloat16) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// __byte_perm selector: byte J of the first word into bytes 0 and 1, byte
// J of the second into bytes 2 and 3
template <int J>
constexpr uint32_t kPairSel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);

// int8: the signed bytes J of two rows' words (k and k + 1 at one column)
// as one A register of x's dtype, k in the low half. fp16: the byte with
// its sign flipped under 0x64 is 1024 + (q + 128), one lop3; minus 1152.
// bf16 (7 mantissa bits): 0x4300 | (q & 0x7F) is 128 + (q & 0x7F), minus
// 0x4300 | (q & 0x80), which is 256 for a negative q and 128 else. Exact:
// the A operand holds q in x's dtype, as the TPU kernel's q.astype(x.dtype).
template <int J>
__device__ __forceinline__ uint32_t a_int8(uint32_t lo, uint32_t hi, __half) {
  const uint32_t v = __byte_perm(lo, hi, kPairSel<J>);
  // under 0x00FF00FF: v with bit 7 flipped (c's 0x80); elsewhere c's 0x64
  return fma2(lop3<0x6A>(v, 0x00FF00FFu, 0x64806480u), 0x3C003C00u,
              0xE480E480u, __half());                     // x 1, - 1152
}
template <int J>
__device__ __forceinline__ uint32_t a_int8(uint32_t lo, uint32_t hi,
                                           __nv_bfloat16) {
  const uint32_t v = __byte_perm(lo, hi, kPairSel<J>);
  const uint32_t val = lop3<0xEA>(v, 0x007F007Fu, 0x43004300u);  // a & b | c
  const uint32_t off = lop3<0xEA>(v, 0x00800080u, 0x43004300u);
  return fma2(off, 0xBF80BF80u, val, __nv_bfloat16());    // val - off
}

// int4: byte J of a packed row (k in the low nibble, k + 1 in the high) as
// one A register: the word and the word >> 4 bring both nibbles to bit 0 of
// a half; under 0x6400 (fp16) or 0x4300 (bf16) with bit 3 flipped that is
// 1024 / 128 + (q + 8), minus 1032 / 136.
template <int J, typename TX>
__device__ __forceinline__ uint32_t a_int4(uint32_t w, uint32_t w4) {
  constexpr bool kHalf = std::is_same<TX, __half>::value;
  const uint32_t v = __byte_perm(w, w4, kPairSel<J>);
  return fma2(lop3<0x6A>(v, 0x000F000Fu, kHalf ? 0x64086408u : 0x43084308u),
              kHalf ? 0x3C003C00u : 0x3F803F80u,
              kHalf ? 0xE408E408u : 0xC308C308u, TX());   // x 1, - 1032 / 136
}

// One k16 step I of a stage for a warp: its 16 columns against x's 8 * MT
// rows, into part. q: the stage's q box, x: its first x box. Lane (g, t)
// reads 2 bytes a row at columns 2g, 2g + 1 of the warp's chunk: the A
// tile's rows g and g + 8. int8: rows 2t, 2t + 1, 2t + 8 and 2t + 9 of the
// step; int4: packed rows t and t + 4 (k 2t, 2t + 1 and 2t + 8, 2t + 9):
// the fragment's own k, so B is x's rows as they lie. In the 128-byte
// swizzle chunk c of row r lies at chunk c ^ (r & 7); a lane's rows take
// two values of r & 7 (qoff0, qoff1), the 4 t of a warp 4 distinct chunks,
// so no read of a warp meets a bank conflict.
template <typename TX, int BITS, int MT, int I>
__device__ __forceinline__ void mm_step(float (&part)[MT][4],
                                        const unsigned char* q,
                                        const unsigned char* x, int qrow,
                                        int qoff0, int qoff1, int gid, int t) {
  uint32_t a[4];
  if constexpr (BITS == 8) {
    const unsigned char* r = q + (16 * I) * 128 + qrow;
    const uint32_t w0 = lds16(r + qoff0), w1 = lds16(r + 128 + qoff1);
    const uint32_t w8 = lds16(r + 1024 + qoff0), w9 = lds16(r + 1152 + qoff1);
    a[0] = a_int8<0>(w0, w1, TX());
    a[1] = a_int8<1>(w0, w1, TX());
    a[2] = a_int8<0>(w8, w9, TX());
    a[3] = a_int8<1>(w8, w9, TX());
  } else {
    const unsigned char* r = q + (8 * I) * 128 + qrow;
    const uint32_t p0 = lds16(r + qoff0), p4 = lds16(r + 512 + qoff1);
    a[0] = a_int4<0, TX>(p0, p0 >> 4);
    a[1] = a_int4<1, TX>(p0, p0 >> 4);
    a[2] = a_int4<0, TX>(p4, p4 >> 4);
    a[3] = a_int4<1, TX>(p4, p4 >> 4);
  }
  // x: box I / 4, k (I % 4) * 16 + 2t (+ 8) in it; row gid (+ 8), swizzled
  // by gid
  const unsigned char* xb = x + (I / 4) * kXBoxBytes<MT> + gid * 128 + 4 * t;
  constexpr int c0 = (I % 4) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const uint32_t b[2] = {lds32(xb + mt * 1024 + ((c0 ^ gid) << 4)),
                           lds32(xb + mt * 1024 + (((c0 + 1) ^ gid) << 4))};
    mma(part[mt], a, b, TX());
  }
}

__device__ __forceinline__ float2 scale2(const float* __restrict__ scale,
                                         int g, int N, int n) {
  return n < N ? __ldg(reinterpret_cast<const float2*>(scale +
                                                       (size_t)g * N + n))
               : make_float2(0.f, 0.f);
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float2 v) {
  if constexpr (std::is_same<TO, float>::value)
    *reinterpret_cast<float2*>(p) = v;
  else
    *reinterpret_cast<uint32_t*>(p) = pack(v.x, v.y, TO());
}

// A block owns a unit: 128 columns (blockIdx.x) x the k range of split
// blockIdx.y x 8 * MT rows of x (blockIdx.z). The producer warp streams the
// range through a ring of `stages` stages (q's box and x's two boxes each);
// the 8 consumer warps take 16 columns each over the whole range. A group's
// k16 steps sum into a fresh fragment part; at the group's end acc += part
// * scale in fp32, two roundings, as the TPU kernel (G == 1: part is the
// result, scaled once at the end, after the splits' sum). With one split
// the block writes out; with more each writes its fp32 partial to ws and
// takes a ticket, and the last block of the column tile sums the partials
// in split order (all its threads, up to 8 splits' loads in flight at
// once), writes out and resets the ticket.
template <typename TX, typename TO, int BITS, int MT>
__global__ void __launch_bounds__(kMmThreads, 3)
    woq_matmul_mma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tx,
                          const float* __restrict__ scale,
                          TO* __restrict__ out, float* __restrict__ ws,
                          int* __restrict__ tickets, int M, int K, int N,
                          int gs, int G, int kchunk, int stages) {
  constexpr int QB = kQBoxBytes<BITS>, XB = kXBoxBytes<MT>;
  constexpr int SB = kMmStageBytes<BITS, MT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMmMaxStages], empty[kMmMaxStages];
  __shared__ int last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const unsigned char* ringp = smem_raw + (ring - raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kMmTileN;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int m0 = blockIdx.z * 8 * MT;
  const int kb = split * kchunk, ke = min(K, kb + kchunk);
  const int nst = (ke - kb + kMmStageK - 1) / kMmStageK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kMmWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kMmWarps) {                          // the producer
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      for (int j = 0; j < nst; ++j) {
        const int s = j % stages;
        if (j >= stages) mbar_wait(smem_u32(&empty[s]), ((j / stages) - 1) & 1);
        const int k0 = kb + j * kMmStageK;
        const int xboxes = k0 + 64 < ke ? 2 : 1;   // the second where needed
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t dst = ring + s * SB;
        mbar_expect_tx(bar, QB + xboxes * XB);
        tma_load_2d(dst, &tq, bar, n0, BITS == 8 ? k0 : k0 / 2);
        tma_load_2d(dst + QB, &tx, bar, k0, m0);
        if (xboxes == 2) tma_load_2d(dst + QB + XB, &tx, bar, k0 + 64, m0);
      }
    }
    return;
  }

  const int gid = lane >> 2, t = lane & 3;
  const int ncol = n0 + warp * 16 + 2 * gid;       // this lane's 2 columns
  int qrow, qoff0, qoff1;                          // see mm_step
  if constexpr (BITS == 8) {
    qrow = 2 * t * 128;
    qoff0 = ((warp ^ ((2 * t) & 7)) << 4) + 2 * gid;
    qoff1 = ((warp ^ ((2 * t + 1) & 7)) << 4) + 2 * gid;
  } else {
    qrow = t * 128;
    qoff0 = ((warp ^ t) << 4) + 2 * gid;
    qoff1 = ((warp ^ (t + 4)) << 4) + 2 * gid;
  }
  // a group's products: even k16 steps into pa, odd ones into pb (two
  // chains of dependent products instead of one), pa + pb at the fold
  float acc[MT][4], pa[MT][4], pb[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = pa[mt][e] = pb[mt][e] = 0.f;

  int g = G > 1 ? kb / gs : 0;
  float2 sv = scale2(scale, g, N, ncol);
  // k left in the current group (G == 1: no fold before the end)
  int left = G > 1 ? gs : 0x7fffffff;
  auto fold = [&]() {              // the group's end: acc += part * scale
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float part = __fadd_rn(pa[mt][e], pb[mt][e]);
        acc[mt][e] = __fadd_rn(acc[mt][e],
                               __fmul_rn(part, e < 2 ? sv.x : sv.y));
        pa[mt][e] = pb[mt][e] = 0.f;
      }
    left = gs;
    if (++g * gs < ke) sv = scale2(scale, g, N, ncol);
  };
  // whole stages inside whole groups run their 8 steps with no branch
  // between them, so the compiler issues the next steps' reads early
  const bool whole = G == 1 || gs % kMmStageK == 0;
  for (int j = 0; j < nst; ++j) {
    const int s = j % stages;
    mbar_wait(smem_u32(&full[s]), (j / stages) & 1);
    const unsigned char* st = ringp + s * SB;
    const int steps = min(kMmStageK, ke - kb - j * kMmStageK) / 16;
    if (whole && steps == kMmStageK / 16) {
      mm_step<TX, BITS, MT, 0>(pa, st, st + QB, qrow, qoff0, qoff1, gid, t);
      mm_step<TX, BITS, MT, 1>(pb, st, st + QB, qrow, qoff0, qoff1, gid, t);
      mm_step<TX, BITS, MT, 2>(pa, st, st + QB, qrow, qoff0, qoff1, gid, t);
      mm_step<TX, BITS, MT, 3>(pb, st, st + QB, qrow, qoff0, qoff1, gid, t);
      mm_step<TX, BITS, MT, 4>(pa, st, st + QB, qrow, qoff0, qoff1, gid, t);
      mm_step<TX, BITS, MT, 5>(pb, st, st + QB, qrow, qoff0, qoff1, gid, t);
      mm_step<TX, BITS, MT, 6>(pa, st, st + QB, qrow, qoff0, qoff1, gid, t);
      mm_step<TX, BITS, MT, 7>(pb, st, st + QB, qrow, qoff0, qoff1, gid, t);
      left -= kMmStageK;
      if (left == 0) fold();
    } else {                       // a range's ragged end, groups of 16-112
      auto step = [&](auto i) {
        constexpr int I = decltype(i)::value;
        if (I >= steps) return;
        mm_step<TX, BITS, MT, I>(pa, st, st + QB, qrow, qoff0, qoff1, gid, t);
        left -= 16;
        if (left == 0) fold();
      };
      step(std::integral_constant<int, 0>());
      step(std::integral_constant<int, 1>());
      step(std::integral_constant<int, 2>());
      step(std::integral_constant<int, 3>());
      step(std::integral_constant<int, 4>());
      step(std::integral_constant<int, 5>());
      step(std::integral_constant<int, 6>());
      step(std::integral_constant<int, 7>());
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }
  if (G == 1) {                    // the one group's sum (scaled at the end)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = __fadd_rn(pa[mt][e], pb[mt][e]);
  }

  // this lane's results: rows m0 + 8 mt + 2t + e at columns ncol, ncol + 1
  // (the C fragment's row g is column 2g, its row g + 8 column 2g + 1)
  const bool colon = ncol < N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * mt + 2 * t + e;
      if (m >= M || !colon) continue;
      float2 v = make_float2(acc[mt][e], acc[mt][2 + e]);
      if (nsplit > 1)
        *reinterpret_cast<float2*>(ws + ((size_t)split * M + m) * N + ncol) =
            v;
      else if (G == 1)             // the group's one scale, once
        store2(out + (size_t)m * N + ncol,
               make_float2(__fmul_rn(v.x, sv.x), __fmul_rn(v.y, sv.y)));
      else
        store2(out + (size_t)m * N + ncol, v);
    }
  if (nsplit == 1) return;

  // the last block of this column tile sums the splits in split order
  __threadfence();
  mm_consumers_sync();
  if (threadIdx.x == 0) {
    int* tk = tickets + (size_t)blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(tk, 1) == nsplit - 1;
    if (last) *tk = 0;                     // ready for the next call
  }
  mm_consumers_sync();
  if (!last) return;
  __threadfence();
  const size_t stride = (size_t)M * N;
  const int rows = min(8 * MT, M - m0);
  for (int i = threadIdx.x; i < rows * (kMmTileN / 2); i += kMmWarps * 32) {
    const int m = m0 + i / (kMmTileN / 2), n = n0 + 2 * (i % (kMmTileN / 2));
    if (n >= N) continue;
    const float* p = ws + (size_t)m * N + n;
    float2 v = make_float2(0.f, 0.f);
    for (int s0 = 0; s0 < nsplit; s0 += 8) {
      float2 w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < nsplit)
          w[j] = __ldcg(reinterpret_cast<const float2*>(p + (s0 + j) * stride));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < nsplit)
          v = s0 + j == 0 ? w[j] : make_float2(v.x + w[j].x, v.y + w[j].y);
    }
    if (G == 1) {
      const float2 s1 = scale2(scale, 0, N, n);
      v = make_float2(__fmul_rn(v.x, s1.x), __fmul_rn(v.y, s1.y));
    }
    store2(out + (size_t)m * N + n, v);
  }
}

struct MmArgs {
  const void *x, *q;
  const float* scale;
  void* out;
  float* ws;
  int* tickets;
  int M, K, N, gs, kchunk, splits, ring_bytes, x_dtype;
  cudaStream_t stream;
};

// q as (rows, N) bytes in boxes of 128 columns x kQBoxRows rows; x as (M,
// K) 16-bit in boxes of 64 k x 8 * MT rows; both in the 128-byte swizzle
bool encode_mm(EncodeTiled fn, CUtensorMap* tq, CUtensorMap* tx,
               const MmArgs& a, int bits, int mt) {
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t qdims[2] = {(cuuint64_t)a.N,
                               (cuuint64_t)(bits == 8 ? a.K : a.K / 2)};
  const cuuint64_t qstride[1] = {(cuuint64_t)a.N};
  const cuuint32_t qbox[2] = {128, (cuuint32_t)(bits == 8 ? 128 : 64)};
  const cuuint64_t xdims[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint64_t xstride[1] = {(cuuint64_t)a.K * 2};
  const cuuint32_t xbox[2] = {64, (cuuint32_t)(8 * mt)};
  return fn(tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a.q),
            qdims, qstride, qbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(tx, a.x_dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            2, const_cast<void*>(a.x), xdims, xstride, xbox, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// stages of the ring that fit ring_bytes (2 .. kMmMaxStages)
template <int BITS, int MT>
int mm_stages(int ring_bytes) {
  const int s = ring_bytes / kMmStageBytes<BITS, MT>;
  return s < 2 ? 2 : s > kMmMaxStages ? kMmMaxStages : s;
}

template <typename TX, typename TO, int BITS, int MT>
cudaError_t launch_mm(const MmArgs& a, EncodeTiled enc) {
  constexpr auto fn = woq_matmul_mma_kernel<TX, TO, BITS, MT>;
  const int stages = mm_stages<BITS, MT>(a.ring_bytes);
  const int smem = 1024 + stages * kMmStageBytes<BITS, MT>;
  CUtensorMap tq, tx;
  if (!encode_mm(enc, &tq, &tx, a, BITS, MT)) return cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = fit_smem<fn>(smem, kMmThreads, &per_sm);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kMmTileN - 1) / kMmTileN, a.splits,
                  MT == 1 ? 1 : (a.M + 15) / 16);
  fn<<<grid, kMmThreads, smem, a.stream>>>(
      tq, tx, a.scale, static_cast<TO*>(a.out), a.ws, a.tickets, a.M, a.K,
      a.N, a.gs, a.K / a.gs, a.kchunk, stages);
  return cudaGetLastError();
}

// one n8 tile of x's rows up to M 8, two (8 * MT = 16 rows a block) above
template <typename TX, typename TO>
cudaError_t dispatch_mm(int bits, const MmArgs& a, EncodeTiled enc) {
  if (bits == 8)
    return a.M <= 8 ? launch_mm<TX, TO, 8, 1>(a, enc)
                    : launch_mm<TX, TO, 8, 2>(a, enc);
  return a.M <= 8 ? launch_mm<TX, TO, 4, 1>(a, enc)
                  : launch_mm<TX, TO, 4, 2>(a, enc);
}

// ------------------------------------------------------ x @ W.T  (V, K)
template <typename TX, typename TO, int BITS, int MT, int ROWS>
__global__ void __launch_bounds__(kThreads)
    woq_matmul_t_kernel(const TX* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ scale, TO* __restrict__ out,
                        int M, int K, int V, int G, int gs) {
  static_assert(ROWS % 2 == 0, "int4 rows pair up");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v0 = (blockIdx.x * kWarps + warp) * ROWS;
  if (v0 >= V) return;
  const int m0 = blockIdx.y * MT;
  const bool vec = (K & 3) == 0;

  int grp[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) grp[r] = G == 1 ? 0 : min(v0 + r, V - 1) / gs;

  float acc[MT][ROWS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0.f;

  for (int k0 = lane * 4; k0 < K; k0 += 128) {
    float xv[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        xv[m][c] = (m0 + m < M && k0 + c < K)
                       ? to_f32(x[(size_t)(m0 + m) * K + k0 + c])
                       : 0.f;
    constexpr int NW = BITS == 8 ? ROWS : ROWS / 2;
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      // int8: row v0 + i; int4: packed row v0/2 + i (V rows v0 + 2i, +1)
      const int first = BITS == 8 ? v0 + i : v0 + 2 * i;
      const size_t qrow = BITS == 8 ? (size_t)(v0 + i) : (size_t)(v0 / 2 + i);
      w[i] = first < V ? load4(q + qrow * K, k0, K, vec) : 0u;
    }
    float s[4];
    int g_loaded = -1;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (grp[r] != g_loaded) {
        g_loaded = grp[r];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[c] = k0 + c < K ? scale[(size_t)g_loaded * K + k0 + c] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int qi;
        if constexpr (BITS == 8)
          qi = byte_at(w[r], c);
        else
          qi = (r & 1) ? nibble_hi(w[r / 2], c) : nibble_lo(w[r / 2], c);
        const float wd = round_to<TX>(__fmul_rn((float)qi, s[c]));
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][r] = fmaf(xv[m][c], wd, acc[m][r]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc[m][r] += __shfl_xor_sync(kFull, acc[m][r], off);
  // spread the stores over the lanes: lane (m * ROWS + r) % 32 writes
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (lane == ((m * ROWS + r) & 31) && m0 + m < M && v0 + r < V)
        out[(size_t)(m0 + m) * V + v0 + r] = from_f32<TO>(acc[m][r]);
}

template <typename TX, typename TO, int BITS, int MT, int ROWS>
cudaError_t launch_matmul_t(const void* x, const int8_t* q,
                            const float* scale, void* out, int M, int K,
                            int V, int gs, cudaStream_t st) {
  const int G = V / gs;
  const int rows_per_block = kWarps * ROWS;
  const dim3 grid((V + rows_per_block - 1) / rows_per_block,
                  (M + MT - 1) / MT);
  woq_matmul_t_kernel<TX, TO, BITS, MT, ROWS><<<grid, kThreads, 0, st>>>(
      static_cast<const TX*>(x), q, scale, static_cast<TO*>(out), M, K, V, G,
      gs);
  return cudaGetLastError();
}

// ----------------------------------------- x @ W.T on the tensor cores
constexpr int kMmaWarps = 8;                       // consumer warps
constexpr int kMmaThreads = (kMmaWarps + 1) * 32;  // and one producer warp
constexpr int kSpan = 128;            // k columns of one mma_span
constexpr int kStageK = kMmaWarps * kSpan;   // k columns of a stage
constexpr int kRowPad = 16;           // bytes after each staged row
constexpr int kRingBytes = 32 * 1024;   // with x's rows: 3 blocks an SM
constexpr int kRedBytes = 2 * kMmaWarps * 128 * 4;
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 227 * 1024;

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// the consumer warps' barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kMmaWarps * 32) : "memory");
}

// byte i of x (an int8 with its sign bit flipped, or a nibble plus 8) as
// the fp32 2^23 + byte, minus `offset`: exactly the signed integer
template <int I>
__device__ __forceinline__ float int_of(uint32_t x, float offset) {
  return __fsub_rn(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + I)),
                   offset);
}

// The A operand of one m16n8k16 product from a word of each of the lane's
// two rows (bytes 0..3: k 4j .. 4j + 3 of the lane's piece): q * s in
// fp32, rounded to TX, two values a cvt. a[0] / a[2]: row ra, a[1] / a[3]:
// row rb, fragment columns (2t, 2t+1) / (2t+8, 2t+9) holding k bytes 0, 1 /
// 2, 3. int8: ra, rb are the two rows' words (sign bits flipped); int4:
// one packed word, ra its low nibbles and rb its high ones (plus 8).
template <typename TX>
__device__ __forceinline__ void dequant(uint32_t (&a)[4], uint32_t ra,
                                        uint32_t rb, const float* s,
                                        float offset) {
  a[0] = pack(__fmul_rn(int_of<0>(ra, offset), s[0]),
              __fmul_rn(int_of<1>(ra, offset), s[1]), TX());
  a[1] = pack(__fmul_rn(int_of<0>(rb, offset), s[0]),
              __fmul_rn(int_of<1>(rb, offset), s[1]), TX());
  a[2] = pack(__fmul_rn(int_of<2>(ra, offset), s[2]),
              __fmul_rn(int_of<3>(ra, offset), s[3]), TX());
  a[3] = pack(__fmul_rn(int_of<2>(rb, offset), s[2]),
              __fmul_rn(int_of<3>(rb, offset), s[3]), TX());
}

// One warp's span of a stage: kSpan k columns (from stage column kw) of the
// 16-row tile, two 16-k pieces a lane, 4 products into each of acc[0] and
// acc[1] (two chains of dependent products instead of one). sk: the scale
// row at the stage's first column; xk: x's row there (rows past mt read
// nothing). FULL: every piece lies inside the stage's kn columns (no
// predicates). Staged rows are `pitch` = kc + 16 bytes apart, so a
// quarter warp's 16-byte reads at (gid, 32 t + 16 c) hit 8 distinct banks.
template <typename TX, int BITS, bool FULL>
__device__ __forceinline__ void mma_span(float (&acc)[2][4],
                                         const unsigned char* st, int pitch,
                                         const float* sk,
                                         const unsigned char* xk, bool xon,
                                         int kw, int kn, int gid, int tig) {
  constexpr float kOffset = BITS == 8 ? 8388736.0f : 8388616.0f;
  float sc[2][16];
  uint4 xa[2], xb[2], wa[2], wb[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int kk = kw + 32 * tig + 16 * c;   // this lane's 16 k (kn % 16 == 0)
    const bool on = FULL || kk < kn;
    const float4* sp = reinterpret_cast<const float4*>(sk + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = on ? __ldg(sp + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[c][4 * i] = v.x, sc[c][4 * i + 1] = v.y;
      sc[c][4 * i + 2] = v.z, sc[c][4 * i + 3] = v.w;
    }
    xa[c] = xb[c] = wa[c] = wb[c] = make_uint4(0, 0, 0, 0);
    if (on && xon) {
      xa[c] = lds128(xk + 2 * kk);
      xb[c] = lds128(xk + 2 * kk + 16);
    }
    if (on) {
      wa[c] = lds128(st + gid * pitch + kk);
      if constexpr (BITS == 8) wb[c] = lds128(st + (gid + 8) * pitch + kk);
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint32_t w[4] = {wa[c].x, wa[c].y, wa[c].z, wa[c].w};
    const uint32_t w2[4] = {wb[c].x, wb[c].y, wb[c].z, wb[c].w};
    const uint32_t bx[8] = {xa[c].x, xa[c].y, xa[c].z, xa[c].w,
                            xb[c].x, xb[c].y, xb[c].z, xb[c].w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t a[4];
      if constexpr (BITS == 8)
        dequant<TX>(a, w[jj] ^ 0x80808080u, w2[jj] ^ 0x80808080u,
                    sc[c] + 4 * jj, kOffset);
      else
        dequant<TX>(a, (w[jj] & 0x0F0F0F0Fu) ^ 0x08080808u,
                    ((w[jj] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                    sc[c] + 4 * jj, kOffset);
      const uint32_t b[2] = {bx[2 * jj], bx[2 * jj + 1]};
      mma(acc[c], a, b, TX());
    }
  }
}

// Shared memory: x's rows (xpitch = 2K + 16 bytes apart, xbytes in all),
// the ring (stages of stage_bytes: R staged rows of kc columns, kc + 16
// bytes apart, one bulk copy a row), two reduce buffers of 8 warps x 128
// fp32. A stage holds k columns [k0, k0 + kc) of a tile.
template <typename TX, typename TO, int BITS>
__global__ void __launch_bounds__(kMmaThreads, 3)
    woq_matmul_t_mma_kernel(const TX* __restrict__ x,
                            const int8_t* __restrict__ q,
                            const float* __restrict__ scale,
                            TO* __restrict__ out, int M, int K, int V, int G,
                            int gs, int kc, int stages, int stage_bytes,
                            int xpitch, int xbytes) {
  constexpr int R = BITS == 8 ? 16 : 8;   // staged rows of a 16-row tile
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * 8, mt = min(8, M - m0);
  const int ntiles = (V + 15) / 16, nkc = (K + kc - 1) / kc;
  unsigned char* xs = smem;
  unsigned char* ring = smem + xbytes;
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * stage_bytes);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kMmaWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kMmaWarps) {                 // the producer
    if (lane == 0) {
      int s = 0, used = 0;                 // used: the ring went round once
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int v0 = t * 16;
        const int rows = BITS == 8 ? min(16, V - v0) : min(8, (V - v0) / 2);
        const int8_t* src = q + (size_t)(BITS == 8 ? v0 : v0 / 2) * K;
        for (int j = 0; j < nkc; ++j) {
          if (used) mbar_wait(smem_u32(&empty[s]), phase ^ 1);
          const int k0 = j * kc, kn = min(kc, K - k0);
          const uint32_t bar = smem_u32(&full[s]);
          const uint32_t dst = smem_u32(ring + (size_t)s * stage_bytes);
          mbar_expect_tx(bar, (uint32_t)(rows * kn));
          for (int r = 0; r < rows; ++r)
            bulk_load(dst + r * (kc + kRowPad), src + (size_t)r * K + k0, kn,
                      bar);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
            used = 1;
          }
        }
      }
    }
    return;
  }

  // x's rows m0 .. m0 + mt, 16 bytes a load
  const int pieces = K / 8;
  for (int i = threadIdx.x; i < mt * pieces; i += kMmaWarps * 32) {
    const int r = i / pieces, c = i - r * pieces;
    *reinterpret_cast<uint4*>(xs + r * xpitch + c * 16) =
        __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K) + c);
  }
  consumers_sync();

  const int gid = lane >> 2, tig = lane & 3;
  const unsigned char* xrow = xs + gid * xpitch;
  int s = 0, nt = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++nt) {
    const int v0 = t * 16;
    const float* srow = scale + (size_t)(G == 1 ? 0 : v0 / gs) * K;
    float acc[2][4] = {};
    for (int j = 0; j < nkc; ++j) {
      const int k0 = j * kc, kn = min(kc, K - k0);
      const unsigned char* st = ring + (size_t)s * stage_bytes;
      mbar_wait(smem_u32(&full[s]), phase);
      // warp w takes spans w, w + 8, ... of the stage's columns
      for (int kw = warp * kSpan; kw < kn; kw += kMmaWarps * kSpan) {
        if (kw + kSpan <= kn)
          mma_span<TX, BITS, true>(acc, st, kc + kRowPad, srow + k0,
                                   xrow + 2 * k0,
                                   gid < mt, kw, kn, gid, tig);
        else
          mma_span<TX, BITS, false>(acc, st, kc + kRowPad, srow + k0,
                                    xrow + 2 * k0,
                                    gid < mt, kw, kn, gid, tig);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    // the warps' sums in warp order; the C fragment holds (row gid, cols
    // 2 tig, +1) and row gid + 8
    float* rb = red + (nt & 1) * (kMmaWarps * 128);
    *reinterpret_cast<float4*>(rb + warp * 128 + lane * 4) =
        make_float4(acc[0][0] + acc[1][0], acc[0][1] + acc[1][1],
                    acc[0][2] + acc[1][2], acc[0][3] + acc[1][3]);
    consumers_sync();
    if (threadIdx.x < 128) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) sum += rb[w * 128 + threadIdx.x];
      const int ln = threadIdx.x >> 2, i = threadIdx.x & 3;
      const int row = (ln >> 2) + 8 * (i >> 1), n = 2 * (ln & 3) + (i & 1);
      const int v = v0 + (BITS == 8 ? row : 2 * (row & 7) + (row >> 3));
      if (v < V && n < mt) out[(size_t)(m0 + n) * V + v] = from_f32<TO>(sum);
    }
  }
}

template <typename TX, typename TO, int BITS>
cudaError_t launch_matmul_t_mma(const void* x, const int8_t* q,
                                const float* scale, void* out, int M, int K,
                                int V, int gs, cudaStream_t st) {
  constexpr auto fn = woq_matmul_t_mma_kernel<TX, TO, BITS>;
  constexpr int R = BITS == 8 ? 16 : 8;
  const int xpitch = 2 * K + 16;
  const int xbytes = ((M < 8 ? M : 8) * xpitch + 127) / 128 * 128;
  const int kc = K < kStageK ? K : kStageK;
  const int stage_bytes = (R * (kc + kRowPad) + 127) / 128 * 128;
  int stages = kRingBytes / stage_bytes;
  stages = stages < 2 ? 2 : stages > kMaxStages ? kMaxStages : stages;
  const int smem = xbytes + stages * stage_bytes + kRedBytes;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = fit_smem<fn>(smem, kMmaThreads, &per_sm);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int ntiles = (V + 15) / 16;
  const dim3 grid(ntiles < per_sm * sms ? ntiles : per_sm * sms,
                  (M + 7) / 8);
  fn<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const TX*>(x), q, scale, static_cast<TO*>(out), M, K, V,
      V / gs, gs, kc, stages, stage_bytes, xpitch, xbytes);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch_matmul_t_mma(int bits, const void* x, const int8_t* q,
                                  const float* scale, void* out, int M, int K,
                                  int V, int gs, cudaStream_t st) {
  if (bits == 8)
    return launch_matmul_t_mma<TX, TO, 8>(x, q, scale, out, M, K, V, gs, st);
  return launch_matmul_t_mma<TX, TO, 4>(x, q, scale, out, M, K, V, gs, st);
}

// MT * ROWS accumulators per lane, at most 64
template <typename TX, typename TO, int BITS>
cudaError_t dispatch_matmul_t_m(const void* x, const int8_t* q,
                                const float* scale, void* out, int M, int K,
                                int V, int gs, cudaStream_t st) {
  if (M == 1)
    return launch_matmul_t<TX, TO, BITS, 1, 16>(x, q, scale, out, M, K, V,
                                                gs, st);
  if (M <= 4)
    return launch_matmul_t<TX, TO, BITS, 4, 16>(x, q, scale, out, M, K, V,
                                                gs, st);
  return launch_matmul_t<TX, TO, BITS, 8, 8>(x, q, scale, out, M, K, V, gs,
                                             st);
}

template <typename TX, typename TO>
cudaError_t dispatch_matmul_t_bits(int bits, const void* x, const int8_t* q,
                                   const float* scale, void* out, int M,
                                   int K, int V, int gs, cudaStream_t st) {
  if (bits == 8)
    return dispatch_matmul_t_m<TX, TO, 8>(x, q, scale, out, M, K, V, gs, st);
  return dispatch_matmul_t_m<TX, TO, 4>(x, q, scale, out, M, K, V, gs, st);
}

bool bad_common(int M, int K, int cols, int gs, int bits, int rows) {
  return M <= 0 || K <= 0 || cols <= 0 || gs <= 0 || rows % gs != 0 ||
         (bits != 8 && bits != 4) || (bits == 4 && gs % 2 != 0);
}

}  // namespace

// x: (M, K) of dtype x_dtype (0 fp32, 1 fp16, 2 bf16); q: (K, N) int8 or
// (K/2, N) packed int4; scale: (G, N) fp32, G = K / gs; out: (M, N) of
// out_dtype (x_dtype or 0). ws: (splits, M, N) fp32 scratch when splits > 1.
extern "C" int dstpu_woq_matmul(const void* x, const void* q,
                                const void* scale, void* out, void* ws,
                                int M, int K, int N, int gs, int bits,
                                int x_dtype, int out_dtype, int splits,
                                void* stream) {
  const int G = gs > 0 ? K / gs : 0;
  if (bad_common(M, K, N, gs, bits, K) || splits < 1 || splits > G ||
      splits > 65535 || M > 65535 * 8 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 0 && out_dtype == 0)
    e = dispatch_matmul_bits<float, float>(bits, x, qq, ss, out, w, M, K, N,
                                           gs, splits, st);
  else if (x_dtype == 1 && out_dtype == 1)
    e = dispatch_matmul_bits<__half, __half>(bits, x, qq, ss, out, w, M, K,
                                             N, gs, splits, st);
  else if (x_dtype == 1 && out_dtype == 0)
    e = dispatch_matmul_bits<__half, float>(bits, x, qq, ss, out, w, M, K, N,
                                            gs, splits, st);
  else if (x_dtype == 2 && out_dtype == 2)
    e = dispatch_matmul_bits<__nv_bfloat16, __nv_bfloat16>(
        bits, x, qq, ss, out, w, M, K, N, gs, splits, st);
  else if (x_dtype == 2 && out_dtype == 0)
    e = dispatch_matmul_bits<__nv_bfloat16, float>(bits, x, qq, ss, out, w,
                                                   M, K, N, gs, splits, st);
  return static_cast<int>(e);
}

// The tensor-core x @ W. x: (M, K) fp16 / bf16 (x_dtype 1 / 2); q: (K, N)
// int8 or (K/2, N) packed int4; scale: (G, N) fp32; out: (M, N) of
// out_dtype (x_dtype or 0); N % 16 == 0, K % 16 == 0, gs % 16 == 0 when G >
// 1; x, q, scale and out 16-byte aligned. Split s covers k [s * kchunk,
// (s + 1) * kchunk) (kchunk a multiple of 16, and of gs when G > 1);
// splits > 1 needs ws, (splits, M, N) fp32, and tickets, ceil(N / 128) *
// ceil(M / 16) int32 zeroed before the first call (each call leaves them
// zero). ring_bytes: the ring's shared memory (whole stages, 2 to 8).
extern "C" int dstpu_woq_matmul_mma(const void* x, const void* q,
                                    const void* scale, void* out, void* ws,
                                    void* tickets, int M, int K, int N,
                                    int gs, int bits, int x_dtype,
                                    int out_dtype, int kchunk, int splits,
                                    int ring_bytes, void* stream) {
  const int G = gs > 0 ? K / gs : 0;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
      reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out);
  if (bad_common(M, K, N, gs, bits, K) || N % 16 != 0 || K % 16 != 0 ||
      (G > 1 && gs % 16 != 0) || (align & 15) != 0 ||
      (x_dtype != 1 && x_dtype != 2) ||
      (out_dtype != 0 && out_dtype != x_dtype) || kchunk <= 0 ||
      kchunk % 16 != 0 || (G > 1 && kchunk % gs != 0) || splits < 1 ||
      splits > 65535 || (long long)splits * kchunk < K ||
      (long long)(splits - 1) * kchunk >= K || (M + 15) / 16 > 65535 ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const MmArgs a{x, q, static_cast<const float*>(scale), out,
                 static_cast<float*>(ws), static_cast<int*>(tickets), M, K,
                 N, gs, kchunk, splits, ring_bytes, x_dtype,
                 static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (x_dtype == 1)
    e = out_dtype == 0 ? dispatch_mm<__half, float>(bits, a, enc)
                       : dispatch_mm<__half, __half>(bits, a, enc);
  else
    e = out_dtype == 0 ? dispatch_mm<__nv_bfloat16, float>(bits, a, enc)
                       : dispatch_mm<__nv_bfloat16, __nv_bfloat16>(bits, a,
                                                                   enc);
  return static_cast<int>(e);
}

// x: (M, K) fp16 / bf16 (x_dtype 1 / 2), K % 16 == 0; q: (V, K) int8 or
// (V/2, K) packed int4; scale: (G, K) fp32, G = V / gs, gs % 16 == 0 when
// G > 1; out: (M, V) of out_dtype (x_dtype or 0). x, q and scale 16-byte
// aligned.
extern "C" int dstpu_woq_matmul_t_mma(const void* x, const void* q,
                                      const void* scale, void* out, int M,
                                      int K, int V, int gs, int bits,
                                      int x_dtype, int out_dtype,
                                      void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(scale);
  if (bad_common(M, K, V, gs, bits, V) || (bits == 4 && V % 2 != 0) ||
      K % 16 != 0 || (V / gs > 1 && gs % 16 != 0) || (align & 15) != 0 ||
      M > 65535 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 1 && out_dtype == 1)
    e = dispatch_matmul_t_mma<__half, __half>(bits, x, qq, ss, out, M, K, V,
                                              gs, st);
  else if (x_dtype == 1 && out_dtype == 0)
    e = dispatch_matmul_t_mma<__half, float>(bits, x, qq, ss, out, M, K, V,
                                             gs, st);
  else if (x_dtype == 2 && out_dtype == 2)
    e = dispatch_matmul_t_mma<__nv_bfloat16, __nv_bfloat16>(
        bits, x, qq, ss, out, M, K, V, gs, st);
  else if (x_dtype == 2 && out_dtype == 0)
    e = dispatch_matmul_t_mma<__nv_bfloat16, float>(bits, x, qq, ss, out, M,
                                                    K, V, gs, st);
  return static_cast<int>(e);
}

// x: (M, K); q: (V, K) int8 or (V/2, K) packed int4; scale: (G, K) fp32,
// G = V / gs; out: (M, V) of out_dtype (x_dtype or 0).
extern "C" int dstpu_woq_matmul_t(const void* x, const void* q,
                                  const void* scale, void* out, int M, int K,
                                  int V, int gs, int bits, int x_dtype,
                                  int out_dtype, void* stream) {
  if (bad_common(M, K, V, gs, bits, V) || (bits == 4 && V % 2 != 0) ||
      M > 65535 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 0 && out_dtype == 0)
    e = dispatch_matmul_t_bits<float, float>(bits, x, qq, ss, out, M, K, V,
                                             gs, st);
  else if (x_dtype == 1 && out_dtype == 1)
    e = dispatch_matmul_t_bits<__half, __half>(bits, x, qq, ss, out, M, K, V,
                                               gs, st);
  else if (x_dtype == 1 && out_dtype == 0)
    e = dispatch_matmul_t_bits<__half, float>(bits, x, qq, ss, out, M, K, V,
                                              gs, st);
  else if (x_dtype == 2 && out_dtype == 2)
    e = dispatch_matmul_t_bits<__nv_bfloat16, __nv_bfloat16>(
        bits, x, qq, ss, out, M, K, V, gs, st);
  else if (x_dtype == 2 && out_dtype == 0)
    e = dispatch_matmul_t_bits<__nv_bfloat16, float>(bits, x, qq, ss, out, M,
                                                     K, V, gs, st);
  return static_cast<int>(e);
}
