// The forward of the fused softmax cross-entropy over the unembedding on
// Hopper (sm_90a): bf16 operands, fp32 accumulation, tensor cores through
// wgmma (m64n256k16, both operands read from shared memory).
//
// Replaces the TPU kernel of deepspeed_tpu/ops/xent.py:
//   xent_fwd <- _fwd_kernel (:49), its `partials` mode included.
// The backward (dx, dW and db in one call) is xent_bwd_sm90.cu.
//
// Function (the rounding points of the Pallas kernel): x is (T, d), W is
// (V, d) in the embedding table's layout, bias (V,) in x's dtype or null,
// targets (T,) int32.
//   logits = x . W^T in fp32 from the bf16 operands, plus float(bias);
//   columns >= V count as BIG_NEG = -1e30: probability 0, never a target;
//   m = max, s = sum exp(logits - m), tgt = the target's logit or 0 when the
//   target lies outside [0, V); nll = m + log(s) - tgt and lse = m + log(s);
//   with `partials` the outputs are tgt and m + log(max(s, 1e-30)), the
//   shard-local pair a vocab-sharded caller combines.
// No (T, V) tensor reaches device memory; no atomics, so results repeat bit
// for bit.
//
// Bound (GPT-2 1.5B's head: T 4092, V 50257, d 1600): the product's 2 T V d
// FLOPs at 989 TFLOP/s, far above the bytes of x and W read once at 3.35
// TB/s: bound by operations. chip_smoke.py prints both terms for each call
// it times.
//
// Design. A block of two warpgroups forms a 128 x 256 tile of x . W^T, each
// warpgroup 64 rows of it, with the long contraction d streamed through
// shared memory in chunks of 64: cp.async into 4 stages of tiles in wgmma's
// 128-byte swizzle, three chunks in flight. Loads past an operand's rows or
// past d are zero-filled, so T, V and d need not divide anything, d % 16 ==
// 0 aside. What limits the step is the operands' way from L2 to shared
// memory, so the tile is wgmma's widest (85 flop a byte). The grid is (token
// tiles, vocab splits); each thread keeps its own running (m, s, tgt) over
// the columns it sees, the block merges them once per row at the end, and a
// second small kernel merges the splits in order and writes the outputs.
//
// C interface (ctypes): dstpu_xent_fwd returns cudaGetLastError() after its
// launches, or cudaErrorInvalidValue for what it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps: two warpgroups of 64 tile rows each
constexpr int kBM = 128;       // rows of a logits tile
constexpr int kBNF = 256;      // columns of a logits tile
constexpr int kKC = 64;        // contraction chunk staged in shared memory
constexpr int kRowB = kKC * 2; // bytes of an operand tile's row: one 128-byte
                               //   swizzle row
constexpr int kNS = 4;         // stages of the operands' pipeline
constexpr float kBigNeg = -1e30f;  // BIG_NEG of the JAX kernels

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are in flight, then a block barrier
template <int N>
__device__ __forceinline__ void cp_async_wait_sync() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
  __syncthreads();
}

// rows [r0, r0 + ROWS) x columns [c0, c0 + 64) of a row-major (n, d) matrix
// into an operand tile for wgmma: rows of 128 bytes, the 16-byte chunk c of
// row r stored at chunk c ^ (r & 7) (the 128-byte swizzle), the tile aligned
// to 1024 bytes. Rows >= n and columns >= d are zero-filled. A thread keeps
// its chunk and walks the rows 32 apart, so r & 7 is its own too.
template <int ROWS>
__device__ __forceinline__ void load_operand(unsigned char* sm,
                                             const bf16* __restrict__ g, int r0,
                                             int n, int c0, int d) {
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const bool cin = c0 + c * 8 < d;
  const bf16* src = g + (size_t)(r0 + r) * d + c0 + c * 8;
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(sm)) +
                       r * kRowB + ((c ^ (r & 7)) << 4);
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const bool valid = cin && r0 + r + i * 32 < n;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst + i * 32 * kRowB), "l"(src + (size_t)i * 32 * d),
                    "r"(valid ? 16 : 0));
  }
}

// the shared-memory matrix descriptor of a K-major operand tile in the
// 128-byte swizzle: start address, leading offset 16 (unused by this
// layout), 1024 bytes between groups of 8 rows, each in units of 16 bytes
__device__ __forceinline__ uint64_t operand_desc(const unsigned char* p) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (uint64_t{16 >> 4} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// s += A . B^T for a warpgroup: A 64 rows x 16 k, B 256 rows x 16 k, both
// read from shared memory through their descriptors (K-major). The trailing
// operands: accumulate into s, A and B unnegated, neither transposed.
__device__ __forceinline__ void wgmma_k16(float (&s)[32][4], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 0;\n"
      : "+f"(s[0][0]), "+f"(s[0][1]), "+f"(s[0][2]), "+f"(s[0][3]),
        "+f"(s[1][0]), "+f"(s[1][1]), "+f"(s[1][2]), "+f"(s[1][3]),
        "+f"(s[2][0]), "+f"(s[2][1]), "+f"(s[2][2]), "+f"(s[2][3]),
        "+f"(s[3][0]), "+f"(s[3][1]), "+f"(s[3][2]), "+f"(s[3][3]),
        "+f"(s[4][0]), "+f"(s[4][1]), "+f"(s[4][2]), "+f"(s[4][3]),
        "+f"(s[5][0]), "+f"(s[5][1]), "+f"(s[5][2]), "+f"(s[5][3]),
        "+f"(s[6][0]), "+f"(s[6][1]), "+f"(s[6][2]), "+f"(s[6][3]),
        "+f"(s[7][0]), "+f"(s[7][1]), "+f"(s[7][2]), "+f"(s[7][3]),
        "+f"(s[8][0]), "+f"(s[8][1]), "+f"(s[8][2]), "+f"(s[8][3]),
        "+f"(s[9][0]), "+f"(s[9][1]), "+f"(s[9][2]), "+f"(s[9][3]),
        "+f"(s[10][0]), "+f"(s[10][1]), "+f"(s[10][2]), "+f"(s[10][3]),
        "+f"(s[11][0]), "+f"(s[11][1]), "+f"(s[11][2]), "+f"(s[11][3]),
        "+f"(s[12][0]), "+f"(s[12][1]), "+f"(s[12][2]), "+f"(s[12][3]),
        "+f"(s[13][0]), "+f"(s[13][1]), "+f"(s[13][2]), "+f"(s[13][3]),
        "+f"(s[14][0]), "+f"(s[14][1]), "+f"(s[14][2]), "+f"(s[14][3]),
        "+f"(s[15][0]), "+f"(s[15][1]), "+f"(s[15][2]), "+f"(s[15][3]),
        "+f"(s[16][0]), "+f"(s[16][1]), "+f"(s[16][2]), "+f"(s[16][3]),
        "+f"(s[17][0]), "+f"(s[17][1]), "+f"(s[17][2]), "+f"(s[17][3]),
        "+f"(s[18][0]), "+f"(s[18][1]), "+f"(s[18][2]), "+f"(s[18][3]),
        "+f"(s[19][0]), "+f"(s[19][1]), "+f"(s[19][2]), "+f"(s[19][3]),
        "+f"(s[20][0]), "+f"(s[20][1]), "+f"(s[20][2]), "+f"(s[20][3]),
        "+f"(s[21][0]), "+f"(s[21][1]), "+f"(s[21][2]), "+f"(s[21][3]),
        "+f"(s[22][0]), "+f"(s[22][1]), "+f"(s[22][2]), "+f"(s[22][3]),
        "+f"(s[23][0]), "+f"(s[23][1]), "+f"(s[23][2]), "+f"(s[23][3]),
        "+f"(s[24][0]), "+f"(s[24][1]), "+f"(s[24][2]), "+f"(s[24][3]),
        "+f"(s[25][0]), "+f"(s[25][1]), "+f"(s[25][2]), "+f"(s[25][3]),
        "+f"(s[26][0]), "+f"(s[26][1]), "+f"(s[26][2]), "+f"(s[26][3]),
        "+f"(s[27][0]), "+f"(s[27][1]), "+f"(s[27][2]), "+f"(s[27][3]),
        "+f"(s[28][0]), "+f"(s[28][1]), "+f"(s[28][2]), "+f"(s[28][3]),
        "+f"(s[29][0]), "+f"(s[29][1]), "+f"(s[29][2]), "+f"(s[29][3]),
        "+f"(s[30][0]), "+f"(s[30][1]), "+f"(s[30][2]), "+f"(s[30][3]),
        "+f"(s[31][0]), "+f"(s[31][1]), "+f"(s[31][2]), "+f"(s[31][3])
      : "l"(da), "l"(db));
}

// s[j][e] = sum over d of R[r0 + row][.] * C[c0 + col][.] for the thread's
// part of the block's 128 x BN tile: each of the two warpgroups forms 64
// rows with wgmma m64nBNk16, and the thread of warp w (0-3 within the
// group), lane 4 g + t holds rows 16 w + g (e = 0, 1) and + 8 (e = 2, 3),
// columns 8 j + 2 t + (e & 1). Both operands stream through kNS stages of
// swizzled tiles, kNS - 1 chunks in flight and one block barrier a chunk.
// Ends with a barrier: the stages are free.
template <int BN>
__device__ __forceinline__ void logits_tile(
    float (&s)[BN / 8][4], const bf16* __restrict__ rowop, int r0, int nR,
    const bf16* __restrict__ colop, int c0, int nC, int d,
    unsigned char* stages) {
  constexpr int kStage = (kBM + BN) * kRowB;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const int nk = (d + kKC - 1) / kKC;
  // every step commits one group, empty past the last chunk, so that chunk
  // kc is whole once at most kNS - 2 later groups are in flight
#pragma unroll
  for (int i = 0; i < kNS - 1; ++i) {
    if (i < nk) {
      unsigned char* st = stages + i * kStage;
      load_operand<kBM>(st, rowop, r0, nR, i * kKC, d);
      load_operand<BN>(st + kBM * kRowB, colop, c0, nC, i * kKC, d);
    }
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    // chunk kc has landed and is made visible to the tensor cores' reads;
    // every warp is done with chunk kc - 1, whose stage the next copy
    // overwrites
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kNS - 2));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kc + kNS - 1 < nk) {
      unsigned char* st = stages + ((kc + kNS - 1) % kNS) * kStage;
      load_operand<kBM>(st, rowop, r0, nR, (kc + kNS - 1) * kKC, d);
      load_operand<BN>(st + kBM * kRowB, colop, c0, nC, (kc + kNS - 1) * kKC,
                        d);
    }
    cp_async_commit();
    const unsigned char* sR = stages + (kc % kNS) * kStage + wg * 64 * kRowB;
    const unsigned char* sC = stages + (kc % kNS) * kStage + kBM * kRowB;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16)   // 16 k are 32 bytes along the row
      wgmma_k16(s, operand_desc(sR + kk * 2), operand_desc(sC + kk * 2));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  cp_async_wait_sync<0>();  // only empty groups are left; the stages are free
}

// ------------------------------------------------------------------ forward
// part: (3, nsplit, T) fp32: each split's per-token m, s and target logit.
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, const int* __restrict__ tgt,
                    float* __restrict__ part, int T, int V, int d, int per,
                    int nsplit) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int r0 = blockIdx.x * kBM, split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rowbase = warp * 16;   // the thread's rows: rowbase + g, + 8
  int tg[2];
  float m[2], l[2], hit[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + rowbase + g + 8 * h;
    tg[h] = row < T ? tgt[row] : -1;
    m[h] = kBigNeg;
    l[h] = hit[h] = 0.f;
  }
  const int ntv = (V + kBNF - 1) / kBNF;
  const int jt1 = min(ntv, (split + 1) * per);
  for (int jt = split * per; jt < jt1; ++jt) {
    const int c0 = jt * kBNF;
    float s[kBNF / 8][4];
    logits_tile<kBNF>(s, x, r0, T, w, c0, V, d, smem);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBNF / 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = c0 + j * 8 + 2 * t + b;
        const bool in = col < V;
        const float bv = bias != nullptr && in ? __bfloat162float(bias[col]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = in ? s[j][2 * h + b] + bv : kBigNeg;
          s[j][2 * h + b] = v;
          mx[h] = fmaxf(mx[h], v);
          if (col == tg[h] && in) hit[h] += v;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBNF / 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = c0 + j * 8 + 2 * t + b;
          sum += col < V ? __expf(s[j][2 * h + b] - mx[h]) : 0.f;
        }
      l[h] = l[h] * __expf(m[h] - mx[h]) + sum;
      m[h] = mx[h];
    }
  }
  // merge the 4 partial states of each row (its 4 lanes) in a fixed order;
  // the stages are free after the last tile's barrier
  float* red = reinterpret_cast<float*>(smem);          // (kBM, 4, 3)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* p = red + ((rowbase + g + 8 * h) * 4 + t) * 3;
    p[0] = m[h];
    p[1] = l[h];
    p[2] = hit[h];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM; i += kThreads) {
    if (r0 + i >= T) continue;
    const float* p = red + i * 12;
    float M = kBigNeg, S = 0.f, H = 0.f;
    for (int k = 0; k < 4; ++k) M = fmaxf(M, p[3 * k]);
    for (int k = 0; k < 4; ++k) {
      S += p[3 * k + 1] * expf(p[3 * k] - M);
      H += p[3 * k + 2];
    }
    const size_t o = (size_t)split * T + r0 + i, plane = (size_t)nsplit * T;
    part[o] = M;
    part[plane + o] = S;
    part[2 * plane + o] = H;
  }
}

// merge the vocab splits of each token in order and write the outputs:
// (nll, lse), or with `partials` (target logit, m + log(max(s, 1e-30)))
__global__ void xent_fwd_merge_kernel(const float* __restrict__ part,
                                      float* __restrict__ out0,
                                      float* __restrict__ out1, int T,
                                      int nsplit, int partials) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const size_t plane = (size_t)nsplit * T;
  float M = kBigNeg, S = 0.f, H = 0.f;
  for (int k = 0; k < nsplit; ++k) M = fmaxf(M, part[(size_t)k * T + i]);
  for (int k = 0; k < nsplit; ++k) {
    const size_t o = (size_t)k * T + i;
    S += part[plane + o] * expf(part[o] - M);
    H += part[2 * plane + o];
  }
  if (partials) {
    out0[i] = H;
    out1[i] = M + logf(fmaxf(S, 1e-30f));
  } else {
    const float lse = M + logf(S);
    out0[i] = lse - H;
    out1[i] = lse;
  }
}

bool shapes_ok(int T, int V, int d) {
  return T > 0 && V > 0 && d > 0 && d % 16 == 0;
}

}  // namespace

// x (T, d), w (V, d), bias (V,) or null: bf16; tgt (T,) int32; part (3,
// nsplit, T) fp32 scratch; out0 / out1 (T,) fp32: nll and lse, or with
// `partials` the target logit and the shard-local m + log(max(s, 1e-30)).
// nsplit vocab splits, none of them empty.
extern "C" int dstpu_xent_fwd(const void* x, const void* w, const void* bias,
                              const int* tgt, float* part, float* out0,
                              float* out1, int T, int V, int d, int nsplit,
                              int partials, void* stream) {
  constexpr int BM = kBM;
  const int ntv = (V + kBNF - 1) / kBNF;
  if (!shapes_ok(T, V, d) || nsplit < 1 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (ntv + nsplit - 1) / nsplit;
  if ((nsplit - 1) * per >= ntv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t stage = kNS * (BM + kBNF) * kRowB;
  const size_t redb = BM * 12 * sizeof(float);
  const size_t smem = stage > redb ? stage : redb;
  auto fn = xent_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3((T + BM - 1) / BM, nsplit), kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), tgt, part, T, V, d, per, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_fwd_merge_kernel<<<(T + 255) / 256, 256, 0, st>>>(part, out0, out1, T,
                                                         nsplit, partials);
  return static_cast<int>(cudaGetLastError());
}
