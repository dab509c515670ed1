// Tensor-core tile products shared by the attention kernels
// (flash_attention.cu, sparse_attention.cu): mma.sync m16n8k16 with bf16 /
// fp16 operands and fp32 accumulation, fragments through ldmatrix from
// shared tiles whose rows are padded by 16 bytes (HD + 8 elements, so the
// fragment loads are free of bank conflicts), cp.async group helpers and
// the quad reductions of a C fragment's row. flash_fwd_sm90.cu takes the
// packing, the quad reductions and BIG_NEG (a wgmma accumulator fragment
// has the C fragment's layout, warp by warp).
//
// A warp owns 16 rows of its block's tile and multiplies them against a
// 64-row tile of the other operand: gemm_rows forms the (16, 64) score tile
// in C fragments, gemm_p feeds such a tile back as the A operand of the
// product with a 64-row tile read transposed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                  // rows of every streamed tile
constexpr float kBigNeg = -1073741824.0f;  // -2**30, BIG_NEG of the JAX kernels

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to T, the lower index in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 16-bit matrices from shared memory, lane l giving the address
// of row (l & 7) of matrix (l >> 3); r[i] holds this lane's two elements of
// matrix i: (row lane/4, cols 2(lane%4), +1), or with TRANS the transpose
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// one 16-byte cp.async from global to shared; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are in flight, then a block barrier
template <int N>
__device__ __forceinline__ void cp_async_wait_sync() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
  __syncthreads();
}

// c[j][e] = sum_d A[row][d] * B[key][d] for a warp's 16 rows of A (sA points
// at its first row) against the 64 rows of B: the C fragment of n-tile j
// holds (row g, keys 8j + 2t, +1) in e = 0, 1 and row g + 8 in e = 2, 3.
// Fragments come through ldmatrix: lane l addresses row l & 7 of 8x8
// matrix l >> 3.
template <typename T, int HD>
__device__ __forceinline__ void gemm_rows(float (&c)[8][4], const T* sA,
                                          const T* sB, int lane) {
  constexpr int LD = HD + 8;
  const int r = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];     // rows 0-7 / 8-15 by mi & 1, cols kk / kk + 8 by mi >> 1
    ldsm_x4<false>(a, sA + ((mi & 1) * 8 + r) * LD + kk + (mi >> 1) * 8);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];   // n-tile j + (mi >> 1), cols kk / kk + 8 by mi & 1
      ldsm_x4<false>(b, sB + ((j + (mi >> 1)) * 8 + r) * LD + kk +
                            (mi & 1) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma(c[j], a, b0, T());
      mma(c[j + 1], a, b1, T());
    }
  }
}

// acc[n][e] += sum_key P[row][key] * B[key][d]: P is a score tile in the C
// layout of gemm_rows (rounded to T here, the A operand), B the 64 shared
// rows of V, dO, K or Q, read transposed by ldmatrix.
template <typename T, int HD>
__device__ __forceinline__ void gemm_p(float (&acc)[HD / 8][4],
                                       const float (&p)[8][4], const T* sB,
                                       int lane) {
  constexpr int LD = HD + 8;
  const int r = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t a[4] = {pack(p[2 * c][0], p[2 * c][1], T()),
                           pack(p[2 * c][2], p[2 * c][3], T()),
                           pack(p[2 * c + 1][0], p[2 * c + 1][1], T()),
                           pack(p[2 * c + 1][2], p[2 * c + 1][3], T())};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];   // keys 16c + 0-7 / 8-15 by mi & 1, n-tile n + (mi >> 1)
      ldsm_x4<true>(b, sB + (16 * c + (mi & 1) * 8 + r) * LD +
                           (n + (mi >> 1)) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma(acc[n], a, b0, T());
      mma(acc[n + 1], a, b1, T());
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
