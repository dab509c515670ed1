// The fp32 building blocks of the 3xTF32 attention kernels on Hopper
// (sm_90a), shared by the fp32 forward (flash_fwd_f32_sm90.cu) and the fp32
// backward pair (flash_bwd_f32_sm90.cuh): the geometry of their units and
// streamed tiles, the split of an fp32 tile into its tf32 high part (TMA's
// tile as it lies) and low part, the transposed copies tf32 needs (wgmma's
// tf32 takes both shared-memory operands K-major: it has no transpose bit),
// the split of an accumulator fragment into A fragments, the tf32 wgmma
// products and the 3xTF32 sums over them, and the fp32 tensor maps. What
// each piece relies on is held on the card by the probes of
// flash_bwd_dq_f32_sm90.cu (tests/test_torch_gpu.py -k tf32).

#pragma once

#include "sm90.cuh"

namespace {

// ------------------------------------------------------------ geometry
constexpr int kFUnit = 64;       // rows of a unit: queries (forward, dq),
                                 // keys (dk/dv)
constexpr int kFStep = 32;       // rows of a streamed tile: keys (forward,
                                 // dq), queries (dk/dv)
constexpr int kFThreads = 256;   // producer / converter group + a consumer one
constexpr int kFConverters = 3;  // converter warps: warps 1-3
constexpr int kF32TStages = 2;   // slots of the ring of transposed halves
template <int HD> constexpr int kFUnitB = kFUnit * HD * 4;   // a unit tile
template <int HD> constexpr int kFStepB = kFStep * HD * 4;   // a streamed tile

// ------------------------------------------------------------ tiles
// Every fp32 tile is 128-byte rows (32 fp32) in the 128-byte swizzle: the
// 16-byte chunk c of row r at chunk c ^ (r & 7), each panel 1024-byte
// aligned. A natural tile of R rows and hd columns (TMA's layout) is hd /
// 32 panels of R rows; a transposed tile is one panel of hd rows, row n
// holding column n of a 32-row tile, its entries in pos() order.
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ ((o >> 3) & 0x70u);
}

// the k position of row j of a 32-row tile in its transposed copy: in each
// group of 8, row 2t at t and row 2t + 1 at t + 4 (the A fragment's order)
__device__ __forceinline__ uint32_t pos(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}

// the matrix descriptor of a K-major fp32 tile at `addr`: 128-byte swizzle,
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t fdesc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}
// a natural tile of R rows at contraction offset kk (a multiple of 8)
template <int R>
__device__ __forceinline__ uint64_t nat_desc(uint32_t tile, int kk) {
  return fdesc(tile + (kk / 32) * R * 128 + (kk % 32) * 4);
}

// x = hi + lo for the tensor cores, which read only a tf32 operand's top 19
// bits (tests/test_torch_gpu.py checks it on the card): hi is x itself
// (read as x with its low 13 bits cleared), lo = x - that, exact in fp32
// (read as tf32 in turn, its own low bits dropped)
__device__ __forceinline__ uint32_t low_part(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u));
}

// the low parts of a natural tile of `bytes` at p (TMA's values, which
// serve as the high parts as they are) into lo (the same layout): 16 bytes
// a thread in turn, four loads in flight
__device__ __forceinline__ void lo_tile(const unsigned char* __restrict__ p,
                                        unsigned char* __restrict__ lo,
                                        int bytes, int tid, int nthreads) {
  for (int o0 = tid * 16; o0 < bytes; o0 += 4 * nthreads * 16) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = o0 + u * nthreads * 16;
      if (o < bytes) x[u] = *reinterpret_cast<const float4*>(p + o);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = o0 + u * nthreads * 16;
      if (o < bytes)
        *reinterpret_cast<uint4*>(lo + o) =
            make_uint4(low_part(x[u].x), low_part(x[u].y), low_part(x[u].z),
                       low_part(x[u].w));
    }
  }
}

// the transposed copies t_hi / t_lo of a 32-row natural tile at p (TMA's
// values): row n holds column n, its 32 entries in pos() order, hi the
// values as they are and lo their low parts. lane = row; the NW warps (w
// the caller's) take the 16-byte column chunks in turn, each warp's loads
// first; a store fills one row of the transposed tile, free of bank
// conflicts
template <int HD, int NW>
__device__ __forceinline__ void transpose_step(
    const unsigned char* __restrict__ p, unsigned char* __restrict__ t_hi,
    unsigned char* __restrict__ t_lo, int w, int lane) {
  constexpr int NC = HD / 4, U = (NC + NW - 1) / NW;
  const uint32_t tp = pos(lane) * 4;
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c4 = w + u * NW;
    if (c4 < NC)
      v[u] = *reinterpret_cast<const float4*>(
          p + (c4 / 8) * (kFStep * 128) + swz(lane * 128 + (c4 & 7) * 16));
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c4 = w + u * NW;
    if (c4 < NC) {
      const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t to = swz((4 * c4 + e) * 128 + tp);
        *reinterpret_cast<uint32_t*>(t_hi + to) = __float_as_uint(x[e]);
        *reinterpret_cast<uint32_t*>(t_lo + to) = low_part(x[e]);
      }
    }
  }
}

// the converters' writes are for wgmma (the async proxy): fence them, then
// one arrival a warp on `bar`
__device__ __forceinline__ void publish(uint32_t bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ------------------------------------------------------------ wgmma, tf32
// d (m64 x N fp32, wgmma's accumulator fragment) [+]= A . B for 8 k, tf32
// operands (no transpose flags: both K-major). wgmma_tf32 with two
// descriptors: A and B from shared memory; with a fragment: A from
// registers, a[0..3] = (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// of the warp's 16 rows. accumulate 0 writes d and reads nothing of it.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d = A . B^T over HD (A the 64-row natural tile a_hi / a_lo, B the 32-row
// one b_hi / b_lo), 3xTF32; writes d
template <int HD>
__device__ __forceinline__ void ss3(float (&d)[4][4], uint32_t a_hi,
                                    uint32_t a_lo, uint32_t b_hi,
                                    uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8)
    wgmma_tf32(d, nat_desc<kFUnit>(a_lo, kk), nat_desc<kFStep>(b_hi, kk),
               kk > 0);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8)
    wgmma_tf32(d, nat_desc<kFUnit>(a_hi, kk), nat_desc<kFStep>(b_lo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8)
    wgmma_tf32(d, nat_desc<kFUnit>(a_hi, kk), nat_desc<kFStep>(b_hi, kk), 1);
}

// d [+]= X . T over the 32 rows of a streamed tile: X's A fragments (hi,
// lo; chunk c its k positions 8c .. 8c + 7 in pos() order), T the tile's
// transposed copy t_hi / t_lo; 3xTF32, writes d unless `accumulate`
template <int NJ>
__device__ __forceinline__ void rs3(float (&d)[NJ][4],
                                    const uint32_t (&hi)[4][4],
                                    const uint32_t (&lo)[4][4],
                                    uint32_t t_hi, uint32_t t_lo,
                                    int accumulate) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wgmma_tf32(d, lo[c], fdesc(t_hi + c * 32), accumulate || c > 0);
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_tf32(d, hi[c], fdesc(t_lo + c * 32), 1);
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_tf32(d, hi[c], fdesc(t_hi + c * 32), 1);
}

// the accumulator fragment x (64 x 32: warp rows g, g + 8, columns 8c + 2t,
// + 1) as A fragments of its 32 columns, hi (the values) and lo (their low
// parts): chunk c's k position t holds column 8c + 2t and t + 4 column 8c +
// 2t + 1 (pos())
__device__ __forceinline__ void split_frags(const float (&x)[4][4],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float y[4] = {x[c][0], x[c][2], x[c][1], x[c][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // hi cleared explicitly (the value the tensor cores read): registers
      // of their own, not the accumulator's (ptxas serializes a wgmma whose
      // A fragment aliases them, C7511)
      hi[c][e] = __float_as_uint(y[e]) & 0xFFFFE000u;
      lo[c][e] = __float_as_uint(y[e] - __uint_as_float(hi[c][e]));
    }
  }
}

// the tensor map of a contiguous (B, S, heads, hd) fp32 tensor as 4-D (hd,
// heads, S, B), boxes of one head's `rows` rows by 32 columns, in the
// 128-byte swizzle
bool encode_f32(EncodeTiled fn, CUtensorMap* map, const void* p, int B, int S,
                int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 4,
                                 (cuuint64_t)heads * hd * 4,
                                 (cuuint64_t)S * heads * hd * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
