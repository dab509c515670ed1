// Flash attention's dq kernel (dbias included) for fp32 operands at hd 32
// and 64 on Hopper: 3xTF32 products on wgmma, TMA, a producer warp and
// converter warps. The kernel, what it replaces and how it is laid out:
// flash_bwd_f32_sm90.cuh.

#include "flash_bwd_f32_sm90.cuh"

namespace {

template <int HD, bool BIAS>
struct DqF32 {
  static cudaError_t run(const BwdArgs& a, EncodeTiled enc) {
    return launch_dq_f32<HD, BIAS>(a, enc);
  }
};

// One-product checks of the header's layout assumptions, for the card
// tests (one warpgroup). a (64, 32) and b (32, 32) are row-major fp32; d
// (64, 32).
// RAW: d = a . b^T, a and b copied as they are into K-major tiles (the raw
//   values a TMA tile holds), one product over the 32 columns: the same
//   bits as the call on a and b with their low 13 bits cleared iff the
//   tensor cores read only a tf32 operand's top 19 bits.
// !RAW: d = a . b, a taken from wgmma's accumulator layout into A
//   fragments by split_frags(), b a natural tile transposed with its low
//   parts by transpose_step(): the 3xTF32 product the gradient products
//   run, within ~1e-6 of the fp64 product iff the fragment order and pos()
//   agree.
template <bool RAW>
__global__ void __launch_bounds__(128, 1)
    flash_bwd_f32_probe_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ d) {
  __shared__ unsigned char sm[1024 + 8192 + 3 * 4096];
  const uint32_t raw = smem_u32(sm);
  const uint32_t sA = (raw + 1023) & ~1023u;
  const uint32_t sB = sA + 8192, sTh = sB + 4096, sTl = sTh + 4096;
  auto gen = [&](uint32_t x) { return sm + (x - raw); };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 64 * 32; i += 128)
    *reinterpret_cast<float*>(gen(sA + swz((i / 32) * 128 + (i % 32) * 4))) =
        a[i];
  for (int i = tid; i < 32 * 32; i += 128)
    *reinterpret_cast<float*>(gen(sB + swz((i / 32) * 128 + (i % 32) * 4))) =
        b[i];
  __syncthreads();
  float acc[4][4];
  if constexpr (RAW) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8)
      wgmma_tf32(acc, nat_desc<kFUnit>(sA, kk), nat_desc<kFStep>(sB, kk),
                 kk > 0);
  } else {
    transpose_step<32, 4>(gen(sB), gen(sTh), gen(sTl), warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    float x[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[j][e] = a[(16 * warp + g + 8 * (e >> 1)) * 32 + 8 * j + 2 * t +
                    (e & 1)];
    uint32_t hi[4][4], lo[4][4];
    split_frags(x, hi, lo);
    wgmma_fence();
    rs3(acc, hi, lo, sTh, sTl, 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(16 * warp + g + 8 * (e >> 1)) * 32 + 8 * j + 2 * t + (e & 1)] =
          acc[j][e];
}

}  // namespace

// The arguments of the mma.sync library's dstpu_flash_bwd_dq (dtype 3:
// fp32); bias_dtype: 1 fp16, 2 bf16, 3 fp32. q, k, v, dout must be 16-byte
// aligned.
extern "C" int dstpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const uint8_t* mask,
                                  const float* slopes, const void* bias,
                                  void* dq, void* dbias, int B, int S, int H,
                                  int KV, int hd, int causal, int dtype,
                                  int bias_dtype, long long bias_sb,
                                  long long bias_sh, float scale,
                                  void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, mask, slopes,
                  Bias{bias, bias_sb, bias_sh, bias_dtype}, dq, nullptr,
                  nullptr, dbias, B, S, H, KV, hd, causal, dtype, scale,
                  static_cast<cudaStream_t>(stream)};
  return f32_dispatch<DqF32>(a);
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build): ops/flash_attention.py flash_bwd_f32_plan() must agree.
extern "C" int dstpu_flash_bwd_dq_smem_bytes(int hd) {
  switch (hd) {
    case 32: return dq_f32_smem_bytes<32>();
    case 64: return dq_f32_smem_bytes<64>();
    default: return 0;
  }
}

// The one-product layout checks of flash_bwd_f32_probe_kernel (which 0:
// RAW, 1: the fragments): a (64, 32), b (32, 32), d (64, 32) fp32 on the
// card.
extern "C" int dstpu_flash_bwd_f32_probe(int which, const float* a,
                                         const float* b, float* d,
                                         void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (which == 0)
    flash_bwd_f32_probe_kernel<true><<<1, 128, 0, st>>>(a, b, d);
  else
    flash_bwd_f32_probe_kernel<false><<<1, 128, 0, st>>>(a, b, d);
  return static_cast<int>(cudaGetLastError());
}
