// Flash attention's dq kernel (dbias included) for bf16 / fp16 operands at
// hd 32-128 on Hopper: wgmma, TMA and a producer warp. The kernel, what it
// replaces and how it is laid out: flash_bwd_sm90.cuh.

#include "flash_bwd_sm90.cuh"

namespace {

template <typename T, int HD, bool BIAS>
struct Dq {
  static cudaError_t run(const BwdArgs& a, EncodeTiled enc) {
    return launch_dq<T, HD, BIAS>(a, enc);
  }
};

}  // namespace

// The arguments of the mma.sync library's dstpu_flash_bwd_dq. dtype and
// bias_dtype: 1 fp16, 2 bf16, 3 fp32 (the bias only); dout, dq (B, S, H,
// hd); lse, delta (B, H, S) fp32; dbias: null, or a contiguous (B, H, S, S)
// tensor of the bias's dtype, every element written. q, k, v, dout must be
// 16-byte aligned.
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
  return bwd_dispatch<Dq>(a);
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build): what chip_smoke.py prints beside ptxas's registers.
extern "C" int dstpu_flash_bwd_dq_smem_bytes(int hd) {
  switch (hd) {
    case 32: return dq_smem_bytes<32>();
    case 64: return dq_smem_bytes<64>();
    case 128: return dq_smem_bytes<128>();
    default: return 0;
  }
}
