// Flash attention's dk/dv kernel for bf16 / fp16 operands at hd 32-128 on
// Hopper: wgmma, TMA and a producer warp. The kernel, what it replaces and
// how it is laid out: flash_bwd_sm90.cuh.

#include "flash_bwd_sm90.cuh"

namespace {

template <typename T, int HD, bool BIAS>
struct Dkv {
  static cudaError_t run(const BwdArgs& a, EncodeTiled enc) {
    return launch_dkv<T, HD, BIAS>(a, enc);
  }
};

}  // namespace

// The arguments of the mma.sync library's dstpu_flash_bwd_dkv. dk, dv:
// (B, S, KV, hd), each KV head the sum over its group of query heads; lse
// and delta must be 16-byte aligned, as q, k, v and dout.
extern "C" int dstpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, const uint8_t* mask,
                                   const float* slopes, const void* bias,
                                   void* dk, void* dv, int B, int S, int H,
                                   int KV, int hd, int causal, int dtype,
                                   int bias_dtype, long long bias_sb,
                                   long long bias_sh, float scale,
                                   void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, mask, slopes,
                  Bias{bias, bias_sb, bias_sh, bias_dtype}, nullptr, dk, dv,
                  nullptr, B, S, H, KV, hd, causal, dtype, scale,
                  static_cast<cudaStream_t>(stream)};
  return bwd_dispatch<Dkv>(a);
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build).
extern "C" int dstpu_flash_bwd_dkv_smem_bytes(int hd) {
  switch (hd) {
    case 32: return dkv_smem_bytes<32>();
    case 64: return dkv_smem_bytes<64>();
    case 128: return dkv_smem_bytes<128>();
    default: return 0;
  }
}
