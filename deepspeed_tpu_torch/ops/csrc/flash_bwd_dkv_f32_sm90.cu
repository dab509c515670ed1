// Flash attention's dk/dv kernel for fp32 operands at hd 32 and 64 on
// Hopper: 3xTF32 products on wgmma, TMA, a producer warp and converter
// warps. The kernel, what it replaces and how it is laid out:
// flash_bwd_f32_sm90.cuh.

#include "flash_bwd_f32_sm90.cuh"

namespace {

template <int HD, bool BIAS>
struct DkvF32 {
  static cudaError_t run(const BwdArgs& a, EncodeTiled enc) {
    return launch_dkv_f32<HD, BIAS>(a, enc);
  }
};

}  // namespace

// The arguments of the mma.sync library's dstpu_flash_bwd_dkv (dtype 3:
// fp32). dk, dv: (B, S, KV, hd), each KV head the sum over its group of
// query heads; q, k, v, dout 16-byte aligned.
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
  return f32_dispatch<DkvF32>(a);
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build): ops/flash_attention.py flash_bwd_f32_plan() must agree.
extern "C" int dstpu_flash_bwd_dkv_smem_bytes(int hd) {
  switch (hd) {
    case 32: return dkv_f32_smem_bytes<32>();
    case 64: return dkv_f32_smem_bytes<64>();
    default: return 0;
  }
}
