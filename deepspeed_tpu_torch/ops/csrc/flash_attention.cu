// Flash attention's bf16 / fp16 mma.sync kernels at hd 16, with and
// without the additive bias: the forward, dq and dk/dv (at hd 32-128 they
// are flash_fwd_sm90.cu's and flash_bwd_sm90.cuh's). The kernels, what they
// replace and how they are laid out: flash_attention.cuh.

#include "flash_attention.cuh"

namespace {

int run(int which, int hd, int dtype, const Args& a) {
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return static_cast<int>(dispatch_hd<__half>(which, hd, a));
  if (dtype == 2)
    return static_cast<int>(dispatch_hd<__nv_bfloat16>(which, hd, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
