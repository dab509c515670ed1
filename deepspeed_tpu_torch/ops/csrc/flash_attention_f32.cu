// Flash attention's fp32 kernels (3xTF32 products), with and without the
// additive bias (the kernels, what they replace and how they are laid out:
// flash_attention.cuh).

#include "flash_attention.cuh"

namespace {

int run(int which, int hd, int dtype, const Args& a) {
  if (!args_ok(a) || dtype != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_hd<float>(which, hd, a));
}

}  // namespace
