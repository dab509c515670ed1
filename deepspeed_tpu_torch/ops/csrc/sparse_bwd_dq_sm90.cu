// Block-sparse attention's dq kernel for bf16 / fp16 operands at blocks 64
// and 128, hd 32-128 on Hopper: wgmma, TMA and producer warps walking the
// CSR lists. The kernel, what it replaces and how it is laid out:
// sparse_bwd_sm90.cuh.

#include "sparse_bwd_sm90.cuh"

namespace {

template <typename T, int HD>
struct Dq {
  static cudaError_t run(const SparseBwdArgs& a, EncodeTiled enc) {
    return launch_sparse_dq<T, HD>(a, enc);
  }
};

}  // namespace

// The arguments of sparse_attention.cu's dstpu_sparse_bwd_dq. dtype: 1
// fp16, 2 bf16; dout, dq (B, S, H, hd); lse, delta (B, H, S) fp32; k_idx
// (nq, A) / k_n (nq,) int32: the kept k-blocks of each q-block; order
// (nq,) int32: the q-blocks widest list first. q, k, v, dout must be
// 16-byte aligned.
extern "C" int dstpu_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq,
                                   const int* k_idx, const int* k_n,
                                   const int* order, int A, int B, int S,
                                   int H, int KV, int hd, int block,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  const SparseBwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                        k_idx, k_n, order, A, B, S, H, KV, hd, block, causal,
                        dtype, scale, static_cast<cudaStream_t>(stream)};
  return sparse_bwd_dispatch<Dq>(a);
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build): ops/sparse_attention.py sparse_bwd_plan() must agree.
extern "C" int dstpu_sparse_bwd_dq_smem_bytes(int hd) {
  switch (hd) {
    case 32: return sparse_dq_smem_bytes<32>();
    case 64: return sparse_dq_smem_bytes<64>();
    case 128: return sparse_dq_smem_bytes<128>();
    default: return 0;
  }
}
