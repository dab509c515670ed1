// Block-sparse attention's dk/dv kernel for bf16 / fp16 operands at blocks
// 64 and 128, hd 32-128 on Hopper: wgmma, TMA and producer warps walking the
// CSR lists. The kernel, what it replaces and how it is laid out:
// sparse_bwd_sm90.cuh.

#include "sparse_bwd_sm90.cuh"

namespace {

template <typename T, int HD>
struct Dkv {
  static cudaError_t run(const SparseBwdArgs& a, EncodeTiled enc) {
    return launch_sparse_dkv<T, HD>(a, enc);
  }
};

}  // namespace

// The arguments of sparse_attention.cu's dstpu_sparse_bwd_dkv. dk, dv:
// (B, S, KV, hd), each KV head the sum over its group of query heads;
// q_idx (nk, A) / q_n (nk,): the q-blocks that keep each k-block; order
// (nk,): the k-blocks widest list first. lse and delta must be 16-byte
// aligned, as q, k, v and dout (their rows come in by 1-D bulk copies).
extern "C" int dstpu_sparse_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, const int* q_idx,
                                    const int* q_n, const int* order, int A,
                                    int B, int S, int H, int KV, int hd,
                                    int block, int causal, int dtype,
                                    float scale, void* stream) {
  const SparseBwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv,
                        q_idx, q_n, order, A, B, S, H, KV, hd, block, causal,
                        dtype, scale, static_cast<cudaStream_t>(stream)};
  return sparse_bwd_dispatch<Dkv>(a);
}

// Dynamic shared memory of the kernel at head dim hd (0 for one it does not
// build): ops/sparse_attention.py sparse_bwd_plan() must agree.
extern "C" int dstpu_sparse_bwd_dkv_smem_bytes(int hd) {
  switch (hd) {
    case 32: return sparse_dkv_smem_bytes<32>();
    case 64: return sparse_dkv_smem_bytes<64>();
    case 128: return sparse_dkv_smem_bytes<128>();
    default: return 0;
  }
}
