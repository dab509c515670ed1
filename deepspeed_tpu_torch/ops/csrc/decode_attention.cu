// Decode attention on Hopper (sm_90a): one query token per (row, head)
// against a heads-major KV cache, reading only each row's live positions.
//
// Replaces the TPU kernel deepspeed_tpu/ops/decode_attention.py:_decode_kernel
// (one Pallas program per (batch, head) streaming the cache through VMEM with
// an online softmax). Same function: softmax((q/sqrt(hd)) . k_s + alibi_s) . v
// over slots s < L_b, fp32 accumulation, a row with L_b = 0 gives exactly 0.
//
// Bound. A (b, kv head) reads L_b*hd elements of K and of V and does 4*hd
// flops per position per query head: 1 flop/byte in bf16 for MHA (G query
// heads per KV head: G flop/byte), far under the H100's ~295 flop/byte ridge.
// It is bound by bytes: (live K + V bytes + q + out) / 3.35 TB/s.
//
// Design, against that bound:
// - one block per (b, kv head, chunk of up to GB query heads of the group):
//   every K/V row is read once from device memory and used for all the query
//   heads of the chunk; GQA/MQA map query head h to KV head h / G by index,
//   the cache is never repeated;
// - 8 warps; warp w takes positions w*U, w*U+1, ... in strides of 8*U and
//   loads U rows of K and U of V at once (U*EPL*2 values in flight per lane);
//   each lane holds EPL contiguous elements of a row, one vector load each;
// - the dot product over hd is a warp butterfly (shuffle) reduction;
// - each warp keeps its own fp32 online softmax (m, l, acc) over its
//   positions, so the loop has no block barrier; the 8 partial states merge
//   once through shared memory at the end;
// - only positions < L_b are read: the loop ends at the live length.
// Split-K over blocks (flash-decoding), TMA and wgmma are later work.
//
// C interface (ctypes): dstpu_decode_attention returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kBigNeg = -1073741824.0f;  // -2**30, BIG_NEG of decode.py

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// EPL contiguous elements of one row, moved as one vector (at most 16 bytes
// a load; fp32 with EPL = 8 is two).
template <typename T, int EPL>
struct alignas(sizeof(T) * EPL > 16 ? 16 : sizeof(T) * EPL) Pack {
  T v[EPL];
};

template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[EPL]) {
  const Pack<T, EPL> r = *reinterpret_cast<const Pack<T, EPL>*>(p);
#pragma unroll
  for (int i = 0; i < EPL; ++i) out[i] = to_f32(r.v[i]);
}

// EPL: elements of a row per lane (hd <= 32*EPL). GB: query heads per block.
template <typename T, int EPL, int GB>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q,
                            const T* __restrict__ ck,
                            const T* __restrict__ cv,
                            const int* __restrict__ lengths, int len_stride,
                            const float* __restrict__ slopes,
                            T* __restrict__ out, int H, int KV, int S, int hd,
                            float scale) {
  constexpr int U = 16 / EPL;  // rows of K (and of V) a warp loads at once
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * EPL;
  const bool lane_on = d0 < hd;
  const int L_raw = lengths[b * len_stride];
  const int L = min(max(L_raw, 0), S);

  int head[GB];
  bool head_on[GB];
  float qf[GB][EPL], slope[GB], m[GB], l[GB], acc[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    head_on[g] = chunk * GB + g < G;
    head[g] = kvh * G + chunk * GB + g;
    slope[g] = (slopes != nullptr && head_on[g]) ? slopes[head[g]] : 0.f;
    m[g] = kBigNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) qf[g][i] = acc[g][i] = 0.f;
    if (head_on[g] && lane_on) {
      load_row<T, EPL>(q + ((size_t)b * H + head[g]) * hd + d0, qf[g]);
#pragma unroll
      for (int i = 0; i < EPL; ++i) qf[g][i] *= scale;
    }
  }

  const size_t row0 = ((size_t)b * KV + kvh) * S;
  for (int base = warp * U; base < L; base += kWarps * U) {
    float kr[U][EPL], vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u < L && lane_on) {
        const size_t off = (row0 + base + u) * hd + d0;
        load_row<T, EPL>(ck + off, kr[u]);
        load_row<T, EPL>(cv + off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    float s[GB][U];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) dot = fmaf(qf[g][i], kr[u][i], dot);
        s[g][u] = dot;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u < L) {
          s[g][u] += slope[g] * (float)(base + u - (L_raw - 1));
          mx = fmaxf(mx, s[g][u]);
        }
      }
      const float corr = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = base + u < L ? expf(s[g][u] - mx) : 0.f;
        psum += s[g][u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float a = acc[g][i] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(s[g][u], vr[u][i], a);
        acc[g][i] = a;
      }
      m[g] = mx;
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][GB], sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][32 * EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GB * hd; idx += kThreads) {
    const int g = idx / hd, d = idx - g * hd;
    if (chunk * GB + g >= G) continue;
    float mx = kBigNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den = fmaf(sm_l[w][g], c, den);
      num = fmaf(sm_acc[w][g][d], c, num);
    }
    const int h = kvh * G + chunk * GB + g;
    out[((size_t)b * H + h) * hd + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int EPL, int GB>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const int* lengths, int len_stride, const float* slopes,
                   void* out, int B, int H, int KV, int S, int hd, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid((G + GB - 1) / GB, KV, B);
  decode_attention_kernel<T, EPL, GB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), lengths, len_stride, slopes,
      static_cast<T*>(out), H, KV, S, hd, scale);
  return cudaGetLastError();
}

// Query heads per block: the group size rounded up to a power of two, at
// most 8, and GB*EPL <= 32 so the merge buffer stays within 32 KB.
template <typename T, int EPL>
cudaError_t dispatch_group(int G, const void* q, const void* ck,
                           const void* cv, const int* lengths, int len_stride,
                           const float* slopes, void* out, int B, int H, int KV,
                           int S, int hd, float scale, cudaStream_t stream) {
  constexpr int kMaxGB = 32 / EPL < 8 ? 32 / EPL : 8;
  int gb = 1;
  while (gb < G && gb < kMaxGB) gb *= 2;
#define DSTPU_LAUNCH(GB_)                                                    \
  return launch<T, EPL, GB_>(q, ck, cv, lengths, len_stride, slopes, out, B, \
                             H, KV, S, hd, scale, stream)
  switch (gb) {
    case 1: DSTPU_LAUNCH(1);
    case 2: DSTPU_LAUNCH(2);
    case 4: DSTPU_LAUNCH(4);
    default:
      if constexpr (kMaxGB >= 8) {
        DSTPU_LAUNCH(8);
      } else {
        return cudaErrorInvalidValue;
      }
  }
#undef DSTPU_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* ck, const void* cv,
                     const int* lengths, int len_stride, const float* slopes,
                     void* out, int B, int H, int KV, int S, int hd,
                     float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (hd <= 64)
    return dispatch_group<T, 2>(G, q, ck, cv, lengths, len_stride, slopes,
                                out, B, H, KV, S, hd, scale, stream);
  if (hd <= 128)
    return dispatch_group<T, 4>(G, q, ck, cv, lengths, len_stride, slopes,
                                out, B, H, KV, S, hd, scale, stream);
  return dispatch_group<T, 8>(G, q, ck, cv, lengths, len_stride, slopes, out,
                              B, H, KV, S, hd, scale, stream);
}

}  // namespace

// q, out: (B, 1, H, hd); ck, cv: (B, KV, S, hd); all contiguous, one dtype
// (0 fp32, 1 fp16, 2 bf16). lengths: int32, lengths[b * len_stride] (stride 0
// broadcasts one length). slopes: (H,) fp32 ALiBi slopes or null.
extern "C" int dstpu_decode_attention(const void* q, const void* ck,
                                      const void* cv, const int* lengths,
                                      int len_stride, const float* slopes,
                                      void* out, int B, int H, int KV, int S,
                                      int hd, int dtype, float scale,
                                      void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || hd <= 0 ||
      hd > 256 || hd % 8 != 0 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<float>(q, ck, cv, lengths, len_stride,
                                              slopes, out, B, H, KV, S, hd,
                                              scale, st));
    case 1:
      return static_cast<int>(dispatch<__half>(q, ck, cv, lengths, len_stride,
                                               slopes, out, B, H, KV, S, hd,
                                               scale, st));
    case 2:
      return static_cast<int>(dispatch<__nv_bfloat16>(
          q, ck, cv, lengths, len_stride, slopes, out, B, H, KV, S, hd, scale,
          st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
