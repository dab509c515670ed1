// Decode attention on Hopper (sm_90a): one query token per (row, head)
// against a heads-major KV cache, reading only each row's live positions,
// split over the cache (flash-decoding).
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
// - split-K: a block owns one (b, kv head, chunk of up to GB query heads of
//   the group) and one range of `chunk` cache positions; the grid is
//   (nsplit, KV * chunks, B). The wrapper sizes the split from B, KV, the
//   head chunks, S and the SM count (never from the lengths: reading them
//   back would sync every layer), so the grid fills the card several blocks
//   deep. Each K/V row is read once and used for all the query heads of the
//   chunk; GQA / MQA map query head h to KV head h / G by index;
// - a block streams its range through a ring of kStages shared-memory
//   stages: one (b, kv head) run of T positions of K is one contiguous run
//   of T*hd*esize bytes, and likewise of V, so each stage is two 1-D bulk
//   copies (cp.async.bulk, no tensor map) completing one mbarrier; only
//   live rows are copied (the last tile's byte count is (end - start) rows).
//   hd*esize is a multiple of 16 for every head dim taken (hd % 8 == 0) and
//   the wrapper checks 16-byte alignment, so every copy is aligned. Up to
//   kStages tiles are in flight: 64 KB a block in 16-bit, 3 blocks an SM;
// - 8 warps compute from shared memory: warp w takes U positions of each
//   tile, a lane holds EPL contiguous elements of a row; the GB x U dot
//   products over hd are one reduce-scatter (N - 1 shuffles for N = 32
//   values, where a butterfly each took 5 N), after which each lane runs
//   the fp32 online softmax of the scores it holds and hands the
//   probabilities through a per-warp scratch to every lane for p . V; each
//   warp keeps its own state (m, l, acc), and the warps' states merge in
//   warp order through shared memory at the end;
// - with more than one split, a block writes its fp32 partial (m, l and the
//   unnormalised acc) to a workspace and takes a ticket; the last block of a
//   (b, kv head, head chunk) to finish merges the partials of the live
//   splits in split order and resets the ticket for the next call. A split
//   that starts at or past L_b copies and writes nothing: the merge knows
//   from L_b which splits are live. No partial is summed by atomics, so the
//   result does not change from run to run.
//
// C interface (ctypes): dstpu_decode_attention returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"   // mbarriers, bulk copies, fit_smem

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kMergeBatch = 8;   // partials a thread loads at once
constexpr int kMaxSplits = 256;  // the merge keeps (m, l) of each in smem
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
__device__ __forceinline__ void load_row(const T* p, float (&out)[EPL]) {
  const Pack<T, EPL> r = *reinterpret_cast<const Pack<T, EPL>*>(p);
#pragma unroll
  for (int i = 0; i < EPL; ++i) out[i] = to_f32(r.v[i]);
}

// Reduce-scatter of N per-lane partial sums over the warp: afterwards each
// lane holds, in v[0 .. KEEP), the warp-wide sums of KEEP of the N values
// (KEEP = max(1, N / 32)): values l * KEEP + j for N >= 32, value
// l >> (5 - log2 N) for N < 32 (then 32 / N lanes hold each). A halving
// step trades half of a lane's values with its partner: N - 1 shuffles for
// N = 32 where a butterfly per value takes 5 N.
template <int N, int CNT, int OFF>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (OFF >= 1) {
    constexpr int KEEP = N >= 32 ? N / 32 : 1;
    if constexpr (CNT > KEEP) {
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < CNT / 2; ++i) {
        const float send = up ? v[i] : v[i + CNT / 2];
        const float keep = up ? v[i + CNT / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<N, CNT / 2, OFF / 2>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < CNT; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
      reduce_scatter<N, CNT, OFF / 2>(v, lane);
    }
  }
}

// positions a warp takes from each tile, and a tile's positions
template <int EPL> constexpr int kU = 16 / EPL;
template <int EPL> constexpr int kTileRows = kWarps * kU<EPL>;

// the merge's shared buffers, laid over the ring once every tile is used
template <int EPL, int GB>
struct Merge {
  float m[kWarps][GB], l[kWarps][GB];
  float acc[kWarps][GB][32 * EPL];
};

template <typename T, int EPL>
constexpr size_t ring_bytes(int hd) {
  return (size_t)kStages * 2 * kTileRows<EPL> * hd * sizeof(T);
}

// EPL: elements of a row per lane (hd <= 32*EPL). GB: query heads per block.
template <typename T, int EPL, int GB>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                            const T* __restrict__ cv,
                            const int* __restrict__ lengths, int len_stride,
                            const float* __restrict__ slopes,
                            T* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ tickets, int H, int KV, int S,
                            int hd, int nch, int chunk, float scale) {
  constexpr int U = kU<EPL>, TR = kTileRows<EPL>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int last;

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y / nch, hc = blockIdx.y - kvh * nch;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * EPL;
  const bool lane_on = d0 < hd;
  const int L_raw = lengths[b * len_stride];
  const int L = min(max(L_raw, 0), S);
  const int start = split * chunk;
  const int end = min(start + chunk, L);
  const int ntiles = end > start ? (end - start + TR - 1) / TR : 0;
  const size_t row_bytes = (size_t)hd * sizeof(T);
  const size_t run0 = ((size_t)b * KV + kvh) * S;   // first row of (b, kvh)

  // stage s: K rows at smem + s * 2 * TR * row_bytes, then V rows
  auto issue = [&](int i) {
    const int s = i % kStages;
    const int rows = min(TR, end - (start + i * TR));
    const uint32_t bytes = (uint32_t)(rows * row_bytes);
    const uint32_t bar = smem_u32(&full[s]);
    const uint32_t dst = smem_u32(smem + (size_t)s * 2 * TR * row_bytes);
    const size_t off = (run0 + start + (size_t)i * TR) * hd;
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(dst, ck + off, bytes, bar);
    bulk_load(dst + (uint32_t)(TR * row_bytes), cv + off, bytes, bar);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_init_fence();
    for (int i = 0; i < min(kStages, ntiles); ++i) issue(i);
  }
  __syncthreads();

  // The scores of a tile are GB heads x U positions, N values a warp; after
  // the reduce-scatter a lane holds KEEP of them, all of one head (own_g):
  // lanes [g * HL, (g + 1) * HL) hold head g's, each value on RL lanes. A
  // lane keeps its head's online softmax (m, l); a per-warp scratch hands
  // the probabilities and the rescale factors to every lane for p . V.
  constexpr int N = GB * U, KEEP = N >= 32 ? N / 32 : 1;
  constexpr int HL = 32 / GB, RL = N >= 32 ? 1 : 32 / N;
  __shared__ __align__(16) float scratch[kWarps][N + GB];
  const int idx0 = N >= 32 ? lane * KEEP : lane / RL;   // first value held
  const int own_g = idx0 / U;
  float qf[GB][EPL], acc[GB][EPL];
  float m = kBigNeg, l = 0.f;
  const bool own_on = hc * GB + own_g < G;
  const float slope = (slopes != nullptr && own_on)
                          ? slopes[kvh * G + hc * GB + own_g] : 0.f;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const bool on = hc * GB + g < G;
#pragma unroll
    for (int i = 0; i < EPL; ++i) qf[g][i] = acc[g][i] = 0.f;
    if (on && lane_on && ntiles > 0) {
      load_row<T, EPL>(q + ((size_t)b * H + kvh * G + hc * GB + g) * hd + d0,
                       qf[g]);
#pragma unroll
      for (int i = 0; i < EPL; ++i) qf[g][i] *= scale;
    }
  }

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    mbar_wait(smem_u32(&full[s]), (i / kStages) & 1);
    const T* kt = reinterpret_cast<const T*>(smem + (size_t)s * 2 * TR *
                                                        row_bytes);
    const T* vt = kt + (size_t)TR * hd;
    const int base = start + i * TR;        // position of the tile's row 0
    const int r0 = warp * U;
    float kr[U][EPL], vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + r0 + u < end && lane_on) {
        load_row<T, EPL>(kt + (size_t)(r0 + u) * hd + d0, kr[u]);
        load_row<T, EPL>(vt + (size_t)(r0 + u) * hd + d0, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float v[N];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qf[g][e], kr[u][e], dot);
        v[g * U + u] = dot;
      }
    reduce_scatter<N, N, 16>(v, lane);
    // this lane's scores: its head's online softmax over the tile
    float mx = kBigNeg;
    bool live[KEEP];
#pragma unroll
    for (int j = 0; j < KEEP; ++j) {
      const int pos = base + r0 + (idx0 + j) % U;
      live[j] = pos < end;
      if (live[j]) {
        v[j] += slope * (float)(pos - (L_raw - 1));
        mx = fmaxf(mx, v[j]);
      }
    }
#pragma unroll
    for (int o = RL; o < HL; o *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mx = fmaxf(m, mx);
    const float corr = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KEEP; ++j) {
      v[j] = live[j] ? expf(v[j] - mx) : 0.f;
      psum += v[j];
    }
#pragma unroll
    for (int o = RL; o < HL; o *= 2)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
    m = mx;
    float* pw = scratch[warp];
    if (lane % RL == 0) {
#pragma unroll
      for (int j = 0; j < KEEP; ++j) pw[idx0 + j] = v[j];
    }
    if (lane % HL == 0) pw[N + own_g] = corr;
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float c = pw[N + g];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * c;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(pw[g * U + u], vr[u][e], a);
        acc[g][e] = a;
      }
    }
    __syncthreads();                     // every warp is done with stage s
    if (threadIdx.x == 0 && i + kStages < ntiles) issue(i + kStages);
  }

  // this block's state: the warps' states merged in warp order (the ring
  // is free: every tile issued was waited for and used)
  const size_t p0 = ((size_t)b * H + kvh * G + hc * GB) * nsplit;
  float* ws_acc = ws;                              // (B, H, nsplit, hd)
  float* ws_ml = ws + (size_t)gridDim.z * H * nsplit * hd;  // (.., 2)
  if (ntiles > 0 || nsplit == 1) {
    auto& mg = *reinterpret_cast<Merge<EPL, GB>*>(smem);
    if (lane % HL == 0) {
      mg.m[warp][own_g] = m;
      mg.l[warp][own_g] = l;
    }
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) mg.acc[warp][g][d0 + e] = acc[g][e];
    __syncthreads();
    for (int idx = threadIdx.x; idx < GB * hd; idx += kThreads) {
      const int g = idx / hd, d = idx - g * hd;
      if (hc * GB + g >= G) continue;
      float mx = kBigNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mg.m[w][g]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(mg.m[w][g] - mx);
        den = fmaf(mg.l[w][g], c, den);
        num = fmaf(mg.acc[w][g][d], c, num);
      }
      if (nsplit == 1) {
        const int h = kvh * G + hc * GB + g;
        out[((size_t)b * H + h) * hd + d] =
            from_f32<T>(num / fmaxf(den, 1e-30f));
      } else {
        const size_t p = p0 + (size_t)g * nsplit + split;
        ws_acc[p * hd + d] = num;
        if (d == 0) {
          ws_ml[2 * p] = mx;
          ws_ml[2 * p + 1] = den;
        }
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (b, kv head, head chunk) merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* t = tickets + (size_t)b * gridDim.y + blockIdx.y;
    last = atomicAdd(t, 1) == nsplit - 1;
    if (last) *t = 0;                      // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the live splits' (m, l) of each head into shared memory (the ring is
  // free), then each head's max, denominator and split weights in split
  // order, then the outputs, every thread's loads issued kMergeBatch at a
  // time: the partials sit in L2, and a load a step would serialize them
  const int live = (L + chunk - 1) / chunk;  // splits that hold positions
  float* sm = reinterpret_cast<float*>(smem);     // (GB, live): m, then l
  float* sl = sm + GB * live;
  __shared__ float den_g[GB];
  for (int i = threadIdx.x; i < GB * live; i += kThreads) {
    const int g = i / live, s = i - g * live;
    const size_t p = p0 + (size_t)g * nsplit + s;
    sm[i] = __ldcg(ws_ml + 2 * p);
    sl[i] = __ldcg(ws_ml + 2 * p + 1);
  }
  __syncthreads();
  if (threadIdx.x < GB) {
    const int g = threadIdx.x;
    float mx = kBigNeg, den = 0.f;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, sm[g * live + s]);
    for (int s = 0; s < live; ++s) {
      const float c = expf(sm[g * live + s] - mx);
      den = fmaf(sl[g * live + s], c, den);
      sm[g * live + s] = c;                 // now the split's weight
    }
    den_g[g] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GB * hd; idx += kThreads) {
    const int g = idx / hd, d = idx - g * hd;
    if (hc * GB + g >= G) continue;
    const float* a = ws_acc + (p0 + (size_t)g * nsplit) * hd + d;
    float num = 0.f;
    for (int s0 = 0; s0 < live; s0 += kMergeBatch) {
      float v[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j)
        v[j] = s0 + j < live ? __ldcg(a + (size_t)(s0 + j) * hd) : 0.f;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j)
        if (s0 + j < live) num = fmaf(v[j], sm[g * live + s0 + j], num);
    }
    const int h = kvh * G + hc * GB + g;
    out[((size_t)b * H + h) * hd + d] = from_f32<T>(num / den_g[g]);
  }
}

struct Args {
  const void *q, *ck, *cv;
  const int* lengths;
  int len_stride;
  const float* slopes;
  void* out;
  float* ws;
  int* tickets;
  int B, H, KV, S, hd, gb, nsplit, chunk;
  float scale;
  cudaStream_t stream;
};

template <typename T, int EPL, int GB>
cudaError_t launch(const Args& a) {
  constexpr auto fn = decode_attention_kernel<T, EPL, GB>;
  size_t smem = ring_bytes<T, EPL>(a.hd);
  if (smem < sizeof(Merge<EPL, GB>)) smem = sizeof(Merge<EPL, GB>);
  if (smem < (size_t)GB * a.nsplit * 2 * sizeof(float))
    smem = (size_t)GB * a.nsplit * 2 * sizeof(float);
  int per_sm = 0;
  cudaError_t err = fit_smem<fn>((int)smem, kThreads, &per_sm);
  if (err != cudaSuccess) return err;
  const int nch = (a.H / a.KV + GB - 1) / GB;
  const dim3 grid(a.nsplit, a.KV * nch, a.B);
  fn<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.ck),
      static_cast<const T*>(a.cv), a.lengths, a.len_stride, a.slopes,
      static_cast<T*>(a.out), a.ws, a.tickets, a.H, a.KV, a.S, a.hd, nch,
      a.chunk, a.scale);
  return cudaGetLastError();
}

// query heads per block: the wrapper's gb (a power of two up to 8, with
// GB*EPL <= 32 so the merge buffer stays within 32 KB)
template <typename T, int EPL>
cudaError_t dispatch_group(const Args& a) {
  constexpr int kMaxGB = 32 / EPL < 8 ? 32 / EPL : 8;
  if (a.gb > kMaxGB) return cudaErrorInvalidValue;
  switch (a.gb) {
    case 1: return launch<T, EPL, 1>(a);
    case 2: return launch<T, EPL, 2>(a);
    case 4: return launch<T, EPL, 4>(a);
    case 8:
      if constexpr (kMaxGB >= 8) return launch<T, EPL, 8>(a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (a.hd <= 64) return dispatch_group<T, 2>(a);
  if (a.hd <= 128) return dispatch_group<T, 4>(a);
  return dispatch_group<T, 8>(a);
}

}  // namespace

// q, out: (B, 1, H, hd); ck, cv: (B, KV, S, hd); all contiguous and
// 16-byte aligned, one dtype (0 fp32, 1 fp16, 2 bf16). lengths: int32,
// lengths[b * len_stride] (stride 0 broadcasts one length). slopes: (H,)
// fp32 ALiBi slopes or null. gb: query heads per block; the cache splits
// into nsplit ranges of `chunk` positions (a multiple of the tile), and
// nsplit > 1 needs ws, (B, H, nsplit, hd + 2) fp32, and tickets, B * KV *
// ceil(H / KV / gb) int32 zeroed before the first call (each call leaves
// them zero).
extern "C" int dstpu_decode_attention(const void* q, const void* ck,
                                      const void* cv, const int* lengths,
                                      int len_stride, const float* slopes,
                                      void* out, float* ws, int* tickets,
                                      int B, int H, int KV, int S, int hd,
                                      int dtype, int gb, int nsplit, int chunk,
                                      float scale, void* stream) {
  const int G = KV > 0 ? H / KV : 0;
  const int nch = gb > 0 ? (G + gb - 1) / gb : 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(ck) |
                          reinterpret_cast<uintptr_t>(cv);
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || hd <= 0 ||
      hd > 256 || hd % 8 != 0 || (align & 15) != 0 || B > 65535 ||
      gb <= 0 || (long long)KV * nch > 65535 || nsplit < 1 ||
      nsplit > kMaxSplits || chunk < 1 ||
      (long long)nsplit * chunk < S ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, ck, cv, lengths, len_stride, slopes, out, ws, tickets,
               B, H, KV, S, hd, gb, nsplit, chunk, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return static_cast<int>(dispatch<float>(a));
    case 1: return static_cast<int>(dispatch<__half>(a));
    case 2: return static_cast<int>(dispatch<__nv_bfloat16>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
