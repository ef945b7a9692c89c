// One-token decode attention against a slot KV cache on Hopper (sm_90a),
// fp32 math on the CUDA cores:
//
//     out[b, h] = sum_w softmax_w(q[b, h] . k[b, w, kh] * scale + mask)
//                 * v[b, w, kh],        kh = h / (H / K)  (GQA)
//
// q (B, H, hd), k/v (B, W, K, hd) in the cache's own layout, fp32 or bf16;
// slot_pos (W,) int32, the position written in each slot (-1 = empty); pos
// the current position, a host int; out (B, H, hd) in q's type.  A slot is
// valid when slot_pos >= 0, slot_pos <= pos and, with a window,
// slot_pos > pos - window.
//
// Replaces: repro/kernels/decode_attention.py::_kernel (pallas_call in
// decode_attention).  No JAX model code calls it; the port routes the
// one-token decode of models/attention.decode_attention here when
// cfg.use_flash_kernel is set (the reference computes the same function
// with _sdpa and a slot bias, and its tests hold the two together).
//
// What bounds it on the H100: the bytes of the valid slots' K and V rows,
// read once, against 3.35 TB/s; its 4*hd operations per slot and head are
// far below the bytes' time.
//
// Design.  A block owns one (b, h).  Its eight warps take groups of UNROLL
// neighbouring slots in turn (group g to warp g % 8), so a cache whose
// valid slots form a prefix still spreads over every warp.  A lane holds
// head dims lane + 32*j; a slot's score is a butterfly sum over the warp
// (every lane ends with the same bits).  Each warp keeps its own online
// softmax (m, l, acc) in fp32 in registers; a group updates it once, with
// the group's max.  Invalid slots are skipped: in the reference they add
// p = 0 and leave the max as it was, so skipping them is exact.  The eight
// partials then merge in shared memory in warp order, so the result is the
// same in every run: no atomics.  out = acc / max(l, 1e-30), as the
// reference.  No fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD_MAX = 128;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int DPL = HD_MAX / 32;        // head dims per lane
constexpr int UNROLL = 4;               // slots a warp has in flight
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ slot_pos,
              T* __restrict__ out, int H, int K, int W, int hd, int pos,
              int window, float scale) {
  __shared__ float ms[WARPS], ls[WARPS];
  __shared__ float accs[WARPS][HD_MAX];

  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ws = (size_t)K * hd;                    // per slot
  const T* kb = k + ((size_t)b * W * K + kh) * hd;
  const T* vb = v + ((size_t)b * W * K + kh) * hd;
  const T* qr = q + ((size_t)b * H + h) * hd;

  float qv[DPL], acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    qv[j] = d < hd ? to_f(qr[d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int w0 = warp * UNROLL; w0 < W; w0 += WARPS * UNROLL) {
    bool ok[UNROLL];
    float s[UNROLL], vv[UNROLL][DPL];
    bool any = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + u;
      const int sp = w < W ? slot_pos[w] : -1;
      ok[u] = sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
      any |= ok[u];
      s[u] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        const bool in = ok[u] && d < hd;
        s[u] = in ? fmaf(qv[j], to_f(kb[(size_t)w * ws + d]), s[u]) : s[u];
        vv[u][j] = in ? to_f(vb[(size_t)w * ws + d]) : 0.f;
      }
    }
    if (!any) continue;                 // warp-uniform: slot_pos is shared
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    float mx = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] *= scale;
      if (ok[u]) mx = fmaxf(mx, s[u]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      const float p = expf(s[u] - mx);
      l += p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] = fmaf(p, vv[u][j], acc[j]);
    }
    m = mx;
  }

  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < hd) accs[warp][d] = acc[j];
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= hd) return;
  float M = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ms[w]);
  float L = 0.f, A = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float c = expf(ms[w] - M);
    L += ls[w] * c;
    A += accs[w][d] * c;
  }
  store(out + ((size_t)b * H + h) * hd + d, A / fmaxf(L, 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* slot_pos,
           void* out, int B, int H, int K, int W, int hd, int pos, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  decode_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), slot_pos, static_cast<T*>(out), H, K, W, hd,
      pos, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_max_hd() { return HD_MAX; }

// dtype 0 = fp32, 1 = bf16 (q, the cache and out alike).  Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* slot_pos, void* out, int B, int H,
                                int K, int W, int hd, int pos, int window,
                                float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0 || W <= 0 || hd <= 0 || hd > HD_MAX ||
      window < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, slot_pos, out, B, H, K, W, hd, pos, window,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, slot_pos, out, B, H, K, W, hd, pos,
                                 window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
