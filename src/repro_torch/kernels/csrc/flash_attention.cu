// Flash attention (causal, sliding-window or full) on Hopper (sm_90a), fp32
// math on the CUDA cores:
//
//     out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, kh] * scale + mask)
//                    * v[b, j, kh],        kh = h / (H / K)  (GQA)
//
// q (B, S, H, hd), k/v (B, S, K, hd) in the model's layout, fp32 or bf16;
// out (B, S, H, hd) in q's type.  mask: j <= i when causal, i - j < window
// when window > 0, j < S always.
//
// Replaces: repro/kernels/flash_attention.py::_attn_kernel (pallas_call in
// flash_attention), reached through models/attention.attention when
// cfg.use_flash_kernel is set; the port also routes the cache prefill
// (models/transformer.block_fwd_cache) here, which computes the same
// function with _sdpa and causal_mask.
//
// What bounds it on the H100: 4*B*H*S*S*hd operations (half of them under a
// causal mask) against 989 TFLOP/s of bf16 tensor cores or 67 TFLOP/s of
// fp32; at S >= 128 the operations dominate the bytes of q, k, v and out.
// This first kernel runs on the CUDA cores in fp32 for both input types, so
// it sits far from the bf16 bound; wgmma and TMA come later.
//
// Design.  A block owns one (b, h) and a tile of BQ query rows and streams
// the kv tiles that its mask reaches through shared memory (converted to
// fp32 once), with the online softmax: the running max m, the denominator l
// and the output accumulator stay in registers in fp32, as the reference
// keeps them in VMEM scratch.  Tiles wholly before the window or after the
// causal diagonal are skipped (they add exact zeros); inside a tile a masked
// score is -1e30 and its probability is forced to 0 after the exponential,
// so a row whose whole tile is masked adds nothing even while its max is
// still -1e30.  out = acc / max(l, 1e-30), as the reference.  The kv head of
// q head h is read in place: no transpose and no GQA copy.
//
// Thread map (256 threads): tx = tid % 16, ty = tid / 16.  A thread owns
// query rows ty + 16*i (i < 4); for scores the key columns tx + 16*j
// (j < 4), for the output the head dims tx + 16*j (j < 8).  The 16 threads
// of a row form a half-warp, whose max and sum are butterfly shuffles.  No
// atomics: the result does not depend on scheduling.  No fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // key rows per kv tile
constexpr int HD_MAX = 128;
constexpr int THREADS = 256;
constexpr int RPT = BQ / 16;            // query rows per thread
constexpr int CPT = BK / 16;            // score columns per thread
constexpr int DPT = HD_MAX / 16;        // output dims per thread
constexpr int LDP = BK + 16;            // P tile row: two half-warps, two banks
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);       // round to nearest even, as astype
}

// shared floats of one block: Q [BQ][hd+16], K [BK][hd+1], V [BK][hd],
// P [BQ][LDP]
__host__ __device__ inline size_t smem_floats(int hd) {
  return (size_t)BQ * (hd + 16) + (size_t)BK * (hd + 1) + (size_t)BK * hd +
         (size_t)BQ * LDP;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int K, int hd, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  const int ldq = hd + 16, ldk = hd + 1;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * ldq;
  float* Vs = Ks + BK * ldk;
  float* Ps = Vs + BK * hd;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = (size_t)H * hd, ks = (size_t)K * hd;   // per position
  const T* qb = q + ((size_t)b * S * H + h) * hd;
  const T* kb = k + ((size_t)b * S * K + kh) * hd;
  const T* vb = v + ((size_t)b * S * K + kh) * hd;

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    Qs[r * ldq + d] = q0 + r < S ? to_f(qb[(size_t)(q0 + r) * qs + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // kv tiles the mask reaches: none after the diagonal of the tile's last
  // row, none wholly before the window of its first row
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();            // the previous tile's K, V and P are read
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int r = e / hd, d = e - r * hd;
      const bool in = k0 + r < S;
      Ks[r * ldk + d] = in ? to_f(kb[(size_t)(k0 + r) * ks + d]) : 0.f;
      Vs[r * hd + d] = in ? to_f(vb[(size_t)(k0 + r) * ks + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      bool ok[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < S && (!causal || col <= row) &&
                (window <= 0 || row - col < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        // masked again after the exponential: exp(-1e30 - -1e30) = 1
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * LDP + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = Vs[c * hd + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* ob = out + ((size_t)b * S * H + h) * hd;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(ob + (size_t)row * qs + d, acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int K, int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  // raise the dynamic shared-memory limit once per device and size, so the
  // launch itself can be captured in a CUDA graph
  static size_t granted[64] = {};
  const size_t smem = smem_floats(hd) * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    e = cudaFuncSetAttribute(flash_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = smem;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, K, hd, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_max_hd() { return HD_MAX; }

// dtype 0 = fp32, 1 = bf16 (q, k, v and out alike).  Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int K, int hd,
                               int causal, int window, float scale,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || K <= 0 || H % K != 0 || hd <= 0 || hd > HD_MAX ||
      window < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, H, K, hd, causal, window, scale,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, K, hd, causal,
                                 window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
