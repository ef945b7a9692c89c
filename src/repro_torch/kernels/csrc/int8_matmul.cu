// Weight-only int8 matmul on Hopper (sm_90a), fp32 on the CUDA cores:
//
//     out = x @ (float(w_q) * scale[None, :]) + b,   then SELU if act == 1
//
// x (B, d) fp32, w_q (d, c) int8 in the reference's (d_in, d_out) layout,
// scale and b (c,) fp32 (one symmetric scale per output channel).
//
// Replaces: repro/kernels/int8_matmul.py::_int8_kernel (pallas_call in
// int8_matmul), reached through serve/quant.int8_active_apply -- the three
// layers of the quantized active path: 5->256 with SELU, 256->256, and the
// 256->C logreg head (C = 2 or 4).
//
// What bounds it on the H100: counted as work, 2*B*d*c fp32 FMA operations
// against the 67 TFLOP/s of the CUDA cores, and the bytes of x, w_q (1 byte a
// parameter), scale, b and out against 3.35 TB/s; at B = 256 the operations
// are the larger bound for the 256-wide layers.  At the serving buckets the
// work is 0.01-0.5 us and the time is how many SMs the grid fills and how
// long each block's chain of dependent steps is.
//
// Design.  A block of 128 threads owns a tile of rows x columns; k streams
// through shared memory in slabs of up to 256 (one slab at the 256-wide
// layers), so no width is refused:
// - The x rows go in transposed ([k][row]).  The weight slab crosses device
//   memory as int8, in 16-byte loads where its rows allow, and is
//   dequantized on the way into shared memory, exactly as the reference
//   rounds it: float(w_q) * scale, one fp32 multiply an element.  The
//   dequantized matrix never reaches device memory.
// - Each thread owns one row and MC columns and runs its outputs' sums over
//   k in ascending order from 0 with the bias added last: the order of the
//   kernel this one replaced, so the results are the same bits.  Per k a
//   thread reads its row's x (a broadcast) and its columns' weights (one
//   16-byte read at MC 4).
// - Two shapes of tile, picked by the launcher: 16 x 32 (1 x 4 a thread)
//   where the grid that gives covers half the card or more; else 16 x 8
//   (one output a thread), so that a 16-row bucket of a 256-wide layer
//   still spreads over 32 blocks and the head (c = 2 or 4) over B / 16.
// Ragged rows and columns are zero inputs that are never stored.  No
// fast-math: SELU uses expm1f with jax.nn.selu's constants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int KS = 256;        // k of a staged slab
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

template <int MC, int TC>
struct Tile {
  static constexpr int RT = THREADS / TC;     // rows of the tile, one a thread
  static constexpr int CT = TC * MC;          // columns of the tile
  static constexpr int LDX = RT + 1;          // x row stride: stores and
                                              // reads free of conflicts
  static constexpr size_t SMEM = (size_t)KS * (LDX + CT) * sizeof(float);
};

// the sign-extended byte j (0-3) of u
__device__ __forceinline__ int sbyte(unsigned u, int j) {
  return static_cast<int>(u << (24 - 8 * j)) >> 24;
}

template <int MC, int TC>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ w_q,
                   const float* __restrict__ scale,
                   const float* __restrict__ b, float* __restrict__ out,
                   int B, int d, int c, int act, int vec) {
  using T = Tile<MC, TC>;
  constexpr int RT = T::RT, CT = T::CT, LDX = T::LDX;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [KS][LDX]: x transposed
  float* ws = xs + KS * LDX;                      // [KS][CT]: dequantized

  const int row0 = blockIdx.x * RT, col0 = blockIdx.y * CT;
  const int t = threadIdx.x, tr = t / TC, tc = t % TC;
  float acc[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KS) {
    const int kn = min(KS, d - k0);
    __syncthreads();                    // the last slab is consumed
    // the x rows' loads first, their transposed stores after the weight
    // slab's, so that the two reads' latencies overlap; nothing past kn is
    // staged, since nothing reads it
    constexpr int NX = RT * KS / THREADS;
    float v[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = t + i * THREADS, r = e / KS, kk = e % KS;
      v[i] = row0 + r < B && kk < kn
                 ? x[(size_t)(row0 + r) * d + k0 + kk] : 0.f;
    }
    if constexpr (CT % 16 == 0) {
      if (vec) {
        // 16 weights a load; a thread's columns are the same in every slab
        constexpr int SEGS = CT / 16, NV = KS * SEGS / THREADS;
        const int seg = t % SEGS, cs = col0 + seg * 16;
        float sc[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) sc[j] = cs < c ? scale[cs + j] : 0.f;
        int4 q[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int kk = (t + i * THREADS) / SEGS;
          q[i] = cs < c && kk < kn ? *reinterpret_cast<const int4*>(
                                         w_q + (size_t)(k0 + kk) * c + cs)
                                   : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int kk = (t + i * THREADS) / SEGS;
          if (kk >= kn) continue;
          const unsigned u[4] = {(unsigned)q[i].x, (unsigned)q[i].y,
                                 (unsigned)q[i].z, (unsigned)q[i].w};
          float* dst = ws + kk * CT + seg * 16;
#pragma unroll
          for (int j = 0; j < 16; j += 4)
            *reinterpret_cast<float4*>(dst + j) = make_float4(
                (float)sbyte(u[j / 4], 0) * sc[j],
                (float)sbyte(u[j / 4], 1) * sc[j + 1],
                (float)sbyte(u[j / 4], 2) * sc[j + 2],
                (float)sbyte(u[j / 4], 3) * sc[j + 3]);
        }
      }
    }
    if (CT % 16 != 0 || !vec) {
      constexpr int NB = KS * CT / THREADS;
#pragma unroll 1
      for (int i0 = 0; i0 < NB && i0 * THREADS / CT < kn; i0 += 8) {
        int8_t q[8];
        float s[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = t + (i0 + i) * THREADS, kk = e / CT;
          const int col = col0 + e % CT;
          const bool ok = kk < kn && col < c;
          q[i] = ok ? w_q[(size_t)(k0 + kk) * c + col] : (int8_t)0;
          s[i] = ok ? scale[col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if ((t + (i0 + i) * THREADS) / CT < kn)
            ws[t + (i0 + i) * THREADS] = (float)q[i] * s[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = t + i * THREADS;
      if (e % KS < kn) xs[(e % KS) * LDX + e / KS] = v[i];
    }
    __syncthreads();
    const float* xp = xs + tr;
    const float* wp = ws + tc * MC;
#pragma unroll 8
    for (int kk = 0; kk < kn; ++kk) {
      const float xv = xp[kk * LDX];
      float wv[MC];
      if constexpr (MC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(wp + kk * CT);
        wv[0] = v.x;
        wv[1] = v.y;
        wv[2] = v.z;
        wv[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < MC; ++j) wv[j] = wp[kk * CT + j];
      }
#pragma unroll
      for (int j = 0; j < MC; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
    }
  }
  const int row = row0 + tr;
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    const int col = col0 + tc * MC + j;
    if (row < B && col < c) {
      const float a = acc[j] + b[col];
      out[(size_t)row * c + col] = act ? selu(a) : a;
    }
  }
}

template <int MC, int TC>
int launch(const float* x, const int8_t* w_q, const float* scale,
           const float* b, float* out, int B, int d, int c, int act,
           cudaStream_t stream) {
  using T = Tile<MC, TC>;
  const long long gx = (B + T::RT - 1) / T::RT, gy = (c + T::CT - 1) / T::CT;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  // once per tile shape: the shared memory it needs (above 48 KB at 16 x 32)
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_matmul_kernel<MC, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int vec = reinterpret_cast<uintptr_t>(w_q) % 16 == 0 && c % 16 == 0;
  int8_matmul_kernel<MC, TC>
      <<<dim3((unsigned)gx, (unsigned)gy), THREADS, T::SMEM, stream>>>(
          x, w_q, scale, b, out, B, d, c, act, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the launch's error code (0 = launched).
extern "C" int int8_matmul(const float* x, const int8_t* w_q,
                           const float* scale, const float* b, float* out,
                           int B, int d, int c, int act, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long wide = (long long)((B + 15) / 16) * ((c + 31) / 32);
  if (wide >= 64) return launch<4, 8>(x, w_q, scale, b, out, B, d, c, act, s);
  return launch<1, 8>(x, w_q, scale, b, out, B, d, c, act, s);
}

extern "C" const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
