// Lane-MLP backward on Hopper (sm_90a), fp32 on the CUDA cores: the
// closed-form chain rule of  out = [selu](selu(x @ w0 + b0) @ w1 + b1)
// for the output cotangent g, from the pre-activations a1, a2 the forward
// saved:
//
//     g2  = g * selu'(a2) if final_act else g           (B, dz)
//     dW1 = selu(a1)^T g2          db1 = sum_rows g2     (h, dz), (dz)
//     g1  = (g2 @ w1^T) * selu'(a1)                      (B, h)
//     dW0 = x^T g1                 db0 = sum_rows g1     (din, h), (h)
//     dx  = g1 @ w0^T                                    (B, din)
//
// for each lane l of a stack: g (L, B, dz), x (L, B, din), a1 (L, B, h),
// a2 (L, B, dz), w0 (L, din, h), w1 (L, h, dz), all row-major fp32,
// weights in the reference's (d_in, d_out) layout.
//
// Replaces: repro/kernels/lane_mlp.py::_bwd_kernel (pallas_call in
// _bwd_call), the custom VJP of fused_mlp2 / fused_lane_mlp2 that trains
// every Table-3 autoencoder in steps 1-3 of run_apcvfl(use_kernel=True).
//
// What bounds it on the H100: 4*B*(din*h + h*dz) fp32 operations against
// the 67 TFLOP/s of the CUDA cores, and the bytes of g, x, a1, a2, both
// weights and the five gradients against 3.35 TB/s; at the training batch
// (B = 128) the two weights dominate the bytes and neither bound is
// reached: the grid is small and the time is latency.
//
// Design.  The hidden cotangent g1 needs a whole row of g2 @ w1^T before
// dW0 and dx can start, so the backward is two launches:
//
//   (a) lane_mlp_bwd_rows: one block per BM-row tile.  g2 and selu'(a1)
//       of the tile go to shared memory; warp w then owns hidden units
//       w, w + 8, ...: its lanes stream row j of w1 (coalesced), each
//       keeping BM partial sums, and a shuffle tree reduces them into
//       g1[:, j].  dx is the same pattern over the rows of w0.  g1, and
//       selu(a1) and g2 for launch (b), go to (L, B, *) scratch; dx is
//       skipped when its pointer is null (an encoder's input needs none).
//   (b) lane_mlp_bwd_weights: one block per (TM-row tile, chunk of 256
//       gradient elements); one thread computes one element of dW1, dW0,
//       db1 or db0 for its tile as a sum over the tile's rows, reading g2
//       and g1 coalesced along the output column.
//
// The weight gradients leave as per-tile partials (L, T, ...), T =
// ceil(B / TM), and are summed over the tile axis after the kernel: a
// deterministic reduction, no atomics, as the TPU kernel's per-tile
// partials.  Ragged rows are zero and never stored; a lane whose g is zero
// (a dead lane) gives exact zeros.  No fast-math: selu' uses expf and
// selu expm1f, the form and constants of jax.nn.selu.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 8;            // rows per block in launch (a)
constexpr int TM = 32;           // rows per weight-gradient partial
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

__device__ __forceinline__ float dselu(float a) {
  return SELU_SCALE * (a > 0.f ? 1.f : SELU_ALPHA * expf(a));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[r] = sum_c rows[r * n + c] * w[c] for the BM rows held in shared
// memory, one warp, lanes striding over c; the total lands in every lane.
__device__ __forceinline__ void warp_dot_rows(float (&acc)[BM],
                                              const float* rows,
                                              const float* __restrict__ w,
                                              int n, int lane) {
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float wv = __ldg(w + c);
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = fmaf(rows[r * n + c], wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = warp_sum(acc[r]);
}

__global__ void __launch_bounds__(THREADS)
lane_mlp_bwd_rows(const float* __restrict__ g, const float* __restrict__ a1,
                  const float* __restrict__ a2, const float* __restrict__ w0,
                  const float* __restrict__ w1, float* __restrict__ dx,
                  float* __restrict__ g1_out, float* __restrict__ h1_out,
                  float* __restrict__ g2_out, int B, int din, int h, int dz,
                  int final_act) {
  extern __shared__ float4 smem4[];
  float* g2s = reinterpret_cast<float*>(smem4);   // [BM][dz]
  float* g1s = g2s + (size_t)BM * dz;    // [BM][h]: selu'(a1), then g1

  const int lane_idx = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);
  const int t = threadIdx.x, warp = t / 32, wl = t % 32;
  const size_t rz = ((size_t)lane_idx * B + row0) * dz;
  const size_t rh = ((size_t)lane_idx * B + row0) * h;

  g += rz;
  a2 += rz;
  a1 += rh;
  g1_out += rh;
  h1_out += rh;
  if (g2_out) g2_out += rz;
  w0 += (size_t)lane_idx * din * h;
  w1 += (size_t)lane_idx * h * dz;
  if (dx) dx += ((size_t)lane_idx * B + row0) * din;

  for (int i = t; i < BM * dz; i += THREADS) {
    const int r = i / dz;
    float v = 0.f;
    if (r < rows) {
      v = g[i];
      if (final_act) {
        v *= dselu(a2[i]);
        g2_out[i] = v;
      }
    }
    g2s[i] = v;
  }
  for (int i = t; i < BM * h; i += THREADS) {
    const int r = i / h;
    float d = 0.f;
    if (r < rows) {
      const float a = a1[i];
      h1_out[i] = selu(a);
      d = dselu(a);
    }
    g1s[i] = d;
  }
  __syncthreads();

  // g1[:, j] = (g2 @ w1[j, :]) * selu'(a1[:, j]); warp w owns units w + 8k
  for (int j = warp; j < h; j += NWARPS) {
    float acc[BM];
    warp_dot_rows(acc, g2s, w1 + (size_t)j * dz, dz, wl);
    if (wl == 0) {
#pragma unroll
      for (int r = 0; r < BM; ++r) g1s[r * h + j] *= acc[r];
    }
  }
  __syncthreads();

  for (int i = t; i < BM * h; i += THREADS)
    if (i / h < rows) g1_out[i] = g1s[i];

  // dx[:, d] = g1 @ w0[d, :]
  if (dx) {
    for (int d = warp; d < din; d += NWARPS) {
      float acc[BM];
      warp_dot_rows(acc, g1s, w0 + (size_t)d * h, h, wl);
      if (wl == 0) {
#pragma unroll
        for (int r = 0; r < BM; ++r)
          if (r < rows) dx[(size_t)r * din + d] = acc[r];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lane_mlp_bwd_weights(const float* __restrict__ x,
                     const float* __restrict__ h1,
                     const float* __restrict__ g2,
                     const float* __restrict__ g1, float* __restrict__ dw0p,
                     float* __restrict__ db0p, float* __restrict__ dw1p,
                     float* __restrict__ db1p, int B, int din, int h, int dz,
                     int tiles) {
  const int lane_idx = blockIdx.z;
  const int tile = blockIdx.x;
  const int row0 = tile * TM;
  const int rows = min(TM, B - row0);
  const size_t e1 = (size_t)h * dz, e0 = (size_t)din * h;
  const size_t e = (size_t)blockIdx.y * THREADS + threadIdx.x;
  if (e >= e1 + e0 + dz + h) return;
  const size_t part = (size_t)lane_idx * tiles + tile;

  x += ((size_t)lane_idx * B + row0) * din;
  h1 += ((size_t)lane_idx * B + row0) * h;
  g2 += ((size_t)lane_idx * B + row0) * dz;
  g1 += ((size_t)lane_idx * B + row0) * h;

  float acc = 0.f;
  if (e < e1) {                                   // dW1[k][c]
    const int k = (int)(e / dz), c = (int)(e % dz);
    for (int r = 0; r < rows; ++r)
      acc = fmaf(h1[(size_t)r * h + k], g2[(size_t)r * dz + c], acc);
    dw1p[part * e1 + e] = acc;
  } else if (e < e1 + e0) {                       // dW0[d][j]
    const size_t i = e - e1;
    const int d = (int)(i / h), j = (int)(i % h);
    for (int r = 0; r < rows; ++r)
      acc = fmaf(x[(size_t)r * din + d], g1[(size_t)r * h + j], acc);
    dw0p[part * e0 + i] = acc;
  } else if (e < e1 + e0 + dz) {                  // db1[c]
    const int c = (int)(e - e1 - e0);
    for (int r = 0; r < rows; ++r) acc += g2[(size_t)r * dz + c];
    db1p[part * dz + c] = acc;
  } else {                                        // db0[j]
    const int j = (int)(e - e1 - e0 - dz);
    for (int r = 0; r < rows; ++r) acc += g1[(size_t)r * h + j];
    db0p[part * h + j] = acc;
  }
}

size_t rows_smem(int h, int dz) {
  return (size_t)BM * (dz + h) * sizeof(float);
}

}  // namespace

extern "C" int lane_mlp_bwd_tile_rows() { return TM; }

// Largest h + dz the shared tiles of launch (a) admit (227 KB per block).
extern "C" int lane_mlp_bwd_max_width() {
  return 232448 / (BM * (int)sizeof(float));
}

// Launches (a) then (b) on `stream`; returns cudaGetLastError() (0 =
// launched).  g2_scratch is used (and must be non-null) only when
// final_act; dx may be null.  Partials: dw0p (L, T, din, h), db0p (L, T,
// h), dw1p (L, T, h, dz), db1p (L, T, dz), T = ceil(B / TM).
extern "C" int lane_mlp_bwd(const float* g, const float* x, const float* a1,
                            const float* a2, const float* w0, const float* w1,
                            float* dx, float* dw0p, float* db0p, float* dw1p,
                            float* db1p, float* g1_scratch,
                            float* h1_scratch, float* g2_scratch, int L,
                            int B, int din, int h, int dz, int final_act,
                            void* stream) {
  if (L <= 0 || B <= 0) return 0;
  if (din <= 0 || h <= 0 || dz <= 0 || h + dz > lane_mlp_bwd_max_width() ||
      (final_act && !g2_scratch))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = rows_smem(h, dz);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lane_mlp_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lane_mlp_bwd_rows<<<dim3((B + BM - 1) / BM, L), THREADS, smem, s>>>(
      g, a1, a2, w0, w1, dx, g1_scratch, h1_scratch,
      final_act ? g2_scratch : nullptr, B, din, h, dz, final_act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (B + TM - 1) / TM;
  const size_t total = (size_t)h * dz + (size_t)din * h + dz + h;
  const dim3 grid(tiles, (unsigned)((total + THREADS - 1) / THREADS), L);
  lane_mlp_bwd_weights<<<grid, THREADS, 0, s>>>(
      x, h1_scratch, final_act ? g2_scratch : g, g1_scratch, dw0p, db0p,
      dw1p, db1p, B, din, h, dz, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* lane_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
