// Paper Eq. 5 per row on Hopper (sm_90a), fp32, forward and backward:
//
//     rec_i = mean_d (x_i - xh_i)^2
//     dis_i = mean_m |z_i - zt_i|^p          (p = 2 for MSE, 1 for MAE)
//     out_i = rec_i + lam * mask_i * dis_i
//
// and, for row cotangents g_i,
//
//     dx_i = (g_i * 2/D) * (x_i - xh_i)           (d xh_i = -dx_i)
//     dz_i = (g_i * lam * mask_i) * ddis_i        (d zt_i = -dz_i)
//            ddis = 2 (z - zt) / M  (MSE)  or  sign(z - zt) / M  (MAE)
//     dmask_i = g_i * lam * dis_i
//
// for N rows: x, xh (N, D); z, zt (N, M); mask, g, out, dmask (N,); all
// row-major fp32.  A lane axis of the caller is folded into the rows.
//
// Replaces: repro/kernels/distill_loss.py::_kernel (pallas_call in
// _rows_fwd_call) and ::_bwd_kernel (pallas_call in _rows_bwd_call), the
// Eq. 5 loss of step 3 (distill.make_loss / make_lanes_loss with
// use_kernel=True) and its custom VJP.
//
// What bounds it on the H100: bytes.  Each element is read once and does
// two or three operations, so the time floor is the bytes of the inputs
// and outputs over 3.35 TB/s; at the training batch (128 rows x (5 + 256)
// columns) that floor is well under a microsecond and the launch itself
// dominates.
//
// Design: one warp per row, its lanes striding over the columns (coalesced
// loads), with a shuffle tree for each row reduction; a mean is the sum
// divided by D or M, as jnp.mean computes it.  The backward recomputes dis
// for dmask in the same pass that writes dz.  sign(0) is 0, as jnp.sign
// (copysignf would give +-1).  The two passes are separate kernels, like
// the TPU's, because the backward's g exists only after the loss is
// reduced.  No fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sign(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

__global__ void __launch_bounds__(THREADS)
distill_fwd_kernel(const float* __restrict__ x, const float* __restrict__ xh,
                   const float* __restrict__ z, const float* __restrict__ zt,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int N, int D, int M, float lam, int mae) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  if (row >= N) return;
  x += (size_t)row * D;
  xh += (size_t)row * D;
  z += (size_t)row * M;
  zt += (size_t)row * M;
  float s = 0.f, q = 0.f;
  for (int d = l; d < D; d += 32) {
    const float e = x[d] - xh[d];
    s += e * e;
  }
  for (int m = l; m < M; m += 32) {
    const float e = z[m] - zt[m];
    q += mae ? fabsf(e) : e * e;
  }
  s = warp_sum(s);
  q = warp_sum(q);
  if (l == 0) out[row] = s / (float)D + lam * mask[row] * (q / (float)M);
}

__global__ void __launch_bounds__(THREADS)
distill_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ xh, const float* __restrict__ z,
                   const float* __restrict__ zt,
                   const float* __restrict__ mask, float* __restrict__ dx,
                   float* __restrict__ dz, float* __restrict__ dmask, int N,
                   int D, int M, float lam, float two_over_d, int mae) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  if (row >= N) return;
  const size_t rd = (size_t)row * D, rm = (size_t)row * M;
  const float gr = g[row];
  const float cx = gr * two_over_d;
  for (int d = l; d < D; d += 32) dx[rd + d] = cx * (x[rd + d] - xh[rd + d]);
  const float cz = gr * lam * mask[row];
  const float fm = (float)M;
  float q = 0.f;
  for (int m = l; m < M; m += 32) {
    const float e = z[rm + m] - zt[rm + m];
    if (mae) {
      q += fabsf(e);
      dz[rm + m] = cz * (sign(e) / fm);
    } else {
      q += e * e;
      dz[rm + m] = cz * (2.f * e / fm);
    }
  }
  q = warp_sum(q);
  if (l == 0) dmask[row] = gr * lam * (q / fm);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
extern "C" int distill_fwd(const float* x, const float* xh, const float* z,
                           const float* zt, const float* mask, float* out,
                           int N, int D, int M, float lam, int mae,
                           void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  distill_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, xh, z, zt, mask, out, N, D, M, lam, mae);
  return (int)cudaGetLastError();
}

extern "C" int distill_bwd(const float* g, const float* x, const float* xh,
                           const float* z, const float* zt, const float* mask,
                           float* dx, float* dz, float* dmask, int N, int D,
                           int M, float lam, int mae, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  // 2/D rounded once from double, as the reference's Python 2.0 / D
  distill_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, x, xh, z, zt, mask, dx, dz, dmask, N, D, M, lam,
      (float)(2.0 / D), mae);
  return (int)cudaGetLastError();
}

extern "C" const char* distill_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
