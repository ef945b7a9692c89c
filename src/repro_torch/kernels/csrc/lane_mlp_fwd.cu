// Lane-MLP forward on Hopper (sm_90a), fp32 on the CUDA cores:
//
//     a1  = x @ w0 + b0          (B, h)   hidden pre-activation
//     a2  = selu(a1) @ w1 + b1   (B, dz)  output pre-activation
//     out = selu(a2) if final_act else a2
//
// for each lane l of a stack: x (L, B, din), w0 (L, din, h), b0 (L, h),
// w1 (L, h, dz), b1 (L, dz), all row-major fp32, weights in the reference's
// (d_in, d_out) layout.  a1/a2 are written only when their pointers are not
// null (serving passes null; the training slice keeps them for the backward).
//
// Replaces: repro/kernels/lane_mlp.py::_fwd_kernel (pallas_call in
// _fwd_call), reached through fused_mlp2 / fused_lane_mlp2 and
// core/autoencoder.fused_encode -- every Table-3 encoder on the serving path
// (g1_active 5->64->128, g3 5->256->256, g2 384->256->256).
//
// What bounds it on the H100: counted as work, 2*B*(din*h + h*dz) fp32 FMA
// operations against the 67 TFLOP/s of the CUDA cores, and, a factor 3-4
// lower at every Table-3 shape, the bytes of x, the weights and out against
// 3.35 TB/s.  At the serving buckets (16-256 rows) neither is reached: the
// grid has only B/8 blocks and each block walks both weight matrices once,
// so the time is latency (one pass over din + h dependent steps per thread).
//
// Design.  The TPU kernel keeps both weight matrices in VMEM; on Hopper g2's
// w0 alone (393 KB) exceeds the 227 KB a block may hold, so the weights are
// STREAMED instead: a block owns BM rows; thread t owns hidden unit t in the
// first layer and output column t (+256, ...) in the second, so every weight
// element is read once per block, coalesced across the warp, and lives only
// in a register.  The x tile and the hidden activation selu(a1) stay in
// shared memory, transposed to [feature][row] so each step reads the BM row
// values as two float4 broadcasts.  The hidden activation never leaves the
// chip, which is the point of the fused TPU kernel.  Ragged rows are zero
// inputs that are never stored; h is at most 256 (THREADS), which every
// Table-3 layer meets.  The lane axis is grid axis 1.  No fast-math: SELU
// uses expm1f, the form and constants of jax.nn.selu.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 8;          // rows per block
constexpr int THREADS = 256;   // = widest hidden layer a block computes
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

// acc[r] += v[r] * w for the BM rows held at p (16-byte aligned)
__device__ __forceinline__ void fma_rows(float (&acc)[BM], const float* p,
                                         float w) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  acc[0] = fmaf(lo.x, w, acc[0]);
  acc[1] = fmaf(lo.y, w, acc[1]);
  acc[2] = fmaf(lo.z, w, acc[2]);
  acc[3] = fmaf(lo.w, w, acc[3]);
  acc[4] = fmaf(hi.x, w, acc[4]);
  acc[5] = fmaf(hi.y, w, acc[5]);
  acc[6] = fmaf(hi.z, w, acc[6]);
  acc[7] = fmaf(hi.w, w, acc[7]);
}

__global__ void __launch_bounds__(THREADS)
lane_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, float* __restrict__ out,
                    float* __restrict__ a1_out, float* __restrict__ a2_out,
                    int B, int din, int h, int dz, int final_act) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [din][BM]
  float* hs = xs + (size_t)din * BM;             // [THREADS][BM]

  const int lane = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);
  const int t = threadIdx.x;

  x += ((size_t)lane * B + row0) * din;
  w0 += (size_t)lane * din * h;
  b0 += (size_t)lane * h;
  w1 += (size_t)lane * h * dz;
  b1 += (size_t)lane * dz;
  out += ((size_t)lane * B + row0) * dz;
  if (a1_out) a1_out += ((size_t)lane * B + row0) * h;
  if (a2_out) a2_out += ((size_t)lane * B + row0) * dz;

  // x tile -> shared, transposed; rows past B are zeros (never stored)
  for (int i = t; i < BM * din; i += THREADS) {
    const int r = i / din, d = i - r * din;
    xs[d * BM + r] = r < rows ? x[(size_t)r * din + d] : 0.f;
  }
  __syncthreads();

  // layer 1: thread t -> hidden unit t, all BM rows
  if (t < h) {
    float acc[BM] = {};
#pragma unroll 4
    for (int d = 0; d < din; ++d)
      fma_rows(acc, xs + d * BM, __ldg(w0 + (size_t)d * h + t));
    const float bias = b0[t];
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float a = acc[r] + bias;
      if (a1_out && r < rows) a1_out[(size_t)r * h + t] = a;
      hs[t * BM + r] = selu(a);
    }
  }
  __syncthreads();

  // layer 2: thread t -> output columns t, t + 256, ...
  for (int c = t; c < dz; c += THREADS) {
    float acc[BM] = {};
#pragma unroll 4
    for (int k = 0; k < h; ++k)
      fma_rows(acc, hs + k * BM, __ldg(w1 + (size_t)k * dz + c));
    const float bias = b1[c];
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      if (r < rows) {
        const float a = acc[r] + bias;
        if (a2_out) a2_out[(size_t)r * dz + c] = a;
        out[(size_t)r * dz + c] = final_act ? selu(a) : a;
      }
    }
  }
}

}  // namespace

// Largest din the shared x tile admits (227 KB per block on Hopper).
extern "C" int lane_mlp_fwd_max_din() {
  return 232448 / (BM * (int)sizeof(float)) - THREADS;
}

extern "C" int lane_mlp_fwd_max_hidden() { return THREADS; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int lane_mlp_fwd(const float* x, const float* w0, const float* b0,
                            const float* w1, const float* b1, float* out,
                            float* a1, float* a2, int L, int B, int din, int h,
                            int dz, int final_act, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  if (din <= 0 || din > lane_mlp_fwd_max_din() || h <= 0 || h > THREADS ||
      dz <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)din + THREADS) * BM * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lane_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + BM - 1) / BM, L);
  lane_mlp_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w0, b0, w1, b1, out, a1, a2, B, din, h, dz, final_act);
  return (int)cudaGetLastError();
}

extern "C" const char* lane_mlp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
