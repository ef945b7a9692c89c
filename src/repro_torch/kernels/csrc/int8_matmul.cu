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
// grid has only B/8 blocks, so the time is latency, as for the lane MLP.
//
// Design.  The weight crosses memory as int8 and is dequantized in a
// register, element by element, exactly as the reference rounds it
// (float(w_q) * scale, one fp32 multiply), then used and dropped: the
// dequantized matrix is never written anywhere.  A block owns BM rows with
// their x tile in shared memory, transposed to [feature][row]; thread t owns
// output column t (+256, ...), so each weight byte is read once per block and
// a warp reads 32 neighbouring bytes.  Columns past c idle (the head has only
// 2 or 4).  Ragged rows are zero inputs that are never stored.  No fast-math:
// SELU uses expm1f with jax.nn.selu's constants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;          // rows per block
constexpr int THREADS = 256;   // output columns a block covers per pass
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ w_q,
                   const float* __restrict__ scale,
                   const float* __restrict__ b, float* __restrict__ out,
                   int B, int d, int c, int act) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [d][BM]

  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);
  const int t = threadIdx.x;
  x += (size_t)row0 * d;
  out += (size_t)row0 * c;

  for (int i = t; i < BM * d; i += THREADS) {
    const int r = i / d, k = i - r * d;
    xs[k * BM + r] = r < rows ? x[(size_t)r * d + k] : 0.f;
  }
  __syncthreads();

  for (int col = t; col < c; col += THREADS) {
    const float s = scale[col];
    float acc[BM] = {};
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      // dequantize in a register: the reference's float(w_q) * scale
      const float w = (float)__ldg(w_q + (size_t)k * c + col) * s;
      const float4 lo = *reinterpret_cast<const float4*>(xs + k * BM);
      const float4 hi = *reinterpret_cast<const float4*>(xs + k * BM + 4);
      acc[0] = fmaf(lo.x, w, acc[0]);
      acc[1] = fmaf(lo.y, w, acc[1]);
      acc[2] = fmaf(lo.z, w, acc[2]);
      acc[3] = fmaf(lo.w, w, acc[3]);
      acc[4] = fmaf(hi.x, w, acc[4]);
      acc[5] = fmaf(hi.y, w, acc[5]);
      acc[6] = fmaf(hi.z, w, acc[6]);
      acc[7] = fmaf(hi.w, w, acc[7]);
    }
    const float bias = b[col];
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      if (r < rows) {
        const float a = acc[r] + bias;
        out[(size_t)r * c + col] = act ? selu(a) : a;
      }
    }
  }
}

}  // namespace

// Largest d the shared x tile admits (227 KB per block on Hopper).
extern "C" int int8_matmul_max_d() {
  return 232448 / (BM * (int)sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int int8_matmul(const float* x, const int8_t* w_q,
                           const float* scale, const float* b, float* out,
                           int B, int d, int c, int act, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > int8_matmul_max_d() || c <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)d * BM * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w_q, scale, b, out, B, d, c, act);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
