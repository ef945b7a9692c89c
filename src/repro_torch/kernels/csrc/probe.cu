// Weighted softmax-CE probe step on Hopper (sm_90a), fp32: for each fold
// lane k of a stack of probes w (K, d, C), b (K, C) sharing the rows
// x (n, d) and labels y (n,) int32, with pre-normalized row weights
// rwn (K, n):
//
//     logits = x @ w_k + b_k
//     loss_k = sum_i (logsumexp(logits_i) - logits_i[y_i]) * rwn_ki
//     g      = (softmax(logits) - onehot(y)) * rwn_k[:, None]
//     dW_k   = x^T g            db_k = sum_rows g
//
// written as per-tile partials lossp (K, T), dwp (K, T, d, C), dbp (K, T,
// C), T = ceil(n / TR), summed over the tile axis after the kernel (the L2
// term is added outside too, as the reference does).
//
// Replaces: repro/kernels/probe.py::_probe_kernel (pallas_call in
// _probe_call), the gradient of every fold's probe step in
// classifier.kfold_cv / fit_logreg with use_kernel=True.
//
// What bounds it on the H100: operations, at the k = 10 fold lanes of
// kfold_cv.  The function needs x (n x 256 fp32) once, while its two
// products do 4*C operations per element of x for each of the k lanes,
// so k*4*C = 160 operations per 4-byte element lies above the card's
// 20 operations per byte (fp32 on the CUDA cores).  This kernel reads x
// again for every lane (mostly from L2), which a faster one would share.
//
// Design: grid (row tiles, lanes).  A block stages its TR x d tile of x in
// shared memory (rows padded to d + 1 floats so the logit pass reads
// without bank conflicts) with w_k and b_k, computes the TR x C logits,
// then one thread per row takes a stable max / exp / sum that serves both
// logsumexp and softmax and forms that row's g, and finally the block
// reads the same x tile again from shared memory for dW.  Rows past n are
// zero with weight 0, and any row of weight 0 contributes exact zeros, so
// a fold's held-out rows are inert.  No fast-math: expf and logf as the
// reference rounds them.

#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;            // rows per tile
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ x, const int* __restrict__ y,
             const float* __restrict__ rwn, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ lossp,
             float* __restrict__ dwp, float* __restrict__ dbp, int n, int d,
             int C, int tiles) {
  extern __shared__ float4 smem4[];
  const int ld = d + 1;
  float* xs = reinterpret_cast<float*>(smem4);    // [TR][d + 1]
  float* ws = xs + (size_t)TR * ld;               // [d][C]
  float* gs = ws + (size_t)d * C;                 // [TR][C]: logits, then g
  float* ls = gs + (size_t)TR * C;                // [TR] row losses

  const int tile = blockIdx.x, k = blockIdx.y, t = threadIdx.x;
  const int row0 = tile * TR;
  const int rows = min(TR, n - row0);
  w += (size_t)k * d * C;
  b += (size_t)k * C;
  rwn += (size_t)k * n + row0;
  x += (size_t)row0 * d;
  y += row0;

  for (int i = t; i < TR * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    xs[r * ld + c] = r < rows ? x[i] : 0.f;
  }
  for (int i = t; i < d * C; i += THREADS) ws[i] = w[i];
  __syncthreads();

  for (int i = t; i < TR * C; i += THREADS) {
    const int r = i / C, c = i - r * C;
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(xs[r * ld + j], ws[j * C + c], acc);
    gs[i] = acc + b[c];
  }
  __syncthreads();

  if (t < TR) {
    const float rw = t < rows ? rwn[t] : 0.f;
    const int yy = t < rows ? y[t] : 0;
    float* lg = gs + t * C;
    float m = lg[0];
    for (int c = 1; c < C; ++c) m = fmaxf(m, lg[c]);
    float se = 0.f, gold = 0.f;
    for (int c = 0; c < C; ++c) {
      se += expf(lg[c] - m);
      gold += c == yy ? lg[c] : 0.f;
    }
    ls[t] = (logf(se) + m - gold) * rw;
    for (int c = 0; c < C; ++c)
      lg[c] = (expf(lg[c] - m) / se - (c == yy ? 1.f : 0.f)) * rw;
  }
  __syncthreads();

  const size_t part = (size_t)k * tiles + tile;
  if (t == 0) {
    float s = 0.f;
    for (int r = 0; r < TR; ++r) s += ls[r];
    lossp[part] = s;
  }
  for (int i = t; i < d * C; i += THREADS) {
    const int j = i / C, c = i - j * C;
    float acc = 0.f;
    for (int r = 0; r < TR; ++r)
      acc = fmaf(xs[r * ld + j], gs[r * C + c], acc);
    dwp[part * d * C + i] = acc;
  }
  for (int c = t; c < C; c += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < TR; ++r) acc += gs[r * C + c];
    dbp[part * C + c] = acc;
  }
}

size_t smem_bytes(int d, int C) {
  return ((size_t)TR * (d + 1) + (size_t)d * C + (size_t)TR * C + TR) *
         sizeof(float);
}

}  // namespace

extern "C" int probe_tile_rows() { return TR; }

// Shared memory one block needs at (d, C); the wrapper refuses shapes
// above the 227 KB a block may hold.
extern "C" long long probe_smem_bytes(int d, int C) {
  return (long long)smem_bytes(d, C);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int probe(const float* x, const int* y, const float* rwn,
                     const float* w, const float* b, float* lossp, float* dwp,
                     float* dbp, int K, int n, int d, int C, void* stream) {
  if (K <= 0 || n <= 0) return 0;
  const size_t smem = smem_bytes(d, C);
  if (d <= 0 || C <= 0 || smem > 232448) return (int)cudaErrorInvalidValue;
  // raise the dynamic shared-memory limit once per device (the first
  // launch, never inside a CUDA-graph capture of a later one)
  static size_t granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    e = cudaFuncSetAttribute(probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = smem;
  }
  const int tiles = (n + TR - 1) / TR;
  probe_kernel<<<dim3(tiles, K), THREADS, smem, (cudaStream_t)stream>>>(
      x, y, rwn, w, b, lossp, dwp, dbp, n, d, C, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
