// The intra-chunk block of Mamba2's chunked SSD on Hopper (sm_90a), fp32
// math on the CUDA cores.  For each batch b, chunk c of Lc positions and
// head h, with xdt = x * dt, a = dt * A[h] and cs the prefix sums of a over
// the chunk:
//
//     y[l]      = sum_{s <= l} (C[l] . B[s]) * exp(cs[l] - cs[s]) * xdt[s]
//     st[n, p]  = sum_s B[s, n] * exp(cs[Lc-1] - cs[s]) * xdt[s, p]
//
// x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, G, N), all fp32, in the
// model's layout; head h reads group g = h / (H / G).  Out: y_intra
// (B, S, H, P), so y = y_intra + y_inter needs no transpose, and the
// chunk-final states (B, S / Lc, H, N, P), the layout the inter-chunk
// recurrence consumes.
//
// Replaces: repro/kernels/ssd_chunk.py::_kernel (pallas_call in
// ssd_intra_chunk), which computes this block on (batch*chunk*head, Lc, .)
// operands that the caller first transposes and repeats per head.  No JAX
// model code calls it; the reference's models/mamba2.ssd_chunked computes
// the same block with einsums, and the port's ssd_chunked takes this kernel
// for it on the card (models/mamba2.py).
//
// What bounds it on the H100: operations.  Per (b, c, h), counting the
// lower triangle only: scores Lc(Lc+1)/2 * N * 2, y the same with P, states
// Lc * N * P * 2.  At zamba2's prefill (B 2, S 2048, H 80, N = P = 64,
// Lc 256; 1280 blocks) that is 13.5 GFLOP, 0.20 ms at 67 TFLOP/s of fp32;
// the bytes (x in and y out 84 MB each, states 21 MB, B, C and dt 3.4 MB)
// take 0.057 ms at 3.35 TB/s.  This first kernel runs fp32 FMAs on the
// CUDA cores with two shared-memory loads per FMA pair, as the flash kernel
// does; bf16 or TF32 tensor cores (wgmma, TMA) come later, under a bound of
// their own.
//
// Design.  A block owns one (b, c, h).  Warp 0 forms cs in float64 and
// rounds it once to fp32, as torch.cumsum does for fp32 on the CPU: with
// Lc <= 256 and log-decays within a factor 2^21 of each other the float64
// sums are exact in any order (24 + 21 + 8 bits fit in 53), so the kernel,
// the plain version on either device and the CPU agree on every bit of cs,
// whose differences make the decays.  The decay
// is exp(cs[l] - cs[s]) from those differences, as the reference takes it,
// never a product of per-step decays, and is computed only on and below
// the diagonal: above it the reference has exp(-inf) = 0, and exp of a
// positive difference could overflow.  The block walks 64-row tiles of l;
// for each it stages C_l once and then, tile by tile up to the diagonal,
// B_s and xdt_s (formed as loaded) in shared memory, forms the 64 x 64
// score tile, scales it by the decays and adds S x_s to y_l in registers.
// The last l tile meets every s tile exactly once, and there the block also
// adds B_s^T diag(exp(cs_end - cs_s)) x_s to the states.  Rows past Lc (a
// ragged chunk: the model takes Lc = min(ssm_chunk, S)) load as 0 and are
// never stored.  No atomics: every run gives the same bits.  No fast-math.
//
// Thread map (256 threads): tx = tid % 16, ty = tid / 16.  Scores: rows
// ty + 16 i, columns tx + 16 j (i, j < 4); y: rows ty + 16 i, p = tx + 16 j;
// states: n = ty + 16 i, p = tx + 16 j.  Shared memory: cs and the end
// decays (Lc each), C_l and B_s [64][N + 1], xdt_s [64][P], the score tile
// [64][80]; 72 KB at Lc 256, N = P = 64, so the launch raises the dynamic
// shared-memory limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TL = 64;                  // rows l of a tile (and rows s)
constexpr int NP_MAX = 64;              // largest N and P
constexpr int LC_MAX = 4096;            // largest chunk
constexpr int THREADS = 256;
constexpr int RPT = TL / 16;            // rows per thread
constexpr int DPT = NP_MAX / 16;        // p (or n) per thread
constexpr int LDS = TL + 16;            // score row: half-warps two banks apart

__host__ __device__ inline size_t smem_floats(int Lc, int N, int P) {
  return 2 * (size_t)Lc + 2 * (size_t)TL * (N + 1) + (size_t)TL * P +
         (size_t)TL * LDS;
}

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ st, int S, int H, int G, int N, int P,
           int Lc) {
  extern __shared__ float4 smem4[];
  const int ldn = N + 1;
  float* cs = reinterpret_cast<float*>(smem4);
  float* dend = cs + Lc;
  float* Cl = dend + Lc;
  float* Bs = Cl + TL * ldn;
  float* Xs = Bs + TL * ldn;
  float* Ss = Xs + TL * P;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t t0 = (size_t)b * S + (size_t)c * Lc;   // the chunk's first row
  const float Ah = A[h];

  if (tid < 32) {               // cs: an inclusive scan in float64, warp 0
    double carry = 0.0;
    for (int base = 0; base < Lc; base += 32) {
      const int s = base + tid;
      // a = dt * A is the fp32 product, as the reference's
      double v = s < Lc ? (double)(dt[(t0 + s) * H + h] * Ah) : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      v += carry;
      if (s < Lc) cs[s] = (float)v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int s = tid; s < Lc; s += THREADS) dend[s] = expf(cs[Lc - 1] - cs[s]);

  float sacc[DPT][DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) sacc[i][j] = 0.f;

  const int n_tiles = (Lc + TL - 1) / TL;
  for (int lt = 0; lt < n_tiles; ++lt) {
    const int l0 = lt * TL;
    const bool last = lt == n_tiles - 1;
    float yacc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) yacc[i][j] = 0.f;

    __syncthreads();            // the previous tile's C_l is read
    for (int e = tid; e < TL * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      Cl[r * ldn + n] =
          l0 + r < Lc ? Cm[((t0 + l0 + r) * G + g) * N + n] : 0.f;
    }

    for (int s0 = 0; s0 <= l0; s0 += TL) {     // s tiles up to the diagonal
      __syncthreads();          // the previous s tile's B, xdt, S are read
      for (int e = tid; e < TL * N; e += THREADS) {
        const int r = e / N, n = e - r * N;
        Bs[r * ldn + n] =
            s0 + r < Lc ? Bm[((t0 + s0 + r) * G + g) * N + n] : 0.f;
      }
      for (int e = tid; e < TL * P; e += THREADS) {
        const int r = e / P, p = e - r * P;
        const size_t row = (t0 + s0 + r) * H + h;
        Xs[r * P + p] = s0 + r < Lc ? x[row * P + p] * dt[row] : 0.f;
      }
      __syncthreads();

      float sc[RPT][RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) sc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RPT], bv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) cv[i] = Cl[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < RPT; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < RPT; ++j)
            sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int l = l0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int s = s0 + tx + 16 * j;
          // the decay only on and below the diagonal, inside the chunk
          Ss[(ty + 16 * i) * LDS + tx + 16 * j] =
              s <= l && l < Lc ? sc[i][j] * expf(cs[l] - cs[s]) : 0.f;
        }
      }
      __syncthreads();

      for (int s = 0; s < TL; ++s) {
        float sv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) sv[i] = Ss[(ty + 16 * i) * LDS + s];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int p = tx + 16 * j;
          if (p < P) {
            const float xv = Xs[s * P + p];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              yacc[i][j] = fmaf(sv[i], xv, yacc[i][j]);
          }
        }
      }
      if (last) {               // every s tile once: the chunk-final states
        const int s_end = min(TL, Lc - s0);
        for (int s = 0; s < s_end; ++s) {
          const float w = dend[s0 + s];
          float bw[DPT], xv[DPT];
#pragma unroll
          for (int i = 0; i < DPT; ++i) {
            const int n = ty + 16 * i;
            bw[i] = n < N ? Bs[s * ldn + n] * w : 0.f;
          }
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            const int p = tx + 16 * j;
            xv[j] = p < P ? Xs[s * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < DPT; ++i)
#pragma unroll
            for (int j = 0; j < DPT; ++j)
              sacc[i][j] = fmaf(bw[i], xv[j], sacc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int l = l0 + ty + 16 * i;
      if (l >= Lc) continue;
      float* yr = y + ((t0 + l) * H + h) * P;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int p = tx + 16 * j;
        if (p < P) yr[p] = yacc[i][j];
      }
    }
  }

  const int Nc = S / Lc;
  float* sb = st + (((size_t)b * Nc + c) * H + h) * N * P;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int p = tx + 16 * j;
      if (p < P) sb[n * P + p] = sacc[i][j];
    }
  }
}

}  // namespace

extern "C" int ssd_intra_chunk_max_np() { return NP_MAX; }
extern "C" int ssd_intra_chunk_max_chunk() { return LC_MAX; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ssd_intra_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* st, int B, int S, int H, int G, int N,
                               int P, int Lc, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > NP_MAX || P <= 0 ||
      P > NP_MAX || Lc <= 0 || Lc > LC_MAX || S % Lc != 0 ||
      S / Lc > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // raise the dynamic shared-memory limit once per device and size, so the
  // launch itself can be captured in a CUDA graph
  static size_t granted[64] = {};
  const size_t smem = smem_floats(Lc, N, P) * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    e = cudaFuncSetAttribute(ssd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = smem;
  }
  const dim3 grid(H, S / Lc, B);
  ssd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st), S, H, G, N, P, Lc);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_intra_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
