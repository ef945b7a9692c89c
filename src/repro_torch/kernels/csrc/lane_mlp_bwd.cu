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
// the 67 TFLOP/s of the CUDA cores (4.2 us over the eight Table-3 MLPs at
// B = 128), the bytes a factor 2-4 lower.  At that batch the work is small
// and the time is how many SMs the grid fills and how long each block's
// chain of dependent steps is.
//
// Design.  g1 needs whole rows of g2 @ w1^T before dW0 and dx can start, so
// the backward is two launches of one kernel, each a flat grid of small
// independent tiles (no clusters, no atomics):
//
//   launch 1: dW1 and db1 tiles (32 x 32 outputs, over all rows), and g1
//             tiles (16 rows x 16 hidden units) into an (L, B, h) scratch;
//   launch 2: dW0 and db0 tiles, and dx tiles (16 rows x 16 inputs), both
//             reading g1; dx tiles only when dx is wanted.
//
// Both kinds of tile keep the sum orders of the kernel this one replaced,
// so the results are the same bits:
// - g1 and dx ("strided dot"): each output's sum over k is 32 chains, lane
//   l summing k = l, l + 32, ... in ascending order, then an xor butterfly
//   over the lanes (offsets 16, 8, 4, 2, 1).  A warp owns 32 outputs (4
//   rows x 8 columns): each lane runs its chain for all 32 at once from
//   k-slabs in shared memory (4 + 8 conflict-free reads per 32 FMAs), and
//   the butterfly is done transposed: at each level a lane keeps half its
//   outputs and sends the other half to its partner, 31 shuffles for all
//   32 outputs instead of 160, with the same pairs added.  Lane l ends with
//   output l.
// - dW and db ("row sums"): each element is a sequential fmaf chain over
//   the rows of each 32-row tile, from 0, and the tile partials are summed
//   in four running sums by tile index mod 4, then ((s0 + s1) + s2) + s3:
//   the order in which torch.sum reduced the old kernel's partials over
//   fewer than 64 tiles.  The block's four warp pairs take the four tiles
//   of each 128-row chunk, so the tile partials are computed in parallel
//   and each group keeps one running sum; each thread owns 4 x 4 elements
//   and reads one 16-byte row slice of each operand per row.  db1 and db0
//   are one more row of dW1 and dW0, of ones (fmaf(1, v, s) rounds as
//   s + v does).
// selu(a1), g2 and the ones are made as the operands are staged into
// shared memory; ragged rows, columns and k are staged as zeros and add
// exact zeros (a chain from +0 never holds -0).  A lane whose g is zero (a
// dead lane) gives exact zeros.  No fast-math: selu' uses expf and selu
// expm1f, the form and constants of jax.nn.selu.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SR = 16, SC = 16;   // a strided-dot tile: rows x columns
constexpr int KS = 128;           // k of a staged slab: 4 lane-strided steps
constexpr int TM = 32;            // rows of a weight-gradient tile partial
constexpr int RC = 4 * TM;        // rows of a staged chunk: 4 tiles
constexpr int WT = 32;            // a row-sum tile: 32 x 32 elements
constexpr int SMEM_FLOATS = 2 * RC * WT;     // the larger of the two uses
static_assert(SR == SC && 2 * SR * KS <= SMEM_FLOATS, "strided slabs fit");
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

__device__ __forceinline__ float dselu(float a) {
  return SELU_SCALE * (a > 0.f ? 1.f : SELU_ALPHA * expf(a));
}

// One level of the transposed butterfly over N of a lane's 2N outputs: the
// lane with bit N set keeps the upper half, its partner the lower, and each
// adds the partner's value of the half it keeps.
template <int N>
__device__ __forceinline__ void tree_level(float (&v)[32], int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

// out[row][col] = epi(sum_k A[row][k] * W[col][k]) for a tile of SR rows x
// SC columns from row0, col0: A (B, K) (times selu'(Ad) elementwise when Ad
// is set, which makes g2 of g), W (nc, K); epi multiplies by selu'(a1)
// [row][col] when a1 is set.  out is (B, nc).
__device__ void strided_dot_tile(float* smem, const float* __restrict__ A,
                                 const float* __restrict__ Ad,
                                 const float* __restrict__ W,
                                 const float* __restrict__ a1,
                                 float* __restrict__ out, int B, int K,
                                 int nc, int row0, int col0) {
  float* As = smem;                 // [SR][KS]
  float* Ws = smem + SR * KS;       // [SC][KS]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int wr = warp / 2, wc = warp % 2;   // 4 rows x 8 columns a warp
  float acc[32];
#pragma unroll
  for (int m = 0; m < 32; ++m) acc[m] = 0.f;

  constexpr int PER = SR * KS / THREADS;    // elements a thread stages
  for (int k0 = 0; k0 < K; k0 += KS) {
    float av[PER], dv[PER], wv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {         // all loads first, then stores
      const int e = t + i * THREADS, r = e / KS, k = k0 + e % KS;
      const bool ka = row0 + r < B && k < K, kw = col0 + r < nc && k < K;
      const size_t ia = (size_t)(row0 + r) * K + k;
      av[i] = ka ? A[ia] : 0.f;
      dv[i] = ka && Ad ? Ad[ia] : 0.f;
      wv[i] = kw ? W[(size_t)(col0 + r) * K + k] : 0.f;
    }
    __syncthreads();                        // the last slab is consumed
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = t + i * THREADS;
      As[e] = Ad ? av[i] * dselu(dv[i]) : av[i];
      Ws[e] = wv[i];
    }
    __syncthreads();
    const float* ap = As + wr * 4 * KS + lane;
    const float* wp = Ws + wc * 8 * KS + lane;
#pragma unroll
    for (int s = 0; s < KS / 32; ++s) {
      if (k0 + s * 32 >= K) break;
      float a[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ap[i * KS + s * 32];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = wp[j * KS + s * 32];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i * 8 + j] = fmaf(a[i], w[j], acc[i * 8 + j]);
    }
  }
  tree_level<16>(acc, lane);
  tree_level<8>(acc, lane);
  tree_level<4>(acc, lane);
  tree_level<2>(acc, lane);
  tree_level<1>(acc, lane);
  const int row = row0 + wr * 4 + lane / 8, col = col0 + wc * 8 + lane % 8;
  if (row < B && col < nc) {
    const size_t o = (size_t)row * nc + col;
    out[o] = a1 ? dselu(a1[o]) * acc[0] : acc[0];
  }
}

// dw[a][b] = sum_rows A[row][a] * Bm[row][b] for a tile of WT x WT from a0,
// b0, with row a == Ka of A all ones (its sums go to db[b]): A (B, Ka)
// (selu'd when selu_a), Bm (B, nb) (times selu'(Bd) when Bd is set); dw
// (Ka, nb), db (nb).
__device__ void row_sum_tile(float* smem, const float* __restrict__ A,
                             bool selu_a, const float* __restrict__ Bm,
                             const float* __restrict__ Bd,
                             float* __restrict__ dw, float* __restrict__ db,
                             int B, int Ka, int nb, int a0, int b0) {
  float* As = smem;                 // [RC][WT]
  float* Bs = smem + RC * WT;       // [RC][WT]
  const int t = threadIdx.x, grp = t / 64, q = t % 64;
  const int ta = q / 8 * 4, tb = q % 8 * 4;   // 4 x 4 elements a thread
  float s[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) s[m] = 0.f;

  constexpr int PER = RC * WT / THREADS, BATCH = 8;
  for (int r0 = 0; r0 < B; r0 += RC) {
    __syncthreads();                        // the last chunk is consumed
#pragma unroll 1
    for (int i0 = 0; i0 < PER; i0 += BATCH) {   // 8 loads of each in flight
      float av[BATCH], bv[BATCH], dv[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int e = t + (i0 + i) * THREADS, r = r0 + e / WT, c = e % WT;
        const int a = a0 + c, b = b0 + c;
        av[i] = r < B && a < Ka ? A[(size_t)r * Ka + a]
                                : (r < B && a == Ka ? 1.f : 0.f);
        const bool kb = r < B && b < nb;
        bv[i] = kb ? Bm[(size_t)r * nb + b] : 0.f;
        dv[i] = kb && Bd ? Bd[(size_t)r * nb + b] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int e = t + (i0 + i) * THREADS, r = r0 + e / WT;
        const int a = a0 + e % WT;
        As[e] = selu_a && r < B && a < Ka ? selu(av[i]) : av[i];
        Bs[e] = Bd ? bv[i] * dselu(dv[i]) : bv[i];
      }
    }
    __syncthreads();
    // group grp takes tile r0 / TM + grp, whose index is grp mod 4
    float acc[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) acc[m] = 0.f;
    const float* ap = As + grp * TM * WT + ta;
    const float* bp = Bs + grp * TM * WT + tb;
#pragma unroll 8
    for (int r = 0; r < TM; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(ap + r * WT);
      const float4 y = *reinterpret_cast<const float4*>(bp + r * WT);
      const float xa[4] = {x.x, x.y, x.z, x.w};
      const float yb[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i * 4 + j] = fmaf(xa[i], yb[j], acc[i * 4 + j]);
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) s[m] += acc[m];
  }
  __syncthreads();                  // the chunks are consumed
  float* red = smem;                // [4][WT][WT]: each group's running sum
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(grp * WT + ta + i) * WT + tb + j] = s[i * 4 + j];
  __syncthreads();
  for (int o = t; o < WT * WT; o += THREADS) {
    const int a = a0 + o / WT, b = b0 + o % WT;
    const float v = ((red[o] + red[WT * WT + o]) + red[2 * WT * WT + o]) +
                    red[3 * WT * WT + o];
    if (b < nb) {
      if (a < Ka) dw[(size_t)a * nb + b] = v;
      else if (a == Ka) db[b] = v;
    }
  }
}

struct Args {
  const float *g, *x, *a1, *a2, *w0, *w1;
  float *g1, *dx, *dw0, *db0, *dw1, *db1;
  int B, din, h, dz, final_act;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// launch 1 (stage 0): dW1/db1 tiles, then g1 tiles; launch 2 (stage 1):
// dW0/db0 tiles, then dx tiles.  Grid axis 1 is the lane.
__global__ void __launch_bounds__(THREADS, 2)   // two blocks an SM
lane_mlp_bwd_kernel(Args p, int stage) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const size_t l = blockIdx.y;
  const int B = p.B, din = p.din, h = p.h, dz = p.dz;
  const float* g = p.g + l * B * dz;
  const float* a2 = p.final_act ? p.a2 + l * B * dz : nullptr;
  const float* a1 = p.a1 + l * B * h;
  float* g1 = p.g1 + l * B * h;
  int bx = blockIdx.x;
  if (stage == 0) {
    const int nb = cdiv(dz, WT), nw = cdiv(h + 1, WT) * nb;
    if (bx < nw) {
      row_sum_tile(smem, a1, true, g, a2, p.dw1 + l * h * dz, p.db1 + l * dz,
                   B, h, dz, bx / nb * WT, bx % nb * WT);
      return;
    }
    bx -= nw;
    const int nc = cdiv(h, SC);
    strided_dot_tile(smem, g, a2, p.w1 + l * h * dz, a1, g1, B, dz, h,
                     bx / nc * SR, bx % nc * SC);
  } else {
    const int nb = cdiv(h, WT), nw = cdiv(din + 1, WT) * nb;
    if (bx < nw) {
      row_sum_tile(smem, p.x + l * B * din, false, g1, nullptr,
                   p.dw0 + l * din * h, p.db0 + l * h, B, din, h,
                   bx / nb * WT, bx % nb * WT);
      return;
    }
    bx -= nw;
    const int nc = cdiv(din, SC);
    strided_dot_tile(smem, g1, nullptr, p.w0 + l * din * h, nullptr,
                     p.dx + l * B * din, B, h, din, bx / nc * SR,
                     bx % nc * SC);
  }
}

}  // namespace

// Launches the two stages on `stream`; returns the first launch error (0 =
// launched).  g1_scratch (L, B, h) carries g1 from the first launch to the
// second; dx may be null (then the second launch has no dx tiles).
// Gradients: dw0 (L, din, h), db0 (L, h), dw1 (L, h, dz), db1 (L, dz).
extern "C" int lane_mlp_bwd(const float* g, const float* x, const float* a1,
                            const float* a2, const float* w0, const float* w1,
                            float* dx, float* dw0, float* db0, float* dw1,
                            float* db1, float* g1_scratch, int L, int B,
                            int din, int h, int dz, int final_act,
                            void* stream) {
  if (L <= 0 || B <= 0) return 0;
  const long long rows = cdiv(B, SR);
  const long long n1 = (long long)cdiv(h + 1, WT) * cdiv(dz, WT) +
                       rows * cdiv(h, SC);
  const long long n2 = (long long)cdiv(din + 1, WT) * cdiv(h, WT) +
                       (dx ? rows * cdiv(din, SC) : 0);
  if (din <= 0 || h <= 0 || dz <= 0 || L > 65535 || n1 > 0x7fffffffLL ||
      n2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Args p = {g, x, a1, a2, w0, w1, g1_scratch, dx, dw0, db0, dw1, db1,
                  B, din, h, dz, final_act};
  lane_mlp_bwd_kernel<<<dim3((unsigned)n1, L), THREADS, 0, s>>>(p, 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lane_mlp_bwd_kernel<<<dim3((unsigned)n2, L), THREADS, 0, s>>>(p, 1);
  return (int)cudaGetLastError();
}

extern "C" const char* lane_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
