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
// (g1_active 5->64->128, g3 5->256->256, g2 384->256->256), every
// autoencoder forward in training, and the million-row scale lanes
// (16 -> 32 -> 64 and back, 16 lanes of 8,192 rows, and 100,000 rows a
// validation pass).
//
// Two routes, picked by the launcher from the widths alone, with the same
// bits (each output one fmaf chain over k ascending from 0, the bias added
// last; see the notes at each route).
//
// The cluster route (every shape the narrow route does not take).
// What bounds it on the H100: counted as work, 2*B*(din*h + h*dz) fp32
// operations against the 67 TFLOP/s of the CUDA cores, and, a factor 3-4
// lower at every Table-3 shape, the bytes of x, the weights and out against
// 3.35 TB/s.  At the serving buckets (16-256 rows) the work is 0.1-2 us and
// the time is latency: a grid too small for 132 SMs, and in each block a
// chain of dependent loads and FMAs as long as the sum over k.
//
// Design.  A tile of BM = 16 rows of one lane belongs to a cluster of C
// blocks (the wrapper picks C in {1, 2, 4, 8} so that the grid covers the
// card; C = 8 at the serving buckets and the training batch).
// - Block r of the cluster computes hidden units [r h/C, (r+1) h/C) of the
//   tile and stores selu(a1) for them into the shared memory of every
//   block of the cluster (distributed shared memory), so that after one
//   cluster barrier each block holds the whole BM x h hidden activation;
//   it then computes output columns [r dz/C, (r+1) dz/C).  Each block
//   streams 1/C of w0 and w1, and the hidden activation never reaches
//   device memory, which is the point of the fused TPU kernel.  Stores
//   into a peer wait until the whole cluster runs (the first half of a
//   split barrier, arrived at the start); nothing is read from a peer, so
//   no barrier is needed before a block exits.
// - Weight k-slabs (KS = 64 rows x 32 columns) and, in the first layer, x
//   k-slabs (16 rows x 64) stream through a ring of 4 stages in shared
//   memory with cp.async, 3 slabs in flight, in 16-byte copies where the
//   rows are 16-byte aligned (4-byte copies for din or dz not a multiple of
//   4).  Out-of-range rows, columns and k are zero-filled by the copies;
//   they add exact zeros.
// - Each thread owns a 1-row x 4-column micro-tile: per k one broadcast
//   read of its row's value and one 16-byte read of four weights feed four
//   FMAs; a warp's reads touch four rows 4 banks apart and 128 contiguous
//   bytes of weights, so there are no bank conflicts.
// - Each output's sum over k runs in ascending k from 0 with the bias added
//   last, one thread per output, so its rounding does not depend on C or
//   on the tile.  No atomics, the same result on every run.
// What holds it back (PERF.md, tools/kernel_variants.py): a block has
// four warps, one per scheduler, so each k-step's shared-memory reads and
// FMAs wait on one another, and the chain of k-steps is the block's time.
// At narrow widths over long batches it is worse still: KS = 64 runs 64
// k-steps on zeros at din 16, a 32-column pass leaves half the threads idle
// at dz 16, and every 16-row tile stages its weights again.
//
// The narrow route (every width a multiple of 4, at most NARROW_MAX = 64).
// What bounds it: the bytes of x, a1, a2 and out, 4*L*B*(din + h + 2 dz)
// with save, against 3.35 TB/s (27.6 us at the scale encoder, 20.1 at the
// decoder, 16 lanes of 8,192 rows); its operations are 2.8x lower.
// Design: a block of 256 threads takes 128 rows of one lane.
// - The lane's weights and biases (2,656 floats at the scale encoder) and
//   the block's rows of x go to shared memory once, every 16-byte cp.async
//   in flight at once and one wait; rows past B are zero-filled.
// - Each layer's k loop runs to exactly din and h.  A thread owns units of
//   R rows x 4 columns (R <= 4, as many as fill the block once; 8 took 105
//   registers and two blocks an SM), the R rows 128 / R apart: per 4 k, R +
//   4 16-byte shared reads feed 16 R FMAs, and a warp's stores of one of
//   its rows cover whole consecutive rows of a1, a2 and out, so they leave
//   as coalesced 16-byte stores straight from registers.  selu(a1) stays
//   in shared memory for the second layer.
// - The same bits as the cluster route: one fmaf chain an output, k
//   ascending from 0, the bias last.  The cluster route ran k to a multiple
//   of 64 on zeros, which turns a chain's -0 into +0 before the bias; a
//   "+ 0.f" does the same here where din or h is not a multiple of 64.
// 56 registers, no spills; 39 KB of shared memory at the scale encoder, 64
// KB at the decoder.
// The lane axis is grid axis 1 on both routes.  No fast-math: SELU uses
// expm1f, the form and constants of jax.nn.selu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 16;          // rows of a tile
constexpr int TN = 4;           // columns a thread owns (one row)
constexpr int THREADS = 128;    // BM rows x (PC / TN) column groups
constexpr int PC = THREADS / BM * TN;     // columns of a pass: 32
constexpr int KS = 64;          // k rows of a staged slab
constexpr int NS = 4;           // slabs in the ring: up to 3 in flight
constexpr int LDX = KS + 4;     // row stride of an x slab [BM][KS]: rows
                                // 4 banks apart, 16-byte aligned
constexpr int MAX_HIDDEN = 2048;
constexpr float SELU_ALPHA = 1.6732632423543772848170429916717f;
constexpr float SELU_SCALE = 1.0507009873554804934193349852946f;

__device__ __forceinline__ float selu(float a) {
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * expm1f(a));
}

// global -> shared, asynchronously: the first `n` bytes of 4 (or 16),
// the rest zero-filled
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// The cluster barrier in halves.  A relaxed arrive at the start and its
// wait before the first store into a peer's shared memory make sure that
// every block of the cluster is running; a release arrive and an acquire
// wait then make the stores visible to the peers.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// slab s of a ring has landed once at most NS - 2 later groups are pending
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2) : "memory");
}

// One layer's pass over columns [p0, c1) (at most PC) for the tile:
// acc[j] = sum over k ascending of A[row][k] * w[k][p0 + TN cgr + j], with
// A the x rows (first layer, streamed with the weights) or the hidden
// activation in shared memory (second).  The weight slab [KS][PC] and the
// x slab [BM][LDX] of k-slab s go to ring stage s % NS, with NS - 1 slabs
// in flight; every copy is 16 bytes where the rows allow, and out-of-range
// rows, columns and k are zero-filled, so they add exact zeros.
struct Pass {
  const float* w;       // (Kdim, ldw)
  int ldw, Kdim;
  const float* x;       // (rows, Kdim) x rows, or null: A = hs
  int rows;
  const float* hs;      // [BM][ldh] hidden activation (second layer)
  int ldh;
  float* xs;            // ring of NS x slabs
  float* ws;            // ring of NS weight slabs
};

__device__ __forceinline__ void load_slab(const Pass& P, int p0, int c1,
                                          int s) {
  const int t = threadIdx.x, k0 = s * KS, st = s % NS;
  float* ws = P.ws + st * KS * PC;
  if (P.ldw % 4 == 0) {               // p0 is a multiple of 4: aligned
    const int c = (t % (PC / 4)) * 4;
    const int n = max(0, min(4, c1 - p0 - c)) * 4;
#pragma unroll
    for (int j = 0; j < KS * PC / 4 / THREADS; ++j) {
      const int kk = t / (PC / 4) + j * (THREADS / (PC / 4));
      const bool ok = n && k0 + kk < P.Kdim;
      cp_async16(ws + kk * PC + c,
                 ok ? P.w + (size_t)(k0 + kk) * P.ldw + p0 + c : P.w,
                 ok ? n : 0);
    }
  } else {
    const int c = t % PC;
    const bool in = p0 + c < c1;
#pragma unroll 4
    for (int j = 0; j < KS * PC / THREADS; ++j) {
      const int kk = t / PC + j * (THREADS / PC);
      const bool ok = in && k0 + kk < P.Kdim;
      cp_async4(ws + kk * PC + c,
                ok ? P.w + (size_t)(k0 + kk) * P.ldw + p0 + c : P.w,
                ok ? 4 : 0);
    }
  }
  if (!P.x) return;
  float* xs = P.xs + st * BM * LDX;
  if (P.Kdim % 4 == 0) {              // x rows are 16-byte aligned
    const int kc = (t % (KS / 4)) * 4;
    const int n = max(0, min(4, P.Kdim - k0 - kc)) * 4;
#pragma unroll
    for (int j = 0; j < BM * KS / 4 / THREADS; ++j) {
      const int r = t / (KS / 4) + j * (THREADS / (KS / 4));
      const bool ok = n && r < P.rows;
      cp_async16(xs + r * LDX + kc,
                 ok ? P.x + (size_t)r * P.Kdim + k0 + kc : P.x, ok ? n : 0);
    }
  } else {
    const int kk = t % KS;
    const bool in = k0 + kk < P.Kdim;
#pragma unroll 4
    for (int j = 0; j < BM * KS / THREADS; ++j) {
      const int r = t / KS + j * (THREADS / KS);
      const bool ok = in && r < P.rows;
      cp_async4(xs + r * LDX + kk,
                ok ? P.x + (size_t)r * P.Kdim + k0 + kk : P.x, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void run_pass(float (&acc)[TN], const Pass& P,
                                         int p0, int c1) {
  const int t = threadIdx.x;
  const int r = t / (PC / TN), cgr = t % (PC / TN);
  const int nk = (P.Kdim + KS - 1) / KS;
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) load_slab(P, p0, c1, s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait_ring();
    __syncthreads();                    // slab s is in, stage s - 1 is free
    if (s + NS - 1 < nk) load_slab(P, p0, c1, s + NS - 1);
    cp_async_commit();
    const float* a = P.x ? P.xs + (s % NS) * BM * LDX + r * LDX
                         : P.hs + r * P.ldh + s * KS;
    const float* w = P.ws + (s % NS) * KS * PC + cgr * TN;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float av = a[kk];
      const float4 wv = *reinterpret_cast<const float4*>(w + kk * PC);
      acc[0] = fmaf(av, wv.x, acc[0]);
      acc[1] = fmaf(av, wv.y, acc[1]);
      acc[2] = fmaf(av, wv.z, acc[2]);
      acc[3] = fmaf(av, wv.w, acc[3]);
    }
  }
  __syncthreads();                      // the ring is free for the next pass
}

__global__ void __launch_bounds__(THREADS)
lane_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, float* __restrict__ out,
                    float* __restrict__ a1_out, float* __restrict__ a2_out,
                    int B, int din, int h, int dz, int final_act) {
  extern __shared__ float4 smem4[];
  const int ldh = (h + KS - 1) / KS * KS + 4;   // hidden row stride
  float* xs = reinterpret_cast<float*>(smem4);  // [NS][BM][LDX]
  float* ws = xs + NS * BM * LDX;               // [NS][KS][PC]
  float* hs = ws + NS * KS * PC;                // [BM][ldh]

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.y;
  const int row0 = (blockIdx.x / C) * BM;
  const int rows = min(BM, B - row0);
  const int t = threadIdx.x;
  const int r = t / (PC / TN), cgr = t % (PC / TN);

  x += ((size_t)lane * B + row0) * din;
  w0 += (size_t)lane * din * h;
  b0 += (size_t)lane * h;
  w1 += (size_t)lane * h * dz;
  b1 += (size_t)lane * dz;
  out += ((size_t)lane * B + row0) * dz;
  if (a1_out) a1_out += ((size_t)lane * B + row0) * h;
  if (a2_out) a2_out += ((size_t)lane * B + row0) * dz;

  // hidden columns past h are read as zeros by the last k-slab of layer 2
  for (int i = t; i < BM * (ldh - h); i += THREADS)
    hs[(i / (ldh - h)) * ldh + h + i % (ldh - h)] = 0.f;
  cluster_arrive_relaxed();

  // layer 1: this block's hidden units (a multiple of 4 of them, so that
  // 16-byte copies stay aligned), selu(a1) into its columns of hs in every
  // block of the cluster
  const int hc = ((h + C - 1) / C + 3) / 4 * 4;
  const int h0 = min(h, rank * hc), h1 = min(h, h0 + hc);
  const Pass l1 = {w0, h, din, x, rows, hs, ldh, xs, ws};
  cluster_wait();                       // every block of the cluster runs
  for (int p0 = h0; p0 < h1; p0 += PC) {
    float acc[TN] = {};
    run_pass(acc, l1, p0, h1);
    const int col = p0 + cgr * TN;
    float hv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float a = acc[j] + (col + j < h1 ? b0[col + j] : 0.f);
      if (a1_out && r < rows && col + j < h1)
        a1_out[(size_t)r * h + col + j] = a;
      hv[j] = selu(a);
    }
    if (col < h1) {                     // col + 3 < ldh: hs has room
      const float4 v = make_float4(hv[0], hv[1], hv[2], hv[3]);
      for (int q = 0; q < C; ++q)       // through distributed shared memory
        *reinterpret_cast<float4*>(cluster.map_shared_rank(hs, q) +
                                   r * ldh + col) = v;
    }
  }
  cluster_arrive();                     // every block holds the whole
  cluster_wait();                       // hidden activation of the tile

  // layer 2: this block's output columns from the whole hidden activation
  const int zc = ((dz + C - 1) / C + 3) / 4 * 4;
  const int z0 = min(dz, rank * zc), z1 = min(dz, z0 + zc);
  const Pass l2 = {w1, dz, h, nullptr, rows, hs, ldh, xs, ws};
  for (int p0 = z0; p0 < z1; p0 += PC) {
    float acc[TN] = {};
    run_pass(acc, l2, p0, z1);
    const int col = p0 + cgr * TN;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (col + j < z1) {
          const float a = acc[j] + b1[col + j];
          if (a2_out) a2_out[(size_t)r * dz + col + j] = a;
          out[(size_t)r * dz + col + j] = final_act ? selu(a) : a;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The narrow route: every width a multiple of 4 and at most NARROW_MAX.
// ---------------------------------------------------------------------------

constexpr int NARROW_MAX = 64;
constexpr bool narrow_width(int w) {
  return w > 0 && w <= NARROW_MAX && w % 4 == 0;
}
constexpr int NROWS = 128;              // rows a block
constexpr int NTHREADS = 256;

// The smallest row stride >= k that is 4 mod 8 floats: 16-byte aligned,
// and eight rows read at one column land on eight distinct 4-bank groups.
__host__ __device__ constexpr int pad_ld(int k) { return (k + 3) / 8 * 8 + 4; }

// Rows [0, n) x quads [0, q) of dst (row stride ld), asynchronously: row
// r < valid from src (row stride 4 q), the rest zero-filled.
__device__ __forceinline__ void stage_async(float* dst, int ld,
                                            const float* src, int n,
                                            int valid, int q) {
  for (int e = threadIdx.x; e < n * q; e += NTHREADS) {
    const int r = e / q, k = e - r * q;
    cp_async16(dst + r * ld + 4 * k,
               r < valid ? src + (size_t)r * 4 * q + 4 * k : src,
               r < valid ? 16 : 0);
  }
}

// One layer over the block's NROWS rows: v[r][c] = (sum over k ascending
// from 0 of A[r][k] * W[k][c], plus 0 where zero_k) + bias[c], handed to
// epi(r, c, v[r][c..c+3]).  A (NROWS x K, row stride lda) and W (K x n,
// row-major) in shared memory; a unit is R rows (R apart, so that a warp's
// stores of one of them cover whole consecutive rows) x 4 columns.
template <int R, typename Epi>
__device__ __forceinline__ void narrow_layer(const float* __restrict__ A,
                                             int lda,
                                             const float* __restrict__ W,
                                             const float* __restrict__ bias,
                                             int K, int n, bool zero_k,
                                             Epi epi) {
  const int ng = n / 4;
  for (int u = threadIdx.x; u < NROWS / R * ng; u += NTHREADS) {
    const int cg = u % ng, rg = u / ng;
    float acc[R][4] = {};
    for (int k = 0; k < K; k += 4) {
      float4 a[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            A + (rg + i * (NROWS / R)) * lda + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w =
            *reinterpret_cast<const float4*>(W + (k + kk) * n + cg * 4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, w.x, acc[i][0]);
          acc[i][1] = fmaf(av, w.y, acc[i][1]);
          acc[i][2] = fmaf(av, w.z, acc[i][2]);
          acc[i][3] = fmaf(av, w.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (zero_k ? acc[i][j] + 0.f : acc[i][j]) + bias[cg * 4 + j];
      epi(rg + i * (NROWS / R), cg * 4, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

// Units of R rows: as many as fill the block's threads once, at most 4
// (8 took 105 registers, two blocks an SM, and 30% more time).
template <typename Epi>
__device__ __forceinline__ void narrow_layer_any(const float* A, int lda,
                                                 const float* W,
                                                 const float* bias, int K,
                                                 int n, bool zero_k, Epi epi) {
  const int fill = NROWS * (n / 4) / NTHREADS;
  if (fill >= 4) narrow_layer<4>(A, lda, W, bias, K, n, zero_k, epi);
  else if (fill >= 2) narrow_layer<2>(A, lda, W, bias, K, n, zero_k, epi);
  else narrow_layer<1>(A, lda, W, bias, K, n, zero_k, epi);
}

__device__ __forceinline__ float4 selu4(float4 v) {
  return make_float4(selu(v.x), selu(v.y), selu(v.z), selu(v.w));
}

__global__ void __launch_bounds__(NTHREADS)
lane_mlp_fwd_narrow_kernel(const float* __restrict__ x,
                           const float* __restrict__ w0,
                           const float* __restrict__ b0,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           float* __restrict__ out, float* __restrict__ a1_out,
                           float* __restrict__ a2_out, int B, int din, int h,
                           int dz, int final_act) {
  extern __shared__ float4 smem4[];
  const int ldx = pad_ld(din), ldh = pad_ld(h);
  float* w0s = reinterpret_cast<float*>(smem4);   // [din][h]
  float* b0s = w0s + din * h;                     // [h]
  float* w1s = b0s + h;                           // [h][dz]
  float* b1s = w1s + h * dz;                      // [dz]
  float* xs = b1s + dz;                           // [NROWS][ldx]
  float* hs = xs + NROWS * ldx;                   // [NROWS][ldh]: selu(a1)

  const int lane = blockIdx.y, t = threadIdx.x;
  const int row0 = blockIdx.x * NROWS;
  const int rows = min(NROWS, B - row0);
  x += ((size_t)lane * B + row0) * din;
  w0 += (size_t)lane * din * h;
  b0 += (size_t)lane * h;
  w1 += (size_t)lane * h * dz;
  b1 += (size_t)lane * dz;
  out += ((size_t)lane * B + row0) * dz;
  if (a1_out) a1_out += ((size_t)lane * B + row0) * h;
  if (a2_out) a2_out += ((size_t)lane * B + row0) * dz;

  // the lane's weights and biases once, and the block's rows of x (zeros
  // past B): every 16-byte copy in flight at once
  stage_async(w0s, h, w0, din, din, h / 4);
  stage_async(w1s, dz, w1, h, h, dz / 4);
  stage_async(b0s, h, b0, 1, 1, h / 4);
  stage_async(b1s, dz, b1, 1, 1, dz / 4);
  stage_async(xs, ldx, x, NROWS, rows, din / 4);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the parent kernel ran k to a multiple of 64 on zeros, which turns a
  // sum of -0 into +0: so does "+ 0.f" here
  narrow_layer_any(xs, ldx, w0s, b0s, din, h, din % 64 != 0,
                   [&](int r, int c, float4 v) {
                     if (a1_out && r < rows)
                       *reinterpret_cast<float4*>(a1_out + (size_t)r * h + c) = v;
                     *reinterpret_cast<float4*>(hs + r * ldh + c) = selu4(v);
                   });
  __syncthreads();
  narrow_layer_any(hs, ldh, w1s, b1s, h, dz, h % 64 != 0,
                   [&](int r, int c, float4 v) {
                     if (r >= rows) return;
                     if (a2_out)
                       *reinterpret_cast<float4*>(a2_out + (size_t)r * dz + c) = v;
                     *reinterpret_cast<float4*>(out + (size_t)r * dz + c) =
                         final_act ? selu4(v) : v;
                   });
}

size_t narrow_smem(int din, int h, int dz) {
  return ((size_t)din * h + h + (size_t)h * dz + dz +
          (size_t)NROWS * (pad_ld(din) + pad_ld(h))) * sizeof(float);
}

}  // namespace

extern "C" int lane_mlp_fwd_max_hidden() { return MAX_HIDDEN; }

// Rows of the tile a cluster of blocks shares.
extern "C" int lane_mlp_fwd_tile_rows() { return BM; }

// `cluster` blocks (1, 2, 4 or 8) share each tile of BM rows.  Launches on
// `stream`; returns the launch's error code (0 = launched).
extern "C" int lane_mlp_fwd(const float* x, const float* w0, const float* b0,
                            const float* w1, const float* b1, float* out,
                            float* a1, float* a2, int L, int B, int din, int h,
                            int dz, int final_act, int cluster,
                            void* stream) {
  if (L <= 0 || B <= 0) return 0;
  const long long tiles = (B + BM - 1) / BM;
  if (din <= 0 || h <= 0 || h > MAX_HIDDEN || dz <= 0 || L > 65535 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      tiles * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int ldh = (h + KS - 1) / KS * KS + 4;
  const size_t smem =
      ((size_t)NS * (BM * LDX + KS * PC) + (size_t)BM * ldh) * sizeof(float);
  // once: the most shared memory a block may have
  static const cudaError_t smem_attr = cudaFuncSetAttribute(
      lane_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      232448);
  if (smem_attr != cudaSuccess) return (int)smem_attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cluster), L);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, lane_mlp_fwd_kernel, x, w0, b0, w1, b1, out,
                         a1, a2, B, din, h, dz, final_act);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* lane_mlp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The narrow route: one block of NTHREADS threads a lane and NROWS rows,
// every width a multiple of 4 in [4, NARROW_MAX].  Launches on `stream`;
// returns the launch's error code (0 = launched).
extern "C" int lane_mlp_fwd_narrow(const float* x, const float* w0,
                                   const float* b0, const float* w1,
                                   const float* b1, float* out, float* a1,
                                   float* a2, int L, int B, int din, int h,
                                   int dz, int final_act, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  if (!narrow_width(din) || !narrow_width(h) || !narrow_width(dz))
    return (int)cudaErrorInvalidValue;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_attr = cudaFuncSetAttribute(
      lane_mlp_fwd_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      232448);
  if (smem_attr != cudaSuccess) return (int)smem_attr;
  const dim3 grid((unsigned)((B + NROWS - 1) / NROWS), L);
  lane_mlp_fwd_narrow_kernel<<<grid, NTHREADS, narrow_smem(din, h, dz),
                               (cudaStream_t)stream>>>(
      x, w0, b0, w1, b1, out, a1, a2, B, din, h, dz, final_act);
  return (int)cudaGetLastError();
}
