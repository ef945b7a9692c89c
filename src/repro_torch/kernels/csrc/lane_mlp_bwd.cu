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
// every Table-3 autoencoder in steps 1-3 of run_apcvfl(use_kernel=True) and
// the million-row scale lanes (train_lanes: 16 lanes of 8,192 rows,
// 16 -> 32 -> 64 and back).
//
// Two routes, picked by the launcher from the widths alone, with the same
// bits: both keep the sum orders below, those of the kernel this one
// replaced.
// - g1 and dx ("strided dot"): each output's sum over k is 32 chains, chain
//   l summing k = l, l + 32, ... in ascending order from 0 (on zeros past
//   the real k), then an xor butterfly over the chains (offsets 16, 8, 4,
//   2, 1: chain l plus chain l + 16, and so on).
// - dW and db ("row sums"): each element is a sequential fmaf chain over
//   the rows of each 32-row tile, from 0, and the tile partials are summed
//   in four running sums by tile index mod 4, each in ascending tile
//   order, then ((s0 + s1) + s2) + s3: the order in which torch.sum
//   reduced the old kernel's partials over fewer than 64 tiles.  db1 and
//   db0 are one more row of dW1 and dW0, of ones (fmaf(1, v, s) rounds as
//   s + v does).
// selu(a1), g2 and the ones are made as the operands are staged into
// shared memory; ragged rows, columns and k are staged as zeros and add
// exact zeros (a chain from +0 never holds -0).  A lane whose g is zero (a
// dead lane) gives exact zeros.  No atomics, the same bits every run.
//
// The cluster route (every shape the narrow route does not take).
// What bounds it on the H100: 4*B*(din*h + h*dz) fp32 operations against
// the 67 TFLOP/s of the CUDA cores (4.2 us over the eight Table-3 MLPs at
// B = 128), the bytes a factor 2-4 lower.  At that batch the work is small
// and the time is how many SMs the grid fills and how long each block's
// chain of dependent steps is.
// Design.  g1 needs whole rows of g2 @ w1^T before dW0 and dx can start, so
// the backward is two launches of one kernel, each a flat grid of small
// independent tiles (no clusters):
//
//   launch 1: dW1 and db1 tiles (32 x 32 outputs, over all rows), and g1
//             tiles (16 rows x 16 hidden units) into an (L, B, h) scratch;
//   launch 2: dW0 and db0 tiles, and dx tiles (16 rows x 16 inputs), both
//             reading g1; dx tiles only when dx is wanted.
//
// - Strided dots: a warp owns 32 outputs (4 rows x 8 columns): each lane
//   runs its chain for all 32 at once from k-slabs in shared memory (4 + 8
//   conflict-free reads per 32 FMAs), and the butterfly is done transposed:
//   at each level a lane keeps half its outputs and sends the other half to
//   its partner, 31 shuffles for all 32 outputs instead of 160, with the
//   same pairs added.  Lane l ends with output l.
// - Row sums: the block's four warp pairs take the four tiles of each
//   128-row chunk, so the tile partials are computed in parallel and each
//   group keeps one running sum; each thread owns 4 x 4 elements and reads
//   one 16-byte row slice of each operand per row.
// What holds it back at narrow widths over long batches: each dW/db tile
// sums all B rows in one block, so at B 8,192 a launch has 16-64 blocks on
// 132 SMs, each a chain of 8,192 rows.
//
// The narrow route (every width a multiple of 4, at most NARROW_MAX = 64).
// What bounds it: bytes.  g, a1 and x in and dx out, 4*L*B*(dz + h +
// 2 din), with the weights and their gradients (20.1 us at the scale
// encoder, 27.6 at the decoder, against 3.35 TB/s; a2, read only with
// final_act, would add 4*L*B*dz); the scratch below adds 2 x 43.5 MB at
// the scale encoder (26 us), 2 x 42.7 MB at the decoder; the operations,
// 4*L*B*(din*h + h*dz), take 20.0 us at 67 TFLOP/s.
// Design: two launches.
//   launch 1 (the rows pass): a block of 256 threads takes 128 rows (four
//     32-row tiles) of one lane.  Both weights (each row zero-padded to a
//     multiple of 32) and the rows' g, a1 and x go to shared memory with
//     every 16-byte cp.async in flight at once; then g2, selu(a1) and
//     selu'(a1) are made in place.  g1 and dx are strided dots where a lane
//     owns an output column, holds w's row in registers and reads the row
//     as broadcasts, runs all 32 chains of its output and adds the
//     butterfly's pairs as a tree in the same order; g1 stays in shared
//     memory.  Each tile's dW1/db1 and dW0/db0 partials (4 x 4 a thread)
//     go to a scratch of (L, ceil(B / 32), (din + 1) h + (h + 1) dz) fp32
//     that the launcher allocates: 43.5 MB at the scale encoder.
//   launch 2 (the fold): four threads an element, one a running sum, read
//     the lane's tile partials (a warp 32 consecutive elements of a tile)
//     and meet in shared memory for ((s0 + s1) + s2) + s3.
// 123-151 registers (templated on each dot's 32-steps), no spills, two
// blocks an SM; 91 KB of shared memory at the scale encoder, 102 KB at
// the decoder.  What holds it back (tools/kernel_variants.py, PERF.md):
// the strided dots' registers (w's row and 32 chains) keep two blocks an
// SM, so the rows' loads and the partials' stores overlap little with the
// FMAs.
// The lane axis is grid axis 1 on every launch.  No fast-math: selu' uses
// expf and selu expm1f, the form and constants of jax.nn.selu.

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

// ---------------------------------------------------------------------------
// The narrow route: every width a multiple of 4 and at most NARROW_MAX.
// ---------------------------------------------------------------------------

constexpr int NARROW_MAX = 64;
constexpr bool narrow_width(int w) {
  return w > 0 && w <= NARROW_MAX && w % 4 == 0;
}
constexpr int NROWS = 4 * TM;           // rows a block: four weight tiles
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int FOLD_ELEMS = 64;    // gradient elements a fold block

// The smallest row stride >= k that is 4 mod 8 floats: 16-byte aligned,
// and eight rows read at one column land on eight distinct 4-bank groups.
__host__ __device__ constexpr int pad_ld(int k) { return (k + 3) / 8 * 8 + 4; }
__host__ __device__ constexpr int up32(int k) { return (k + 31) / 32 * 32; }

// The block's shared memory, in floats: the two weights with each row
// zero-padded to a multiple of 32 (the strided dots' k), g2, selu(a1) with
// a column of ones (db1's row), g1 (staged as selu'(a1), zero-padded to a
// multiple of 32), x with a column of ones (db0's row).
struct NarrowSmem {
  int kp1, kp2;                           // dz and h rounded up to 32
  int ldw1, ldw0, ldg2, lds1, ldg1, ldx;
  int w1s, w0s, g2s, s1s, g1s, xs, total;
  __host__ __device__ NarrowSmem(int din, int h, int dz)
      : kp1(up32(dz)), kp2(up32(h)), ldw1(pad_ld(kp1)), ldw0(pad_ld(kp2)),
        ldg2(pad_ld(kp1)), lds1(pad_ld(h + 4)), ldg1(pad_ld(kp2)),
        ldx(pad_ld(din + 4)), w1s(0), w0s(w1s + h * ldw1),
        g2s(w0s + din * ldw0), s1s(g2s + NROWS * ldg2),
        g1s(s1s + NROWS * lds1), xs(g1s + NROWS * ldg1),
        total(xs + NROWS * ldx) {}
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [0, n) x quads [0, qp) of dst (row stride ld), asynchronously: quad
// k < q of row r < valid from src (row stride 4 q), the rest zero-filled.
__device__ __forceinline__ void stage_async(float* dst, int ld,
                                            const float* src, int n,
                                            int valid, int q, int qp) {
  for (int e = threadIdx.x; e < n * qp; e += blockDim.x) {
    const int r = e / qp, k = e - r * qp;
    const bool ok = r < valid && k < q;
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + 4 * k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(ok ? src + (size_t)r * 4 * q + 4 * k : src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// A level of the butterfly as a tree: v[i] + v[i + N], the pair the
// butterfly adds at offset N.
template <int N>
__device__ __forceinline__ void tree_half(float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = v[i] + v[i + N];
}

// The strided dot of the parent kernel, for rows [0, rows) of the block:
// out(r, c) = the xor-butterfly sum over 32 lanes' chains, chain l summing
// A[r][k] * W[c][k] for k = l, l + 32, ... (S steps, on zeros past the real
// k), then epi(r, c, out).  A lane owns column c (a warp covers up to 32
// columns, and 32 / that many rows at once), holds W's row c in registers
// and runs all 32 chains of its output; the butterfly's pairs are added as
// a tree in the same order.
template <int S, typename Epi>
__device__ __forceinline__ void narrow_dot(const float* __restrict__ A,
                                           int lda,
                                           const float* __restrict__ W,
                                           int ldw, int n, int rows,
                                           Epi epi) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cw = n > 16 ? 32 : n > 8 ? 16 : n > 4 ? 8 : 4;
  const int rw = 32 / cw;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane % cw;
    const bool on = c < n;
    float w[32 * S];
#pragma unroll
    for (int k = 0; k < 32 * S; k += 4) {
      const float4 v = on ? *reinterpret_cast<const float4*>(W + c * ldw + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      w[k] = v.x, w[k + 1] = v.y, w[k + 2] = v.z, w[k + 3] = v.w;
    }
    for (int r = warp * rw + lane / cw; r < rows; r += NWARPS * rw) {
      float v[32];
#pragma unroll
      for (int l = 0; l < 32; ++l) v[l] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int l = 0; l < 32; l += 4) {
          const float4 a =
              *reinterpret_cast<const float4*>(A + r * lda + 32 * s + l);
          v[l] = fmaf(a.x, w[32 * s + l], v[l]);
          v[l + 1] = fmaf(a.y, w[32 * s + l + 1], v[l + 1]);
          v[l + 2] = fmaf(a.z, w[32 * s + l + 2], v[l + 2]);
          v[l + 3] = fmaf(a.w, w[32 * s + l + 3], v[l + 3]);
        }
      tree_half<16>(v);
      tree_half<8>(v);
      tree_half<4>(v);
      tree_half<2>(v);
      tree_half<1>(v);
      if (on) epi(r, c, v[0]);
    }
  }
}

// The parent kernel's 32-row tile partials of a weight gradient with its
// bias row, for the block's `tiles` tiles: part[t][a][b] = sum over the
// tile's rows ascending from 0 of A[row][a] * Bm[row][b], a in [0, na)
// (the last a the column of ones), b in [0, nb).  A thread owns 4 x 4 of
// one tile's partial; `part` steps P floats a tile.
__device__ __forceinline__ void narrow_row_sums(const float* __restrict__ A,
                                                int lda,
                                                const float* __restrict__ Bm,
                                                int ldb, int na, int nb,
                                                int tiles,
                                                float* __restrict__ part,
                                                int P) {
  const int ga = (na + 3) / 4, gb = nb / 4;
  for (int it = threadIdx.x; it < tiles * ga * gb; it += NTHREADS) {
    const int b = it % gb * 4, a = it / gb % ga * 4, t = it / (gb * ga);
    float acc[4][4] = {};
    const float* ap = A + t * TM * lda + a;
    const float* bp = Bm + t * TM * ldb + b;
#pragma unroll 8
    for (int r = 0; r < TM; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(ap + r * lda);
      const float4 y = *reinterpret_cast<const float4*>(bp + r * ldb);
      const float xa[4] = {x.x, x.y, x.z, x.w};
      const float yb[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(xa[i], yb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (a + i < na)
        *reinterpret_cast<float4*>(part + (size_t)t * P + (a + i) * nb + b) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// One block: NROWS rows of one lane.  Stages both weights and the rows'
// g2, selu(a1), selu'(a1) and x; then g1 and the tiles' dW1/db1 partials;
// then the tiles' dW0/db0 partials and dx.  part is (L, T, P), P = (din +
// 1) h + (h + 1) dz: each tile's [dW0; db0] then [dW1; db1].
// S1 and S2: the 32-steps of g1's and dx's strided dots (dz and h rounded
// up to 32, over 32), so that a route with one step each keeps w's row in
// half the registers.
template <int S1, int S2>
__global__ void __launch_bounds__(NTHREADS)
lane_mlp_bwd_narrow_kernel(Args p, float* __restrict__ part, int T) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int B = p.B, din = p.din, h = p.h, dz = p.dz;
  const NarrowSmem m(din, h, dz);
  float *w1s = sm + m.w1s, *w0s = sm + m.w0s, *g2s = sm + m.g2s,
        *s1s = sm + m.s1s, *g1s = sm + m.g1s, *xs = sm + m.xs;
  const size_t l = blockIdx.y;
  const int row0 = blockIdx.x * NROWS, rows = min(NROWS, B - row0);
  const int t = threadIdx.x;
  const float* g = p.g + (l * B + row0) * dz;
  const float* a2 = p.final_act ? p.a2 + (l * B + row0) * dz : nullptr;
  const float* a1 = p.a1 + (l * B + row0) * h;
  const float* x = p.x + (l * B + row0) * din;
  const float* w0 = p.w0 + l * din * h;
  const float* w1 = p.w1 + l * h * dz;

  // every copy in flight at once, 16 bytes each, rows past B and k past a
  // width zero-filled: the weights, g (to become g2), a1 (raw, in g1s) and
  // x, whose column of ones is stored directly
  const int qz = dz / 4, qh = h / 4, qx = din / 4;
  stage_async(w1s, m.ldw1, w1, h, h, qz, m.kp1 / 4);
  stage_async(w0s, m.ldw0, w0, din, din, qh, m.kp2 / 4);
  stage_async(g2s, m.ldg2, g, NROWS, rows, qz, m.kp1 / 4);
  stage_async(g1s, m.ldg1, a1, NROWS, rows, qh, m.kp2 / 4);
  stage_async(xs, m.ldx, x, NROWS, rows, qx, qx);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 one = make_float4(1.f, 0.f, 0.f, 0.f);
  for (int r = t; r < NROWS; r += NTHREADS)
    st4(xs + r * m.ldx + din, r < rows ? one : zero);
  cp_async_wait_all();
  __syncthreads();
  // g2 = g * selu'(a2); selu(a1) and its ones into s1s, selu'(a1) over a1
  if (a2)
    for (int e = t; e < rows * qz; e += NTHREADS) {
      const int r = e / qz, k = e - r * qz;
      float4* v = reinterpret_cast<float4*>(g2s + r * m.ldg2 + 4 * k);
      const float4 d = ld4(a2 + r * dz + 4 * k);
      *v = make_float4(v->x * dselu(d.x), v->y * dselu(d.y),
                       v->z * dselu(d.z), v->w * dselu(d.w));
    }
  for (int e = t; e < NROWS * (qh + 1); e += NTHREADS) {
    const int r = e / (qh + 1), k = e - r * (qh + 1);
    float4* s1 = reinterpret_cast<float4*>(s1s + r * m.lds1 + 4 * k);
    if (r >= rows || k == qh) {
      *s1 = r < rows ? one : zero;
      continue;
    }
    float4* g1 = reinterpret_cast<float4*>(g1s + r * m.ldg1 + 4 * k);
    const float4 a = *g1;
    *s1 = make_float4(selu(a.x), selu(a.y), selu(a.z), selu(a.w));
    *g1 = make_float4(dselu(a.x), dselu(a.y), dselu(a.z), dselu(a.w));
  }
  __syncthreads();

  const int P = (din + 1) * h + (h + 1) * dz;
  const int tiles = min(NROWS / TM, T - row0 / TM);
  float* pt = part + (l * T + row0 / TM) * P;
  // g1 = selu'(a1) * (g2 @ w1^T), in place of selu'(a1)
  narrow_dot<S1>(g2s, m.ldg2, w1s, m.ldw1, h, rows,
                 [&](int r, int c, float v) {
                   float* o = g1s + r * m.ldg1 + c;
                   *o = *o * v;
                 });
  narrow_row_sums(s1s, m.lds1, g2s, m.ldg2, h + 1, dz, tiles,
                  pt + (din + 1) * h, P);
  __syncthreads();
  narrow_row_sums(xs, m.ldx, g1s, m.ldg1, din + 1, h, tiles, pt, P);
  if (p.dx) {
    float* dx = p.dx + (l * B + row0) * din;
    narrow_dot<S2>(g1s, m.ldg1, w0s, m.ldw0, din, rows,
                   [&](int r, int c, float v) { dx[r * din + c] = v; });
  }
}

// Each gradient element: the lane's T tile partials in four running sums
// by tile index mod 4, each in ascending tile order, then ((s0 + s1) +
// s2) + s3, the parent kernel's order.  A block takes FOLD_ELEMS elements;
// thread (m, e) runs running sum m of element e (a warp reads 32
// consecutive elements of one tile), and the four meet in shared memory.
__global__ void __launch_bounds__(4 * FOLD_ELEMS)
lane_mlp_bwd_fold_kernel(const float* __restrict__ part, int T, int din,
                         int h, int dz, float* __restrict__ dw0,
                         float* __restrict__ db0, float* __restrict__ dw1,
                         float* __restrict__ db1) {
  __shared__ float sums[4][FOLD_ELEMS];
  const int P = (din + 1) * h + (h + 1) * dz;
  const int m = threadIdx.x / FOLD_ELEMS, el = threadIdx.x % FOLD_ELEMS;
  const int e = blockIdx.x * FOLD_ELEMS + el;
  const size_t l = blockIdx.y;
  float s = 0.f;
  if (e < P) {
    const float* q = part + (l * T + m) * P + e;
#pragma unroll 8
    for (int i = m; i < T; i += 4, q += 4 * (size_t)P) s += *q;
  }
  sums[m][el] = s;
  __syncthreads();
  if (m != 0 || e >= P) return;
  const float v = ((sums[0][el] + sums[1][el]) + sums[2][el]) + sums[3][el];
  const int e1 = e - (din + 1) * h;
  if (e < din * h) dw0[l * din * h + e] = v;
  else if (e1 < 0) db0[l * h + e - din * h] = v;
  else if (e1 < h * dz) dw1[l * h * dz + e1] = v;
  else db1[l * dz + e1 - h * dz] = v;
}

}  // namespace

// The narrow route, every width a multiple of 4 in [4, NARROW_MAX]: the
// rows' pass into `part` (L, T, (din + 1) h + (h + 1) dz), T = ceil(B /
// 32), then the fold of the partials into the gradients.  dx may be null.
// Launches on `stream`; returns the first launch error (0 = launched).
extern "C" int lane_mlp_bwd_narrow(const float* g, const float* x,
                                   const float* a1, const float* a2,
                                   const float* w0, const float* w1,
                                   float* dx, float* dw0, float* db0,
                                   float* dw1, float* db1, float* part,
                                   int L, int B, int din, int h, int dz,
                                   int final_act, int T, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  if (!narrow_width(din) || !narrow_width(h) || !narrow_width(dz))
    return (int)cudaErrorInvalidValue;
  if (L > 65535 || T != cdiv(B, TM)) return (int)cudaErrorInvalidValue;
  // once each: the most shared memory a block may have
  static const cudaError_t attr[4] = {
      cudaFuncSetAttribute(lane_mlp_bwd_narrow_kernel<1, 1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448),
      cudaFuncSetAttribute(lane_mlp_bwd_narrow_kernel<1, 2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448),
      cudaFuncSetAttribute(lane_mlp_bwd_narrow_kernel<2, 1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448),
      cudaFuncSetAttribute(lane_mlp_bwd_narrow_kernel<2, 2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448)};
  for (const cudaError_t a : attr)
    if (a != cudaSuccess) return (int)a;
  const cudaStream_t s = (cudaStream_t)stream;
  const Args p = {g, x, a1, a2, w0, w1, nullptr, dx, dw0, db0, dw1, db1,
                  B, din, h, dz, final_act};
  const NarrowSmem m(din, h, dz);
  const dim3 grid(cdiv(B, NROWS), L);
  const size_t smem = m.total * sizeof(float);
  if (m.kp1 == 32 && m.kp2 == 32)
    lane_mlp_bwd_narrow_kernel<1, 1><<<grid, NTHREADS, smem, s>>>(p, part, T);
  else if (m.kp1 == 32)
    lane_mlp_bwd_narrow_kernel<1, 2><<<grid, NTHREADS, smem, s>>>(p, part, T);
  else if (m.kp2 == 32)
    lane_mlp_bwd_narrow_kernel<2, 1><<<grid, NTHREADS, smem, s>>>(p, part, T);
  else
    lane_mlp_bwd_narrow_kernel<2, 2><<<grid, NTHREADS, smem, s>>>(p, part, T);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int P = (din + 1) * h + (h + 1) * dz;
  lane_mlp_bwd_fold_kernel<<<dim3(cdiv(P, FOLD_ELEMS), L), 4 * FOLD_ELEMS,
                             0, s>>>(part, T, din, h, dz, dw0, db0, dw1, db1);
  return (int)cudaGetLastError();
}

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
