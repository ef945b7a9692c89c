// The intra-chunk block of Mamba2's chunked SSD on Hopper (sm_90a), fp32
// IEEE math on the CUDA cores.  For each batch b, chunk c of Lc positions
// and head h, with xdt = x * dt, a = dt * A[h] and cs the prefix sums of a
// over the chunk:
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
// Lc 256) that is 13.5 GFLOP, 0.20 ms at 67 TFLOP/s of fp32; the bytes (x
// in and y out 84 MB each, states 21 MB, B, C and dt 3.4 MB) take 0.057 ms
// at 3.35 TB/s.  TF32 or bf16 tensor cores would be another function with
// a bound of its own (ROADMAP ground rules), so this route stays fp32 and
// is held to the bits of the first kernel of this file (commit 64a7bb6).
//
// The sums, in the order that fixes those bits.  cs is an inclusive scan
// in float64 by one warp, 32 rows at a time (a shuffle scan plus the
// carry), rounded once to fp32.  A score is sum_{n = 0..N-1} C[l,n] B[s,n]
// by fmaf from 0, then times expf(cs[l] - cs[s]) (taken only on and below
// the diagonal: above it the reference has exp(-inf) = 0, and exp of a
// positive difference could overflow).  xdt = x * dt and B * w, with
// w = expf(cs[Lc-1] - cs[s]), are rounded once each.  y and the states sum
// their products by fmaf over s ascending, tile by tile.  A product whose
// score is exactly 0 (above the diagonal, past Lc) leaves a sum started
// from +0 unchanged for finite inputs, so the kernel skips those and keeps
// the bits.  No atomics, no fast-math: every run gives the same bits.
//
// Design.  The two heads of a pair in one group share C and B, so they
// share every score product; only the decays differ.  The grid is one
// block per (b, c, head pair) and role, (Lc/64 + 1) roles: a "y block"
// for each 64-row l tile (heaviest first) and one "states block".  A y
// block walks the 32-row s tiles up to its diagonal; the states block
// walks all of them.  Each block rescans the cs rows it needs (a y block
// only those up to its tile).  256 threads: warps 0-3 serve the pair's
// first head, warps 4-7 its second; 2 blocks an SM.
//   - Staging: a two-slot cp.async ring holds the B_s tile and each head's
//     raw x_s tile; tile k + 1 is in flight while tile k computes.  After
//     arrival x_s is scaled by dt in place (and, in the states block, B_s
//     by each head's w into that head's tile), once per element.  Copy
//     loops index by thread and row, without integer division.  Rows past
//     Lc arrive as zeros.
//   - Scores: all 8 warps form the 64 x 32 tile C_l B_s^T once for both
//     heads, each thread 2 l x 4 s of it, reading C_l and B_s along n with
//     16-byte loads from rows padded to 68 floats (17 quads, so the rows a
//     quarter warp reads fall in distinct banks): 6 loads feed 32 FMAs.  A
//     warp whose rows all lie above the s tile skips it.  Each score is
//     then decayed for both heads and goes to that head's S^T[s][l].
//   - y (and the states): each of a head's threads owns a 4 x 8 register
//     tile, four rows (l, or n) and p = 4q..4q+3 and 32+4q..32+4q+3; per s
//     one 16-byte load of S^T (a broadcast within each quarter warp) and
//     two of xdt feed 32 FMAs.  Near the diagonal a warp stops at its last
//     row.
// Shared memory: C_l [64][68], 2 B_s slots [32][68], per head S^T [32][68]
// and 2 xdt slots [32][64], per head cs, dt and the end decays (Lc rounded
// up to 64 each): 91,136 bytes at Lc 256.
//
// The bf16 variant (ssd_intra_chunk_bf16, the model's cfg.ssd_bf16).  No
// TPU kernel computes it: the reference's models/mamba2.ssd_chunked casts
// the intra-chunk products' operands to bf16 there, and the port's plain
// version (kernels/ref.py ssd_intra_chunk_ref with bf16) repeats those
// casts.  The same kernel, with BF16 set, reads the same fp32 inputs and
// rounds to bf16 (round to nearest even) exactly where that plain version
// rounds: xdt, B and C as they are loaded or formed, the decays after their
// expf, each score, each decayed score and each B * w after its product,
// and y and the states once at the end of their sums.  Every sum stays fp32
// in the order above (products of two bf16 values are exact in fp32), so
// the two differ only where a sum order moves a rounding; chip_smoke.py
// holds the variant to that plain version within TOL_SSD_BF16 x max|y|, a
// bound placed by the kernel's and the planted faults' readings in
// tools/ssd_planted_faults.py.  Tensor cores are later work.  With BF16 unset every rounding is the identity, so the fp32 route
// keeps its bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TL = 64;                 // rows of an l tile
constexpr int TS = 32;                 // rows of an s tile
constexpr int NP_MAX = 64;             // largest N and P
constexpr int LC_MAX = 4096;           // largest chunk
constexpr int THREADS = 256;           // two heads, 128 threads each
constexpr int HT = THREADS / 2;
constexpr int LDA = 68;                // row stride of C_l, B_s, S^T: 17 quads
constexpr int LDX = 64;                // row stride of xdt
constexpr int TILE_C = TL * LDA;
constexpr int TILE_B = TS * LDA;
constexpr int TILE_X = TS * LDX;

__host__ __device__ inline int n_tiles(int Lc) { return (Lc + TL - 1) / TL; }

// v rounded to bf16 and back when R, else v
template <bool R>
__device__ __forceinline__ float rb(float v) {
  return R ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__host__ __device__ inline size_t smem_floats(int Lc) {
  return (size_t)TILE_C + 2 * (size_t)TILE_B +
         2 * ((size_t)TILE_B + 2 * (size_t)TILE_X) +
         6 * (size_t)n_tiles(Lc) * TL;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows 0..R-1 of a tile into dst (row stride ld): row r of the source at
// src + r * stride, `rows` of them real, the rest (and the columns from
// `cols` up to the next multiple of 4) zero-filled.  Thread t copies quad
// t % 16 of rows t / 16 + 16 m.  `vec`: 16-byte copies (cols % 4 == 0 and
// 16-byte aligned rows), else 4-byte ones.
template <int R>
__device__ __forceinline__ void copy_tile(float* dst, int ld,
                                          const float* src, size_t stride,
                                          int rows, int cols, bool vec) {
  const int q = threadIdx.x & 15;
  if (4 * q >= cols) return;
  for (int r = threadIdx.x >> 4; r < R; r += THREADS / 16) {
    const bool ok = r < rows;
    const float* s = src + (ok ? r * stride : 0) + 4 * q;
    float* d = dst + r * ld + 4 * q;
    if (vec) {
      cp16(d, s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool oke = ok && 4 * q + e < cols;
        cp4(d + e, oke ? s + e : src, oke);
      }
    }
  }
}

// dst[r][c] = src[r][c] * w[r] for the TS rows and the quads below `cols`,
// by one head's 128 threads (t: its index among them); RS rounds src and RO
// the product to bf16
template <bool RS, bool RO>
__device__ __forceinline__ void scale_rows(float* dst, const float* src,
                                           int ld, const float* w, int cols,
                                           int t) {
  const int q = t & 15;
  if (4 * q >= cols) return;
  for (int r = t >> 4; r < TS; r += HT / 16) {
    const float4 v = *reinterpret_cast<const float4*>(src + r * ld + 4 * q);
    const float wr = w[r];
    *reinterpret_cast<float4*>(dst + r * ld + 4 * q) = make_float4(
        rb<RO>(rb<RS>(v.x) * wr), rb<RO>(rb<RS>(v.y) * wr),
        rb<RO>(rb<RS>(v.z) * wr), rb<RO>(rb<RS>(v.w) * wr));
  }
}

// cs[s] for s < rows: the inclusive float64 scan of dt[s] * A, one warp
__device__ __forceinline__ void scan_cs(float* cs, const float* dts,
                                        float Ah, int rows, int lane) {
  double carry = 0.0;
  for (int base = 0; base < rows; base += 32) {
    const int s = base + lane;
    // a = dt * A is the fp32 product, as the reference's
    double v = s < rows ? (double)(dts[s] * Ah) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    if (s < rows) cs[s] = (float)v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// acc[i][j] += A[s][r0 + i] * X[s][p_j] over s < s_hi, s ascending; p_j =
// 4 q + j and 32 + 4 q + j - 4
__device__ __forceinline__ void fma_tile(float (&acc)[4][8], const float* A,
                                         const float* X, int s_hi, int r0,
                                         int q) {
  const float* a_p = A + r0;
  const float* x_p = X + 4 * q;
#pragma unroll 8
  for (int s = 0; s < s_hi; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(a_p + s * LDA);
    const float4 xa = *reinterpret_cast<const float4*>(x_p + s * LDX);
    const float4 xb = *reinterpret_cast<const float4*>(x_p + s * LDX + 32);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
  }
}

// a row of 8 outputs (p = 4 q + j, 32 + 4 q + j) with p < P, each rounded
// to bf16 when R
template <bool R>
__device__ __forceinline__ void store_row(float* out, const float (&v)[8],
                                          int q, int P) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = 32 * hh + 4 * q;
    if (P % 4 == 0) {
      if (p < P)
        *reinterpret_cast<float4*>(out + p) =
            make_float4(rb<R>(v[4 * hh]), rb<R>(v[4 * hh + 1]),
                        rb<R>(v[4 * hh + 2]), rb<R>(v[4 * hh + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p + e < P) out[p + e] = rb<R>(v[4 * hh + e]);
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ st, int S, int H, int G, int N, int P,
           int Lc, int vec) {
  extern __shared__ float4 smem4[];
  const int nt = n_tiles(Lc), RP = nt * TL;
  float* Cl = reinterpret_cast<float*>(smem4);
  float* Bs = Cl + TILE_C;              // two slots
  float* St = Bs + 2 * TILE_B;          // per head
  float* Xs = St + 2 * TILE_B;          // per head, two slots
  float* cs = Xs + 4 * TILE_X;          // per head [RP]
  float* dts = cs + 2 * RP;
  float* dend = dts + 2 * RP;

  const int roles = nt + 1, R = H / G, pairs = (R + 1) / 2;
  const int role = blockIdx.x % roles, pg = blockIdx.x / roles;
  const int g = pg / pairs, h0 = g * R + 2 * (pg % pairs);
  const int c = blockIdx.y, b = blockIdx.z;
  const bool states = role == nt;       // else the y block of l tile lt
  const bool two = 2 * (pg % pairs) + 1 < R;      // the pair's second head
  const int lt = states ? 0 : nt - 1 - role;
  const int l0 = lt * TL;
  const int rows = states ? Lc : min(l0 + TL, Lc); // cs rows it needs
  const int n_s = (rows + TS - 1) / TS;           // s tiles it walks
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hs = warp >> 2, ht = tid & (HT - 1);  // head slot, its thread
  const bool mine = hs == 0 || two;               // this thread's head exists
  const int h = h0 + hs;
  const size_t t0 = (size_t)b * S + (size_t)c * Lc;   // the chunk's row 0
  const size_t xstride = (size_t)H * P, bstride = (size_t)G * N;
  const float* Bg = Bm + (t0 * G + g) * N;
  const float* Cg = Cm + (t0 * G + g) * N;
  const float* xh[2] = {x + (t0 * H + h0) * P, x + (t0 * H + h0 + 1) * P};
  float* cs_h = cs + hs * RP;
  float* dts_h = dts + hs * RP;
  float* dend_h = dend + hs * RP;
  float* St_h = St + hs * TILE_B;

  if (!states)
    copy_tile<TL>(Cl, LDA, Cg + l0 * bstride, bstride, rows - l0, N, vec);
  copy_tile<TS>(Bs, LDA, Bg, bstride, min(TS, Lc), N, vec);
  for (int e = 0; e < 1 + two; ++e)
    copy_tile<TS>(Xs + 2 * e * TILE_X, LDX, xh[e], xstride, min(TS, Lc), P,
                  vec);
  cp_commit();
  if (mine)
    for (int s = ht; s < RP; s += HT)
      dts_h[s] = s < rows ? dt[(t0 + s) * H + h] : 0.f;
  __syncthreads();
  if (states && mine && (warp & 3) == 0) {
    scan_cs(cs_h, dts_h, A[h], Lc, lane);
    __syncwarp();
    for (int s = lane; s < RP; s += 32)
      dend_h[s] = s < Lc ? rb<BF16>(expf(cs_h[Lc - 1] - cs_h[s])) : 0.f;
  }

  // y / states register tile of this head: rows r0..r0+3, p quads q, q + 8
  const int r0 = 16 * (warp & 3) + 4 * (lane >> 3), q = lane & 7;
  // score tile: l rows lr, lr + 1 and s rows sr + 8 j
  const int lr = 8 * warp + 2 * (lane >> 3), sr = lane & 7;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < n_s; ++k) {
    const int s0 = k * TS, sl = k & 1;
    float* Bk = Bs + sl * TILE_B;
    float* Xk = Xs + (2 * hs + sl) * TILE_X;
    cp_wait_all();
    __syncthreads();            // tile k landed; tile k - 1 is read
    if (k + 1 < n_s) {
      const int s1 = s0 + TS, r1 = min(TS, Lc - s1);
      copy_tile<TS>(Bs + (sl ^ 1) * TILE_B, LDA, Bg + s1 * bstride, bstride,
                    r1, N, vec);
      for (int e = 0; e < 1 + two; ++e)
        copy_tile<TS>(Xs + (2 * e + (sl ^ 1)) * TILE_X, LDX,
                      xh[e] + s1 * xstride, xstride, r1, P, vec);
      cp_commit();
    }
    if (mine)                                               // xdt = x * dt
      scale_rows<false, BF16>(Xk, Xk, LDX, dts_h + s0, P, ht);
    if (states) {
      if (mine)                                             // B * w
        scale_rows<BF16, BF16>(St_h, Bk, LDA, dend_h + s0, N, ht);
    } else {
      if (k == 0 && mine && (warp & 3) == 0)
        scan_cs(cs_h, dts_h, A[h], rows, lane);
      // rows all above the tile: their scores are 0 and never read
      const bool skip = l0 + 8 * warp + 7 < s0;
      float sc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      if (!skip) {
        const int nq = (N + 3) >> 2;
        for (int n4 = 0; n4 < nq; ++n4) {
          float4 cv[2], bv[4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            cv[i] = *reinterpret_cast<const float4*>(Cl + (lr + i) * LDA +
                                                     4 * n4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(Bk + (sr + 8 * j) * LDA +
                                                     4 * n4);
          if (BF16) {                   // C and B as bf16 operands
#pragma unroll
            for (int i = 0; i < 2; ++i)
              cv[i] = make_float4(rb<true>(cv[i].x), rb<true>(cv[i].y),
                                  rb<true>(cv[i].z), rb<true>(cv[i].w));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bv[j] = make_float4(rb<true>(bv[j].x), rb<true>(bv[j].y),
                                  rb<true>(bv[j].z), rb<true>(bv[j].w));
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sc[i][j] = fmaf(cv[i].x, bv[j].x, sc[i][j]);
              sc[i][j] = fmaf(cv[i].y, bv[j].y, sc[i][j]);
              sc[i][j] = fmaf(cv[i].z, bv[j].z, sc[i][j]);
              sc[i][j] = fmaf(cv[i].w, bv[j].w, sc[i][j]);
            }
        }
      }
      if (k == 0) __syncthreads();                // cs is scanned
#pragma unroll
      for (int e = 0; e < 2; ++e) {               // decay for each head
        if (e == 1 && !two) break;
        const float* cse = cs + e * RP;
        float csl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          csl[i] = l0 + lr + i < rows ? cse[l0 + lr + i] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = sr + 8 * j, sa = s0 + s;
          const float css = sa < rows ? cse[sa] : 0.f;
          float v[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int la = l0 + lr + i;
            // the decay only on and below the diagonal, inside the chunk;
            // bf16: the score, the decay and their product each rounded
            v[i] = !skip && sa <= la && la < Lc
                       ? (BF16 ? rb<true>(rb<true>(sc[i][j]) *
                                          rb<true>(expf(csl[i] - css)))
                               : sc[i][j] * expf(csl[i] - css))
                       : 0.f;
          }
          *reinterpret_cast<float2*>(St + e * TILE_B + s * LDA + lr) =
              make_float2(v[0], v[1]);
        }
      }
    }
    __syncthreads();            // S^T (or B * w) and xdt are complete
    int s_hi = min(TS, Lc - s0);
    if (!states) s_hi = min(s_hi, l0 + r0 - 4 * (lane >> 3) + 16 - s0);
    if (mine && s_hi > 0) fma_tile(acc, St_h, Xk, s_hi, r0, q);
  }

  if (!mine) return;
  if (states) {
    const int Nc = S / Lc;
    float* sb = st + (((size_t)b * Nc + c) * H + h) * N * P;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < N) store_row<BF16>(sb + (r0 + i) * P, acc[i], q, P);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + r0 + i;
      if (l < Lc) store_row<BF16>(y + ((t0 + l) * H + h) * P, acc[i], q, P);
    }
  }
}

template <bool BF16>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* st, int B, int S, int H, int G,
           int N, int P, int Lc, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > NP_MAX || P <= 0 ||
      P > NP_MAX || Lc <= 0 || Lc > LC_MAX || S % Lc != 0 ||
      S / Lc > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // raise the dynamic shared-memory limit once per device and size, so the
  // launch itself can be captured in a CUDA graph
  static size_t granted[64] = {};
  const size_t smem = smem_floats(Lc) * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    e = cudaFuncSetAttribute(ssd_kernel<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = smem;
  }
  // 16-byte copies where every row of x, B and C starts on 16 bytes
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
  const dim3 grid((unsigned)((n_tiles(Lc) + 1) * G * ((H / G + 1) / 2)),
                  S / Lc, B);
  ssd_kernel<BF16><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st), S, H, G, N, P, Lc, (int)vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_intra_chunk_max_np() { return NP_MAX; }
extern "C" int ssd_intra_chunk_max_chunk() { return LC_MAX; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ssd_intra_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* st, int B, int S, int H, int G, int N,
                               int P, int Lc, void* stream) {
  return launch<false>(x, dt, A, Bm, Cm, y, st, B, S, H, G, N, P, Lc,
                       stream);
}

// The bf16 variant (the header's last paragraph): the same interface, the
// same fp32 tensors in and out.
extern "C" int ssd_intra_chunk_bf16(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, void* y, void* st, int B,
                                    int S, int H, int G, int N, int P, int Lc,
                                    void* stream) {
  return launch<true>(x, dt, A, Bm, Cm, y, st, B, S, H, G, N, P, Lc, stream);
}

extern "C" const char* ssd_intra_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
