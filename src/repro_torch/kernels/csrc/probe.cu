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
// (the L2 term is added outside, as the reference does).
//
// Replaces: repro/kernels/probe.py::_probe_kernel (pallas_call in
// _probe_call), the gradient of every fold's probe step in
// classifier.kfold_cv / fit_logreg with use_kernel=True.
//
// What bounds it on the H100: operations, at the k = 10 fold lanes of
// kfold_cv.  The function needs x (n x 256 fp32) once, while its two
// products do 4*C operations per element of x for each of the k lanes,
// so k*4*C = 160 operations per 4-byte element lies above the card's
// 20 operations per byte (fp32 on the CUDA cores).  So x is read once for
// all lanes, and both products run from registers.
//
// Design.  A group of fold lanes' columns side by side, kc = k * C + c
// (K * C <= 64 a group, or one lane where C passes 64; the host entry point
// walks the lanes in groups), padded to KCP = 8 * CW * NP: NP passes of
// 8 * CW columns.  A persistent grid of at most 128 blocks of 256 threads,
// a count that depends on n only, so the bits do not depend on the card;
// block p walks the contiguous rows [p * RB, (p + 1) * RB) in tiles of TR
// rows (128, 64 or 32: the most whose shared memory fits; at kfold_cv's
// 15000 rows, d 256 and 10 lanes, each block's 120 rows are one 128-row
// tile):
//   - x tiles arrive by cp.async in 64-column slabs, one group each, rows
//     padded to an odd number of 16-byte quads; W^T (KCP x d) and b are
//     staged once per block while the first tile is in flight.
//   - Logits: thread (row group, column group) owns TR/32 rows x CW
//     columns (columns cg + 8 m of each pass), reading x and W^T along d
//     with 16-byte loads, 4 + CW loads for 16 CW FMAs at TR 128, slab by
//     slab as x lands.  Each logit sums j = 0..d-1 by fmaf from 0 and then
//     adds b, the order of the first kernel of this file.
//   - The stable max / exp / sum of each (row, lane) runs across all 256
//     threads and turns the logits into g in place (the same expressions
//     as before, so g keeps its bits); rows past n weigh 0.
//   - dW: thread (j group, column group) owns 8 j x CW columns of each
//     (256-wide j group, pass) in registers over a tile's rows, reading x
//     along j and g along the columns: 2 + CW loads feed 8 CW FMAs.  The
//     sums carry from tile to tile through the block's partial in device
//     memory (read back by the thread that stored them, so exactly), which
//     keeps shared memory and registers independent of d and C.  db and
//     the loss sum beside it the same way.
//   - Each block leaves one partial (dW, db, loss) of the lanes; a second
//     launch sums them in a fixed order: 8 warps each add one run of
//     consecutive blocks' partials, then the 8 run sums in order.  No
//     atomics: every run gives the same bits.  The sums over rows run in
//     another order than the first kernel's (per block, not per 64-row
//     tile), which moves dW, db and the loss by rounding only; the tile
//     size and the lane groups do not move them.
// A row of weight 0 contributes exact zeros, so a fold's held-out rows are
// inert.  No fast-math: expf and logf as the reference rounds them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PMAX = 128;         // most blocks (row ranges) per launch
constexpr int KC_PASS = 64;       // lane columns of one pass
constexpr int SMEM_MAX = 232448;

int cdiv(int a, int b) { return (a + b - 1) / b; }

// row stride (floats) of the x tile and of W^T: an odd number of quads
__host__ __device__ inline int ld_x(int d) {
  const int q = (d + 3) / 4;
  return 4 * (q + (q % 2 == 0 ? 1 : 2));
}

__host__ __device__ inline int ld_g(int kcp) { return kcp + 4; }

size_t smem_floats(int tr, int d, int kcp, int K) {
  return (size_t)tr * ld_x(d) + (size_t)kcp * ld_x(d) +
         (size_t)tr * ld_g(kcp) + (size_t)K * tr + kcp;
}

// How one launch takes K lanes at (d, C): CW columns a thread in each of
// NP passes and TR rows a tile, the most rows whose shared memory fits;
// false if not even 32 rows fit.
bool plan(int d, int C, int K, int* tr, int* cw, int* np) {
  const int cwt = cdiv(K * C, 8);
  *np = cdiv(cwt, 8);
  *cw = cdiv(cwt, *np);
  for (int r = 128; r >= 32; r /= 2)
    if (smem_floats(r, d, 8 * *cw * *np, K) * sizeof(float) <=
        (size_t)SMEM_MAX) {
      *tr = r;
      return true;
    }
  return false;
}

// rows per block and blocks, from n alone
void row_split(int n, int* rb, int* nb) {
  const int r = cdiv(cdiv(n, PMAX), 8) * 8;
  *rb = r < 32 ? 32 : r;
  *nb = cdiv(n, *rb);
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

// up to `n` cp.async groups of this thread still in flight (n <= 7)
__device__ __forceinline__ void cp_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// the x tile of rows [row0, row0 + rows) into xs, one cp.async group per
// slab of 16 quads (64 columns), so the logits can start on the first
// slab; rows past `rows`, and the columns from d to the next quad, are
// zero-filled.  Thread t copies quad t % 16 of a slab, rows t / 16 + 16 m.
template <int TR>
__device__ __forceinline__ void copy_x(float* xs, int ldx,
                                       const float* __restrict__ x,
                                       int row0, int rows, int d, int nq,
                                       bool vec) {
  const int t = threadIdx.x;
  for (int qb = 0; qb < nq; qb += 16) {
    const int qd = qb + (t & 15);
    if (qd < nq) {
      for (int r = t >> 4; r < TR; r += THREADS / 16) {
        const bool ok = r < rows;
        const float* src = x + (size_t)(row0 + (ok ? r : 0)) * d + 4 * qd;
        float* dst = xs + r * ldx + 4 * qd;
        if (vec) {
          cp16(dst, src, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool oke = ok && 4 * qd + e < d;
            cp4(dst + e, oke ? src + e : x, oke);
          }
        }
      }
    }
    cp_commit();
  }
}

template <int CW, int RL>
__global__ void __launch_bounds__(THREADS, 1)
probe_kernel(const float* __restrict__ x, const int* __restrict__ y,
             const float* __restrict__ rwn, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ part,
             int n, int d, int C, int K, int np, int rb, int vec) {
  constexpr int TR = 32 * RL, PW = 8 * CW;    // rows a tile, columns a pass
  extern __shared__ float4 smem4[];
  const int kcp = PW * np;
  const int ldx = ld_x(d), ldg = ld_g(kcp), KC = K * C;
  const int nq = (d + 3) / 4, ns = (nq + 15) / 16;
  float* xs = reinterpret_cast<float*>(smem4);   // [TR][ldx]
  float* wt = xs + TR * ldx;                     // W^T [kcp][ldx]
  float* gs = wt + kcp * ldx;                    // [TR][ldg]: logits, g
  float* ls = gs + TR * ldg;                     // [K][TR] row losses
  float* bs = ls + K * TR;                       // [kcp]

  const int t = threadIdx.x, cg = t & 7, hi = t >> 3;
  const int r_beg = blockIdx.x * rb, r_end = min(n, r_beg + rb);
  const int n_tiles = (r_end - r_beg + TR - 1) / TR;
  // this block's partial: dW as [j][kc], then db [kc], then the loss [k]
  float* pp = part + blockIdx.x * ((size_t)d * KC + KC + K);
  // the loss sums run on the threads from the warp after db's
  const int lt0 = (KC + 31) / 32 * 32 % THREADS;

  copy_x<TR>(xs, ldx, x, r_beg, min(TR, r_end - r_beg), d, nq, vec);
  for (int e = t; e < kcp * ldx; e += THREADS) wt[e] = 0.f;
  for (int e = t; e < kcp; e += THREADS) bs[e] = e < KC ? b[e] : 0.f;
  __syncthreads();
  {   // w (K, d, C) -> W^T: element e = (k d + j) C + c, stepping by
      // THREADS without dividing in the loop; 8 loads in flight at a time
    int c = t % C, j = t / C, k = 0;
    while (j >= d) { j -= d; ++k; }
    const int dc = THREADS % C, dj = THREADS / C, total = KC * d;
    for (int e0 = t; e0 < total; e0 += 8 * THREADS) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = e0 + u * THREADS < total ? w[e0 + u * THREADS] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (e0 + u * THREADS < total) wt[(k * C + c) * ldx + j] = v[u];
        c += dc;
        j += dj;
        if (c >= C) { c -= C; ++j; }
        while (j >= d) { j -= d; ++k; }
      }
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int row0 = r_beg + it * TR, rows = min(TR, r_end - row0);
    if (it > 0) {
      __syncthreads();        // the previous tile is read
      copy_x<TR>(xs, ldx, x, row0, rows, d, nq, vec);
    }

    // logits: rows RL hi + i; columns PW mp + cg + 8 m; slab by slab of x
    for (int mp = 0; mp < np; ++mp) {
      float acc[RL][CW];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int m = 0; m < CW; ++m) acc[i][m] = 0.f;
      const float* xa = xs + RL * hi * ldx;
      const float* wa = wt + (PW * mp + cg) * ldx;
      for (int sl = 0; sl < ns; ++sl) {
        if (mp == 0) {
          cp_wait_pending(ns - 1 - sl);
          __syncthreads();    // slab sl landed (and W^T is staged)
        }
        const int q1 = min(nq, 16 * sl + 16);
        for (int jq = 16 * sl; jq < q1; ++jq) {
          float4 xv[RL];
#pragma unroll
          for (int i = 0; i < RL; ++i)
            xv[i] = *reinterpret_cast<const float4*>(xa + i * ldx + 4 * jq);
#pragma unroll
          for (int m = 0; m < CW; ++m) {
            const float4 wv =
                *reinterpret_cast<const float4*>(wa + 8 * m * ldx + 4 * jq);
#pragma unroll
            for (int i = 0; i < RL; ++i) {
              acc[i][m] = fmaf(xv[i].x, wv.x, acc[i][m]);
              acc[i][m] = fmaf(xv[i].y, wv.y, acc[i][m]);
              acc[i][m] = fmaf(xv[i].z, wv.z, acc[i][m]);
              acc[i][m] = fmaf(xv[i].w, wv.w, acc[i][m]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int m = 0; m < CW; ++m) {
          const int kc = PW * mp + cg + 8 * m;
          gs[(RL * hi + i) * ldg + kc] = acc[i][m] + bs[kc];
        }
    }
    __syncthreads();

    for (int e = t; e < TR * K; e += THREADS) {   // (row, lane) pairs
      const int r = e % TR, k = e / TR;
      const float rw = r < rows ? rwn[(size_t)k * n + row0 + r] : 0.f;
      const int yy = r < rows ? y[row0 + r] : 0;
      float* lg = gs + r * ldg + k * C;
      float m = lg[0];
      for (int c = 1; c < C; ++c) m = fmaxf(m, lg[c]);
      // the exponentials of the first 8 classes kept for g
      float ev[8], se = 0.f, gold = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (c < C) {
          ev[c] = expf(lg[c] - m);
          se += ev[c];
          gold += c == yy ? lg[c] : 0.f;
        }
      }
      for (int c = 8; c < C; ++c) {
        se += expf(lg[c] - m);
        gold += c == yy ? lg[c] : 0.f;
      }
      ls[k * TR + r] = (logf(se) + m - gold) * rw;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < C) lg[c] = (ev[c] / se - (c == yy ? 1.f : 0.f)) * rw;
      for (int c = 8; c < C; ++c)
        lg[c] = (expf(lg[c] - m) / se - (c == yy ? 1.f : 0.f)) * rw;
    }
    __syncthreads();

    // dW += x^T g over the tile's rows: j = 8 (hi + 32 a) + i, columns
    // PW mp + cg + 8 m; the sums so far come back from the partial
    for (int j0 = 8 * hi; j0 < d; j0 += 8 * 32) {
      for (int mp = 0; mp < np; ++mp) {
        float dw[8][CW];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int m = 0; m < CW; ++m) {
            const int j = j0 + i, kc = PW * mp + cg + 8 * m;
            dw[i][m] = it > 0 && j < d && kc < KC ? pp[(size_t)j * KC + kc]
                                                   : 0.f;
          }
        const float* xa = xs + j0;
        const float* ga = gs + PW * mp + cg;
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const float4 u = *reinterpret_cast<const float4*>(xa + r * ldx);
          const float4 v =
              *reinterpret_cast<const float4*>(xa + r * ldx + 4);
          const float xv[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
          float gv[CW];
#pragma unroll
          for (int m = 0; m < CW; ++m) gv[m] = ga[r * ldg + 8 * m];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int m = 0; m < CW; ++m)
              dw[i][m] = fmaf(xv[i], gv[m], dw[i][m]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int m = 0; m < CW; ++m) {
            const int j = j0 + i, kc = PW * mp + cg + 8 * m;
            if (j < d && kc < KC) pp[(size_t)j * KC + kc] = dw[i][m];
          }
      }
    }
    for (int kc = t; kc < KC; kc += THREADS) {      // db
      float s = it > 0 ? pp[(size_t)d * KC + kc] : 0.f;
      for (int r = 0; r < rows; ++r) s += gs[r * ldg + kc];
      pp[(size_t)d * KC + kc] = s;
    }
    for (int k = (t - lt0 + THREADS) % THREADS; k < K; k += THREADS) {
      float s = it > 0 ? pp[(size_t)d * KC + KC + k] : 0.f;
      for (int r = 0; r < rows; ++r) s += ls[k * TR + r];
      pp[(size_t)d * KC + KC + k] = s;
    }
  }
}

// out = the sum of the nb partials, in a fixed order: a block takes 32
// consecutive elements, warp w adds the partials of blocks [w pc, (w + 1)
// pc) in order, then the 8 run sums are added in warp order.  Element
// i < L of a partial: dW[j][kc] (i < d KC) to dw (K, d, C), then db and
// the loss.
__global__ void __launch_bounds__(THREADS)
probe_sum(const float* __restrict__ part, float* __restrict__ dw,
          float* __restrict__ db, float* __restrict__ loss, int nb, int d,
          int C, int K, int L) {
  __shared__ float runs[THREADS / 32][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const int pc = (nb + THREADS / 32 - 1) / (THREADS / 32);
  const int p1 = min(nb, (w + 1) * pc);
  float s = 0.f;
  if (i < L) {
#pragma unroll 8
    for (int p = w * pc; p < p1; ++p) s += part[(size_t)p * L + i];
  }
  runs[w][lane] = s;
  __syncthreads();
  if (w != 0 || i >= L) return;
  float tot = runs[0][lane];
  for (int r = 1; r < THREADS / 32; ++r) tot += runs[r][lane];
  const int KC = K * C;
  if (i < d * KC) {
    const int j = i / KC, kc = i - j * KC, k = kc / C;
    dw[((size_t)k * d + j) * C + kc - k * C] = tot;
  } else if (i < (d + 1) * KC) {
    db[i - d * KC] = tot;
  } else {
    loss[i - (d + 1) * KC] = tot;
  }
}

template <int CW, int RL>
cudaError_t launch_kernel(const float* x, const int* y, const float* rwn,
                          const float* w, const float* b, float* part,
                          int n, int d, int C, int K, int np, bool vec,
                          cudaStream_t stream) {
  // raise the dynamic shared-memory limit once per device and
  // instantiation (never inside a CUDA-graph capture of a later launch)
  static size_t granted[64] = {};
  const size_t smem = smem_floats(32 * RL, d, 8 * CW * np, K) * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    e = cudaFuncSetAttribute(probe_kernel<CW, RL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) granted[dev] = smem;
  }
  int rb, nb;
  row_split(n, &rb, &nb);
  probe_kernel<CW, RL><<<nb, THREADS, smem, stream>>>(
      x, y, rwn, w, b, part, n, d, C, K, np, rb, (int)vec);
  return cudaGetLastError();
}

template <int RL>
cudaError_t dispatch_cw(int cw, const float* x, const int* y,
                        const float* rwn, const float* w, const float* b,
                        float* part, int n, int d, int C, int K, int np,
                        bool vec, cudaStream_t s) {
  switch (cw) {
#define PROBE_CW(c)                                                       \
  case c:                                                                 \
    return launch_kernel<c, RL>(x, y, rwn, w, b, part, n, d, C, K, np,    \
                                vec, s);
    PROBE_CW(1) PROBE_CW(2) PROBE_CW(3) PROBE_CW(4)
    PROBE_CW(5) PROBE_CW(6) PROBE_CW(7) PROBE_CW(8)
#undef PROBE_CW
  }
  return cudaErrorInvalidValue;
}

// lanes a launch takes at (d, C): the most with K * C <= 64 (one lane
// where C passes 64) that fit one block; 0 if not even one lane fits
int group_lanes(int d, int C) {
  int tr, cw, np;
  for (int k = KC_PASS / C > 1 ? KC_PASS / C : 1; k > 0; --k)
    if (plan(d, C, k, &tr, &cw, &np)) return k;
  return 0;
}

}  // namespace

// Fold lanes one launch pair takes at (d, C) (the entry point walks K in
// groups of this many), 0 if (d, C) does not fit.
extern "C" int probe_group_lanes(int d, int C) {
  return d <= 0 || C <= 0 ? 0 : group_lanes(d, C);
}

// Floats of scratch the entry point needs for (n, d, C, K).
extern "C" long long probe_scratch_floats(int n, int d, int C, int K) {
  const int g = probe_group_lanes(d, C);
  if (g == 0 || n <= 0) return 0;
  const int k = K < g ? K : g;
  int rb, nb;
  row_split(n, &rb, &nb);
  return (long long)nb * ((long long)k * d * C + (long long)k * C + k);
}

// Launches on `stream`, for each group of lanes the kernel and the
// partials' sum; returns cudaGetLastError() (0 = launched).  Writes loss
// (K,), dw (K, d, C), db (K, C); `part` holds probe_scratch_floats floats.
extern "C" int probe(const float* x, const int* y, const float* rwn,
                     const float* w, const float* b, float* loss, float* dw,
                     float* db, float* part, int K, int n, int d, int C,
                     void* stream) {
  if (K <= 0 || n <= 0) return 0;
  const int g = probe_group_lanes(d, C);
  if (g == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  int rb, nb;
  row_split(n, &rb, &nb);
  for (int k0 = 0; k0 < K; k0 += g) {
    const int k = K - k0 < g ? K - k0 : g;
    int tr, cw, np;
    if (!plan(d, C, k, &tr, &cw, &np)) return (int)cudaErrorInvalidValue;
    const size_t wo = (size_t)k0 * d * C;
    const float* rk = rwn + (size_t)k0 * n;
    const cudaError_t e =
        tr == 128 ? dispatch_cw<4>(cw, x, y, rk, w + wo, b + k0 * C, part,
                                   n, d, C, k, np, vec, s)
        : tr == 64 ? dispatch_cw<2>(cw, x, y, rk, w + wo, b + k0 * C, part,
                                    n, d, C, k, np, vec, s)
                   : dispatch_cw<1>(cw, x, y, rk, w + wo, b + k0 * C, part,
                                    n, d, C, k, np, vec, s);
    if (e != cudaSuccess) return (int)e;
    const int L = (d + 1) * k * C + k;
    probe_sum<<<cdiv(L, 32), THREADS, 0, s>>>(part, dw + wo, db + k0 * C,
                                              loss + k0, nb, d, C, k, L);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return (int)e2;
  }
  return 0;
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
