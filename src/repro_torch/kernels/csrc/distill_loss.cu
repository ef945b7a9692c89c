// Paper Eq. 5 on Hopper (sm_90a), fp32, forward and backward.  Per row:
//
//     rec_i = mean_d (x_i - xh_i)^2
//     dis_i = mean_m |z_i - zt_i|^p          (p = 2 for MSE, 1 for MAE)
//     out_i = rec_i + lam * mask_i * dis_i
//
// and, in the mean form, loss_s = mean of out_i over segment s (S
// consecutive rows: the batch, or one lane's batch).  For row cotangents
// g_i, or in the mean form the cotangents G_s of the means, where
// g_i = G_s * fl(1/S) as PyTorch's mean backward rounds it on the card (a
// division by a host scalar runs as a multiply by its fp32 reciprocal):
//
//     dx_i    = (g_i * 2/D) * (x_i - xh_i)          d xh_i = -dx_i
//     dz_i    = (g_i * lam * mask_i) * ddis_i       d zt_i = -dz_i
//               ddis = 2 (z - zt) / M  (MSE)  or  sign(z - zt) / M  (MAE)
//     dmask_i = g_i * lam * dis_i
//
// for N rows: x, xh (N, D); z, zt (N, M); mask, out (N,); all row-major
// fp32.  A lane axis of the caller is folded into the rows.
//
// Replaces: repro/kernels/distill_loss.py::_kernel (pallas_call in
// _rows_fwd_call) and ::_bwd_kernel (pallas_call in _rows_bwd_call), the
// Eq. 5 loss of step 3 (distill.make_loss / make_lanes_loss with
// use_kernel=True) and its custom VJP, with ops.fused_distill_loss's mean
// and its backward folded in.
//
// What bounds it on the H100: bytes, each element read once for two or
// three operations.  At the training batch (128 rows x (5 + 256) columns)
// the bytes take under 0.2 us and a launch costs more, so the design is
// about launches: the loss of a training step is one forward launch (rows
// and mean) and one backward launch that writes only the gradients
// autograd asks for, with the negations folded in.  The TPU's pair plus
// the mean, its backward and two negations were six device kernels.
//
// Design.
// - One warp per row, as the kernel this one replaced, and the same sum
//   order, so the rows are the same bits: lane l adds elements l, l + 32,
//   l + 64, ... in turn, then an xor butterfly.  Where both rows of a pair
//   start 16-byte aligned, each full 128-element chunk arrives as one
//   16-byte load a lane (elements 4l .. 4l + 3), and 16 shuffles hand
//   lane l its old elements l, l + 32, l + 64, l + 96 (`old_order`); the
//   rest of the row, and a row that starts misaligned (D = 5 rows start
//   aligned every fourth row), go element by element in the old order.
//   A row's loads are issued before any of its arithmetic (`Items`: two
//   items of each pair at a time), so that its x and z pairs and its mask
//   cost one trip to memory, not one each.  Element by element in the old
//   order throughout, the backward takes 3.9-4.2 us, not 2.9, at 128 rows
//   (its 16-byte stores), and the forward 3.1-3.5 against 3.1.
// - The mean form, up to 128 rows a segment (the training batch): one
//   thread-block cluster of C <= 8 blocks of 512 threads a segment, rows
//   dealt to its warps in turn.  Each warp sums its rows in order and
//   stores the sum into rank 0's shared memory through distributed shared
//   memory; after one cluster barrier, lane l of rank 0's first warp adds
//   warp l of each rank in rank order, an xor butterfly adds the lanes,
//   and the sum is multiplied by fl(1/S) as torch.mean does.  Beyond 128
//   rows one cluster of 8 SMs falls behind (19.0 us at the validation
//   pass's 2,000 rows, 182 us at 20,000, against 4.4 and 18.0 for the
//   rows over the card then torch.mean; H100, tools/kernel_variants.py),
//   so the segment goes to a cooperative grid of 256-thread blocks over
//   the card: each block's warp sums, added in warp order, go to global
//   memory, and after one grid barrier block 0 of the segment adds them
//   in block order (5.6 us at 2,000 rows, 15.9 at 20,000; the cluster
//   stays 0.7 us faster at 128).  The sums take no atomic adds: a fixed
//   order for each shape.  The rows form runs blocks of 256 threads.
// - The backward: one warp per row over the whole grid (blocks of 128
//   threads), 16-byte loads and stores where the row's pointers allow,
//   each gradient written only where its pointer is set (d xh and d zt
//   as the negated products, which carry the bits of -dx and -dz);
//   dmask's sum takes the old order too.
// sign(0) is 0, as jnp.sign (copysignf would give +-1).  No fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD_THREADS = 512;      // the mean form's blocks
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int ROWS_THREADS = 256;     // the rows form's
constexpr int ROWS_WARPS = ROWS_THREADS / 32;
constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int CLUSTER_MAX = 8;          // portable cluster size
// the most rows a segment the mean form sums on one cluster: a row for
// each warp of the largest; more rows go to a cooperative grid
constexpr int CLUSTER_ROWS = CLUSTER_MAX * FWD_WARPS;
constexpr int CHUNK = 128;              // a warp's 16-byte loads: 32 x 4
constexpr int ITEMS = 2;                // items of each pair loaded at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float sign(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A chunk's differences arrive as lane l's e = elements 4l .. 4l + 3; the
// kernel this one replaced read elements l, l + 32, l + 64, l + 96 in lane
// l.  Element l + 32 k is component l % 4 of lane l / 4 + 8 k: for each k,
// every lane reads each component of that lane (the component a warp
// shuffles is the same in every lane, so nothing branches) and keeps the
// one it needs.
__device__ __forceinline__ float4 old_order(float4 e, int l) {
  const float in[4] = {e.x, e.y, e.z, e.w};
  float got[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int src = (l >> 2) + 8 * k;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float w = __shfl_sync(FULL, in[j], src);
      v = (l & 3) == j ? w : v;
    }
    got[k] = v;
  }
  return make_float4(got[0], got[1], got[2], got[3]);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// One element into a running sum as the kernel this one replaced compiled
// it: e * e as one fused multiply-add (SQ), |e| added (ABS).
enum Term { SQ, ABS };

template <Term T>
__device__ __forceinline__ float add_term(float s, float e) {
  if (T == SQ) return __fmaf_rn(e, e, s);
  return __fadd_rn(s, fabsf(e));
}

// A row's operands a, b of K elements as lane l's items, in the order the
// kernel this one replaced summed them: the full 128-element chunks first
// (a 16-byte load of each operand, when `vec`: every pointer of the row
// 16-byte aligned), then the lane's elements l, l + 32, ... of the rest.
// Loads and arithmetic are separate steps, so that a row's loads of both
// of its pairs are in flight together.
struct Items {
  const float* a;
  const float* b;
  int K, nc, n;           // elements, chunks, the most items of any lane

  __device__ __forceinline__ Items(const float* a_, const float* b_, int K_,
                                   bool vec)
      : a(a_), b(b_), K(K_), nc(vec ? K_ / CHUNK : 0) {
    n = nc + (K - nc * CHUNK + 31) / 32;
  }
  __device__ __forceinline__ int elem(int i, int l) const {
    return nc * CHUNK + (i - nc) * 32 + l;
  }
  // item i into va, vb (an element in .x); nothing past the lane's last
  __device__ __forceinline__ void load(int i, int l, float4& va,
                                       float4& vb) const {
    if (i < nc) {
      va = __ldg(reinterpret_cast<const float4*>(a + i * CHUNK) + l);
      vb = __ldg(reinterpret_cast<const float4*>(b + i * CHUNK) + l);
    } else if (elem(i, l) < K) {
      va.x = __ldg(a + elem(i, l));
      vb.x = __ldg(b + elem(i, l));
    }
  }
  // item i's terms added to s, a chunk's in the old lanes' order
  template <Term T>
  __device__ __forceinline__ float add(int i, int l, float s, float4 va,
                                       float4 vb) const {
    if (i < nc) {
      const float4 e = old_order(sub4(va, vb), l);
      s = add_term<T>(s, e.x);
      s = add_term<T>(s, e.y);
      s = add_term<T>(s, e.z);
      return add_term<T>(s, e.w);
    }
    return elem(i, l) < K ? add_term<T>(s, va.x - vb.x) : s;
  }
};

// Lane l's sums of a row: (x - xh)^2 over X and the term T of z - zt over
// Z, two items of each at a time with all four loads issued first.
template <Term T>
__device__ __forceinline__ float2 lane_sums(const Items& X, const Items& Z,
                                           int l) {
  float s = 0.f, q = 0.f;
  const int n = max(X.n, Z.n);
  for (int i = 0; i < n; i += ITEMS) {
    float4 xa[ITEMS], xb[ITEMS], za[ITEMS], zb[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      xa[j] = xb[j] = za[j] = zb[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      X.load(i + j, l, xa[j], xb[j]);
      Z.load(i + j, l, za[j], zb[j]);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      s = X.add<SQ>(i + j, l, s, xa[j], xb[j]);
      q = Z.add<T>(i + j, l, q, za[j], zb[j]);
    }
  }
  return make_float2(s, q);
}

// The cluster barrier in halves (as in lane_mlp_fwd.cu): a relaxed arrive
// at the start and its wait before the first store into a peer make sure
// the whole cluster runs; a release arrive and an acquire wait then make
// the stores visible.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The forms of the forward: the rows only; the mean form on one cluster a
// segment; the mean form on a cooperative grid.
enum Form { ROWS, CLUSTER, GRID };

// ROWS: blocks of 256 threads cover the rows, a warp each.  CLUSTER: grid
// (C, segments), a cluster of C blocks of 512 threads a segment.  GRID:
// grid (Cb, segments) of 256-thread blocks, all resident at once; each
// block's sum goes to part[segment * Cb + block], and after one grid
// barrier block 0 of each segment adds its blocks' sums in block order.
template <Form F>
__global__ void __launch_bounds__(F == CLUSTER ? FWD_THREADS : ROWS_THREADS, 1)
distill_fwd_kernel(const float* __restrict__ x, const float* __restrict__ xh,
                   const float* __restrict__ z, const float* __restrict__ zt,
                   const float* __restrict__ mask, float* __restrict__ out,
                   float* __restrict__ mean, float* __restrict__ part, int N,
                   int S, int D, int M, float lam, float inv_s, int mae) {
  constexpr int WARPS = (F == CLUSTER ? FWD_THREADS : ROWS_THREADS) / 32;
  __shared__ float wsum[F == CLUSTER ? CLUSTER_MAX * WARPS : WARPS];
  if constexpr (F == CLUSTER) cluster_arrive_relaxed();
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int stride = gridDim.x * WARPS;
  int row = blockIdx.x * WARPS + warp, end = N;
  if (F != ROWS) {
    row += blockIdx.y * S;
    end = (blockIdx.y + 1) * S;
  }
  float acc = 0.f;                      // this warp's rows, in order
  for (; row < end; row += stride) {
    const float m = mask[row];
    const float *xr = x + (size_t)row * D, *xhr = xh + (size_t)row * D;
    const float *zr = z + (size_t)row * M, *ztr = zt + (size_t)row * M;
    const Items X(xr, xhr, D, aligned16(xr) && aligned16(xhr));
    const Items Z(zr, ztr, M, aligned16(zr) && aligned16(ztr));
    const float2 sq = mae ? lane_sums<ABS>(X, Z, l) : lane_sums<SQ>(X, Z, l);
    const float s = warp_sum(sq.x), q = warp_sum(sq.y);
    const float v = s / (float)D + lam * m * (q / (float)M);
    if (l == 0) out[row] = v;
    acc += v;
  }
  if constexpr (F == CLUSTER) {
    // each warp's sum into rank 0's shared memory, slot rank * WARPS + warp
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    cluster_wait();                     // every block of the cluster runs
    if (l == 0) *cluster.map_shared_rank(wsum + rank * WARPS + warp, 0) = acc;
    cluster_arrive();
    cluster_wait();                     // rank 0 holds every warp's sum
    if (rank == 0 && warp == 0) {
      float t = 0.f;                    // lane l: warp l of each rank
      for (int r = 0; l < WARPS && r < (int)gridDim.x; ++r)
        t += wsum[r * WARPS + l];
      t = warp_sum(t);
      if (l == 0) mean[blockIdx.y] = t * inv_s;
    }
  }
  if constexpr (F == GRID) {
    float* seg = part + (size_t)blockIdx.y * gridDim.x;
    if (l == 0) wsum[warp] = acc;
    __syncthreads();
    if (warp == 0) {                    // lane l: warp l's sum
      const float t = warp_sum(l < WARPS ? wsum[l] : 0.f);
      if (l == 0) seg[blockIdx.x] = t;
    }
    cg::this_grid().sync();             // every block's sum is written
    if (blockIdx.x == 0 && warp == 0) {
      float t = 0.f;                    // lane l: blocks l, l + 32, ...
      for (int b = l; b < (int)gridDim.x; b += 32) t += seg[b];
      t = warp_sum(t);
      if (l == 0) mean[blockIdx.y] = t * inv_s;
    }
  }
}

// One warp a row; a null output pointer skips that gradient.  Two items
// of each pair at a time, all their loads issued first.
__global__ void __launch_bounds__(BWD_THREADS, 1)
distill_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ xh, const float* __restrict__ z,
                   const float* __restrict__ zt,
                   const float* __restrict__ mask, float* __restrict__ dx,
                   float* __restrict__ dxh, float* __restrict__ dz,
                   float* __restrict__ dzt, float* __restrict__ dmask, int N,
                   int S, int D, int M, float lam, float inv_s,
                   float two_over_d, int mae) {
  const int row = blockIdx.x * BWD_WARPS + threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  if (row >= N) return;
  const bool wx = dx || dxh, wz = dz || dzt || dmask;
  const size_t ox = (size_t)row * D, oz = (size_t)row * M;
  float* px = dx ? dx + ox : nullptr;
  float* nx = dxh ? dxh + ox : nullptr;
  float* pz = dz ? dz + oz : nullptr;
  float* nz = dzt ? dzt + oz : nullptr;
  const auto ok = [](const void* p) { return !p || aligned16(p); };
  const Items X(x + ox, xh + ox, D, aligned16(x + ox) && aligned16(xh + ox)
                                    && ok(px) && ok(nx));
  const Items Z(z + oz, zt + oz, M, aligned16(z + oz) && aligned16(zt + oz)
                                    && ok(pz) && ok(nz));
  const float gr = S ? g[row / S] * inv_s : g[row];
  const float m = wz ? mask[row] : 0.f;
  const float cx = gr * two_over_d;
  const float cz = gr * lam * m;
  const float fm = (float)M;
  const auto dgrad = [&](float e) {
    return mae ? cz * (sign(e) / fm) : cz * (2.f * e / fm);
  };
  float q = 0.f;
  const int n = max(wx ? X.n : 0, wz ? Z.n : 0);
  for (int i = 0; i < n; i += ITEMS) {
    float4 xa[ITEMS], xb[ITEMS], za[ITEMS], zb[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      xa[j] = xb[j] = za[j] = zb[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (wx) X.load(i + j, l, xa[j], xb[j]);
      if (wz) Z.load(i + j, l, za[j], zb[j]);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int t = i + j;
      if (wx && t < X.nc) {
        const float4 e = sub4(xa[j], xb[j]);
        const float4 v = make_float4(cx * e.x, cx * e.y, cx * e.z, cx * e.w);
        if (px) reinterpret_cast<float4*>(px + t * CHUNK)[l] = v;
        if (nx) reinterpret_cast<float4*>(nx + t * CHUNK)[l] =
            make_float4(-v.x, -v.y, -v.z, -v.w);
      } else if (wx && X.elem(t, l) < D) {
        const float v = cx * (xa[j].x - xb[j].x);
        if (px) px[X.elem(t, l)] = v;
        if (nx) nx[X.elem(t, l)] = -v;
      }
      if (wz && t < Z.nc) {
        const float4 e = sub4(za[j], zb[j]);
        if (pz || nz) {
          const float4 v = make_float4(dgrad(e.x), dgrad(e.y), dgrad(e.z),
                                       dgrad(e.w));
          if (pz) reinterpret_cast<float4*>(pz + t * CHUNK)[l] = v;
          if (nz) reinterpret_cast<float4*>(nz + t * CHUNK)[l] =
              make_float4(-v.x, -v.y, -v.z, -v.w);
        }
      } else if (wz && Z.elem(t, l) < M) {
        const float v = dgrad(za[j].x - zb[j].x);
        if (pz) pz[Z.elem(t, l)] = v;
        if (nz) nz[Z.elem(t, l)] = -v;
      }
      if (dmask)
        q = mae ? Z.add<ABS>(t, l, q, za[j], zb[j])
                : Z.add<SQ>(t, l, q, za[j], zb[j]);
    }
  }
  if (dmask) {
    q = warp_sum(q);
    if (l == 0) dmask[row] = gr * lam * (q / (float)M);
  }
}

// The blocks of distill_fwd_kernel<GRID> the current device holds at once.
int grid_capacity() {
  static int cap[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (!cap[dev]) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, distill_fwd_kernel<GRID>, ROWS_THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cap[dev] = per_sm * sms;
  }
  return cap[dev];
}

}  // namespace

// Rows form (mean null): out (N,) only.  Mean form: also mean (N / S,) of
// each segment of S rows (S >= 1 dividing N), on one cluster a segment
// while S <= CLUSTER_ROWS, else on a cooperative grid of at most `cap`
// blocks whose sums go to `part` (cap floats).  Launches on `stream`;
// returns the launch's error code (0 = launched).
extern "C" int distill_fwd(const float* x, const float* xh, const float* z,
                           const float* zt, const float* mask, float* out,
                           float* mean, float* part, int cap, int N, int S,
                           int D, int M, float lam, int mae, void* stream) {
  if (D <= 0 || M <= 0 || N < 0 || (mean && (S <= 0 || N % S)))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!mean) {
    distill_fwd_kernel<ROWS><<<(N + ROWS_WARPS - 1) / ROWS_WARPS,
                               ROWS_THREADS, 0, s>>>(
        x, xh, z, zt, mask, out, nullptr, nullptr, N, 0, D, M, lam, 0.f,
        mae);
    return (int)cudaGetLastError();
  }
  const int L = N / S;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  // fl(1/S), the factor torch.mean multiplies its sum by
  const float inv_s = 1.0f / (float)S;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (S <= CLUSTER_ROWS) {
    int C = 1;
    while (C < CLUSTER_MAX && C * FWD_WARPS < S) C <<= 1;
    cfg.gridDim = dim3(C, L);
    cfg.blockDim = dim3(FWD_THREADS);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    e = cudaLaunchKernelEx(&cfg, distill_fwd_kernel<CLUSTER>, x, xh, z, zt,
                           mask, out, mean, part, N, S, D, M, lam, inv_s,
                           mae);
  } else {
    const int fit = min(grid_capacity(), cap) / L;
    if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int Cb = min((S + ROWS_WARPS - 1) / ROWS_WARPS, fit);
    cfg.gridDim = dim3(Cb, L);
    cfg.blockDim = dim3(ROWS_THREADS);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    e = cudaLaunchKernelEx(&cfg, distill_fwd_kernel<GRID>, x, xh, z, zt,
                           mask, out, mean, part, N, S, D, M, lam, inv_s,
                           mae);
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// g (N,) row cotangents (S = 0), or (N / S,) cotangents of the segment
// means; a null dx, dxh, dz, dzt or dmask is not written.
extern "C" int distill_bwd(const float* g, const float* x, const float* xh,
                           const float* z, const float* zt, const float* mask,
                           float* dx, float* dxh, float* dz, float* dzt,
                           float* dmask, int N, int S, int D, int M,
                           float lam, int mae, void* stream) {
  if (D <= 0 || M <= 0 || N < 0 || S < 0 || (S && N % S))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || !(dx || dxh || dz || dzt || dmask)) return 0;
  const int blocks = (N + BWD_WARPS - 1) / BWD_WARPS;
  // fl(1/S) as the mean's backward rounds it; 2/D rounded once from
  // double, as the reference's Python 2.0 / D
  distill_bwd_kernel<<<blocks, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      g, x, xh, z, zt, mask, dx, dxh, dz, dzt, dmask, N, S, D, M, lam,
      S ? 1.0f / (float)S : 0.f, (float)(2.0 / D), mae);
  return (int)cudaGetLastError();
}

extern "C" const char* distill_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
