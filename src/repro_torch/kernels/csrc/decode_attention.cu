// One-token decode attention against a slot KV cache on Hopper (sm_90a),
// fp32 math on the CUDA cores:
//
//     out[b, h] = sum_w softmax_w(q[b, h] . k[b, w, kh] * scale + mask)
//                 * v[b, w, kh],        kh = h / (H / K)  (GQA)
//
// q (B, H, hd), k/v (B, W, K, hd) in the cache's own layout, fp32 or bf16;
// slot_pos (W,) int32, the position written in each slot (-1 = empty); pos
// the current position, a host int; out (B, H, hd) in q's type.  A slot is
// valid when slot_pos >= 0, slot_pos <= pos and, with a window,
// slot_pos > pos - window.
//
// Replaces: repro/kernels/decode_attention.py::_kernel (pallas_call in
// decode_attention).  The port's one-token decode
// (models/attention.decode_attention) runs it on every CUDA tensor, once
// per attention layer and decode step; the reference computes the same
// function with _sdpa and a slot bias, and its tests hold the two together.
//
// What bounds it on the H100: the bytes of the valid slots' K and V rows,
// read once, against 3.35 TB/s (5.0 us at internlm2-1.8b's engine shape: B
// 8, 512 of 1024 slots written, K 8, hd 128, bf16); its 4*hd operations
// per slot and q head are far below the bytes' time.  So the design is
// about reading each row once, wide, with enough of them in flight, over
// enough of the card.
//
// Design.
// - One cluster of C blocks per (b, kv head), serving all G = H / K of
//   its q heads: each K and V row is read from device memory once and
//   feeds the G scores and G accumulators from registers.
// - 16-byte loads.  A row is split over `lpr` neighbouring lanes (hd / 8
//   for bf16, hd / 4 for fp32, rounded up to a power of two), so a warp
//   reads 32 / lpr slots at once; each lane keeps the G query slices and
//   accumulators of its 16 bytes of head dims.  Each sub-warp has U slots
//   (8 where G <= 2) in flight before it uses any of them, and the slot
//   positions come through shared memory, loaded once for 2048 slots, so
//   no K/V load waits on the load of its slot's position.
// - The slots go to the cluster's warps in chunks of 32 / lpr neighbours,
//   chunk i to warp i % (4 C): every block of the cluster takes an equal
//   share of a cache whose written slots form a prefix (the engine's) or
//   a wrapped ring, where contiguous ranges would leave blocks idle.
//   The wrapper picks C in {1, 2, 4, 8} so that the grid fills the card.
// - Invalid slots are skipped, their rows never read: in the reference
//   they add p = 0 and leave the max as it was, so skipping is exact.
// - Each sub-warp keeps an online softmax (m, l, acc) in fp32.  The
//   partials merge in a fixed order: sub-warps by butterfly shuffles,
//   warps through shared memory, then each block stores its partial into
//   rank 0's shared memory (distributed shared memory; the stores wait
//   until the whole cluster runs, the first half of a split barrier
//   arrived at the start), and after one cluster barrier rank 0 merges the
//   C partials in rank order and writes out.  One launch, no atomics, no
//   scratch in device memory, the same bits on every run.  A share with no
//   valid slot merges as m = -1e30, l = 0; a row with none anywhere is 0.
//   out = acc / max(l, 1e-30), as the reference.  No fast-math.
// What holds it back (PERF.md, tools/kernel_variants.py): the part of a
// call that does not scale with the slots (launch, the slot positions'
// load, the merges and the barrier) is as long as the bytes' time; at
// zamba2's heads (G = 1, hd 80) a row is 10 of a sub-warp's 16 lanes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int HD_MAX = 128;
constexpr int G_MAX = 8;                // q heads a kv head serves
constexpr int CLUSTER_MAX = 8;          // portable cluster size
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SPC = 2048;               // slot positions staged at a time
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes of T as floats (exact)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {         // low half is the lower address
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// The cluster barrier in halves.  A relaxed arrive at the start and its
// wait before the first store into a peer's shared memory make sure that
// every block of the cluster is running; a release arrive and an acquire
// wait then make the stores visible to the peer.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ slot_pos,
              T* __restrict__ out, int H, int K, int W, int hd, int lpr,
              int pos, int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // head dims per 16-byte load
  // slots in flight a sub-warp: as many as keep a 4-warp block within
  // 128 registers a thread, so that four blocks fit an SM
  constexpr int U = G == 1 ? 8 : G <= 4 ? 4 : 2;
  __shared__ int sps[SPC];              // slot_pos of the current chunk
  __shared__ float wm[WARPS][G], wl[WARPS][G];
  __shared__ __align__(16) float wacc[WARPS][G][HD_MAX];
  // rank 0's: every block's partial, [C][G][hd] sums, then [C][G] maxima
  // and [C][G] denominators
  extern __shared__ float cpart[];

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int spw = 32 / lpr;             // slots a warp reads at once
  const int sub = lane / lpr;
  const int d0 = (lane % lpr) * VEC;    // this lane's first head dim
  const bool on = d0 < hd;
  const size_t row = (size_t)K * hd;    // elements from slot to slot
  const T* kb = k + ((size_t)b * W * K + kh) * hd + d0;
  const T* vb = v + ((size_t)b * W * K + kh) * hd + d0;

  float qv[G][VEC], acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qr = q + ((size_t)b * H + kh * G + g) * hd + d0;
    float f[VEC];
    unpack(on ? *reinterpret_cast<const uint4*>(qr) : make_uint4(0, 0, 0, 0),
           f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qv[g][e] = f[e];
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  // chunk i of spw neighbouring slots goes to warp i % (C * WARPS); the
  // slot positions come through shared memory, SPC at a time, so that no
  // K/V load waits on a load of its slot's position
  const int stride = C * WARPS * spw;
  const int mine = (rank * WARPS + warp) * spw + sub;
  for (int c0 = 0; c0 < W; c0 += SPC) {
    const int cn = min(SPC, W - c0);
    int spv[SPC / THREADS];             // all loads in flight at once
#pragma unroll
    for (int j = 0; j < SPC / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      spv[j] = i < cn ? __ldg(slot_pos + c0 + i) : -1;
    }
    __syncthreads();                    // the last chunk's readers are done
#pragma unroll
    for (int j = 0; j < SPC / THREADS; ++j)
      sps[threadIdx.x + j * THREADS] = spv[j];
    __syncthreads();
    for (int base = 0; base < cn; base += U * stride) {
      bool ok[U];
      bool any = false;
      uint4 kr[U], vr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = base + u * stride + mine;
        const int sp = w < cn ? sps[w] : -1;
        ok[u] = sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
        any |= ok[u];
        const bool ld = ok[u] && on;
        const size_t at = (size_t)(c0 + w) * row;
        kr[u] = ld ? __ldg(reinterpret_cast<const uint4*>(kb + at))
                   : make_uint4(0, 0, 0, 0);
        vr[u] = ld ? __ldg(reinterpret_cast<const uint4*>(vb + at))
                   : make_uint4(0, 0, 0, 0);
      }
      if (!__any_sync(FULL, any)) continue;       // warp-uniform
      float s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        unpack(kr[u], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) t = fmaf(qv[g][e], kf[e], t);
          s[u][g] = t;
        }
      }
      // each sub-warp's lpr lanes sum their slices; all end with the same
      // bits
      for (int off = lpr >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[u][g] += __shfl_xor_sync(FULL, s[u][g], off);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u][g] *= scale;
          if (ok[u]) mx = fmaxf(mx, s[u][g]);
        }
        const float alpha = expf(m[g] - mx);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
        m[g] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        float vf[VEC];
        unpack(vr[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = expf(s[u][g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
  }

  // the warp's sub-warps merge by butterfly; sub-warp 0's lanes keep it
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo = __shfl_xor_sync(FULL, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float ca = expf(m[g] - M), cb = expf(mo - M);
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = M;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        wm[warp][g] = m[g];
        wl[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) wacc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  // the block's partial, warps in order, into slot `rank` of rank 0's
  // shared memory
  cluster_wait();                       // every block of the cluster runs
  float* part = cluster.map_shared_rank(cpart, 0);
  float* pmax = part + C * G * hd;
  float* pden = pmax + C * G;
  for (int o = threadIdx.x; o < G * hd; o += THREADS) {
    const int g = o / hd, d = o - g * hd;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(wm[w][g] - M);
      L += wl[w][g] * c;
      A += wacc[w][g][d] * c;
    }
    if (d == 0) {
      pmax[rank * G + g] = M;
      pden[rank * G + g] = L;
    }
    part[(rank * G + g) * hd + d] = A;
  }
  cluster_arrive();                     // rank 0 holds every partial once
  cluster_wait();                       // all have arrived
  if (rank != 0) return;

  // rank 0 merges the C partials in rank order
  for (int o = threadIdx.x; o < G * hd; o += THREADS) {
    const int g = o / hd, d = o - g * hd;
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r)
      if (r < C) M = fmaxf(M, pmax[r * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {
      if (r >= C) break;
      const float c = expf(pmax[r * G + g] - M);
      L += pden[r * G + g] * c;
      A += part[(r * G + g) * hd + d] * c;
    }
    store(out + ((size_t)b * H + kh * G + g) * hd + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* slot_pos, void* out, int B, int H, int K, int W,
                   int hd, int pos, int window, float scale, int cluster,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // once per instance: room for the largest cluster's partials
  static const cudaError_t smem_attr = cudaFuncSetAttribute(
      decode_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(CLUSTER_MAX * G * (HD_MAX + 2) * sizeof(float)));
  if (smem_attr != cudaSuccess) return smem_attr;
  int lpr = 1;
  while (lpr * VEC < hd) lpr <<= 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, K, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)cluster * G * (hd + 2) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, G>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), slot_pos,
      static_cast<T*>(out), H, K, W, hd, lpr, pos, window, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const int* slot_pos, void* out, int B, int H, int K,
                     int W, int hd, int pos, int window, float scale,
                     int cluster, cudaStream_t s) {
#define DECODE_G(n)                                                        \
  case n:                                                                  \
    return launch<T, n>(q, k, v, slot_pos, out, B, H, K, W, hd, pos,       \
                        window, scale, cluster, s);
  switch (G) {
    DECODE_G(1) DECODE_G(2) DECODE_G(3) DECODE_G(4)
    DECODE_G(5) DECODE_G(6) DECODE_G(7) DECODE_G(8)
  }
#undef DECODE_G
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_max_hd() { return HD_MAX; }
extern "C" int decode_attention_max_group() { return G_MAX; }

// dtype 0 = fp32, 1 = bf16 (q, the cache and out alike); hd a multiple of
// 4 (fp32) or 8 (bf16) up to 128, H / K at most 8; `cluster` blocks split
// the slots of each (b, kv head), 1 to 8.  Launches on `stream`; returns
// the launch's error code (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* slot_pos, void* out, int B, int H,
                                int K, int W, int hd, int pos, int window,
                                float scale, int cluster, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int vec = dtype == 1 ? 8 : 4;
  if (K <= 0 || H % K != 0 || H / K > G_MAX || W <= 0 || hd <= 0 ||
      hd > HD_MAX || hd % vec != 0 || window < 0 || B > 65535 ||
      K > 65535 || cluster < 1 || cluster > CLUSTER_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = H / K;
  if (dtype == 0)
    return (int)launch_g<float>(G, q, k, v, slot_pos, out, B, H, K, W, hd,
                                pos, window, scale, cluster, s);
  if (dtype == 1)
    return (int)launch_g<__nv_bfloat16>(G, q, k, v, slot_pos, out, B, H, K,
                                        W, hd, pos, window, scale, cluster,
                                        s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
