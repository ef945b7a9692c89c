// One-token decode attention against a slot KV cache on Hopper (sm_90a):
//
//     out[b, h] = sum_w softmax_w(q[b, h] . k[b, w, kh] * scale + mask)
//                 * v[b, w, kh],        kh = h / (H / K)  (GQA)
//
// q (B, H, hd), k/v (B, W, K, hd) in the cache's own layout, fp32 or bf16;
// slot_pos (W,) int32, the position written in each slot (-1 = empty); pos
// the current position, a host int, or read from device memory at pos_at
// where that pointer is not null (a CUDA graph of the serving engine's
// decode step replays one launch at every position: each block reads it
// once at its start, and nothing after that differs); out (B, H, hd) in
// q's type.  A slot is valid when slot_pos >= 0, slot_pos <= pos and, with
// a window, slot_pos > pos - window.
//
// Replaces: repro/kernels/decode_attention.py::_kernel (pallas_call in
// decode_attention).  The port's one-token decode
// (models/attention.decode_attention) runs it on every CUDA tensor, once
// per attention layer and decode step, and the VLM's decode over its image
// K/V (models/attention.decode_cross_attention); the reference computes the
// same function with _sdpa and a slot bias, and its tests hold the two
// together.
//
// What bounds it on the H100: the bytes of the valid slots' K and V rows,
// read once, against 3.35 TB/s (5.0 us at internlm2-1.8b's engine shape: B
// 8, 512 of 1024 slots written, K 8, hd 128, bf16; 2.5 us at qwen3-moe's K
// 4; 15.7 us over the VLM's 1600 image tokens); its 4*hd operations per
// slot and q head are far below the bytes' time.  So the design is about
// reading each row once, wide, with enough of them in flight, over enough
// of the card, and about keeping the work per q head off that path.
//
// Two routes, one C entry each; the launcher picks one from (dtype, G, hd)
// alone (kernels/decode_attention.route):
//
// "slots" (decode_attention: fp32 at every G, bf16 at G = H / K <= 3 or at
// hd not a multiple of 16), decode_kernel<T, G>, fp32 math on the CUDA
// cores:
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
// At G >= 4 the per-head work of this route (G partial dot products and
// four shuffle rounds a slot, each exponential on 16 lanes, 2 G VEC
// registers that leave 2 to 4 slots in flight, and merges that take
// exp(m - M) once per head dim) outweighs the bytes: the grouped route.
//
// "grouped" (decode_attention_grouped: bf16, G >= 4, hd a multiple of 16),
// decode_kernel_grouped<HD>, on the warp-level tensor cores
// (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32):
// - A cluster of C blocks of 4 warps per (b, kv head), as above.  The
//   slots go in tiles of 16, tile i of a 2048-slot chunk to warp i % (4 C)
//   of the cluster.  A tile none of whose slots is valid is skipped before
//   anything of it is read.
// - Each warp streams its tiles through a ring of two stages of K and V
//   (16 rows each, rows padded to hd + 8 bf16 so that ldmatrix phases hit
//   distinct banks) by 16-byte cp.async: the next tile's rows are in flight
//   while this one's math runs.  An invalid slot's rows are zero-filled by
//   cp.async's source size, never read.
// - Scores S = Q.K^T with the G q heads as the 16 rows of M (rows G..15
//   zero); Q's A fragments are loaded once and stay in registers, K's B
//   fragments come by ldmatrix.  bf16 x bf16 products are exact in fp32.
// - Online softmax in fp32 on the accumulators: a thread holds 4 slots of
//   one head, a row's max is two quad shuffles a tile, each exponential is
//   computed once (exp2f, the scale folded into log2 e); an invalid slot
//   gets p = 0 exactly.
// - O += P.V with P never rounded once to bf16: P = hi + lo, hi = bf16(p),
//   lo = bf16(p - hi) (p - hi is exact; what lo drops is <= 2^-18 p).  hi
//   fills rows 0..7 of the A fragment and lo rows 8..15, the rows Q left
//   empty, so one mma a dim tile carries both, straight from the score
//   accumulators; V's B fragments come by ldmatrix.trans.  A head's output
//   is the sum of its hi and lo rows.
// - Merges once per head: each warp's (m, l, O) goes to its own ring;
//   each head's factors exp2(m_w - M) are computed once into shared memory
//   and the warps' sums weighted in warp order.  The final merge is spread
//   over the cluster: block j merges the j-th slice of the G x hd outputs,
//   so each block stores slice j of its partial, with its maxima and
//   denominators, into block j's shared memory (distributed shared
//   memory, after the same split barrier as above); after one cluster
//   barrier every block computes exp2(m_r - M) once a (block, head) and
//   sums its slice in rank order.  No atomics, the same bits on every
//   run; a row with no valid slot is 0.
// - The cluster size is the largest C that keeps the grid within one
//   block an SM (decode_attention.grouped_cluster): the merges and the
//   barrier grow with C, and more, emptier blocks were slower.
// What holds it back (PERF.md, tools/kernel_variants.py): at 512 valid
// slots (qwen3, the VLM's self-attention) the part that does not scale
// with the slots (launch, the slot positions' round trip, a tile's round
// trip, the merges and the barriers) is most of the call; over the image
// cache the loads are only partly hidden behind the tiles' math, since a
// block's 4 warps are one a scheduler and each tile's scores, softmax and
// P.V are a dependent chain (8 warps or a third stage did not help).

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
              int pos, const int* __restrict__ pos_at, int window,
              float scale) {
  constexpr int VEC = 16 / sizeof(T);   // head dims per 16-byte load
  if (pos_at != nullptr) pos = __ldg(pos_at);
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
                   int hd, int pos, const int* pos_at, int window,
                   float scale, int cluster, cudaStream_t stream) {
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
      static_cast<T*>(out), H, K, W, hd, lpr, pos, pos_at, window, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The grouped route: bf16, G >= 4, hd a multiple of 16
// ---------------------------------------------------------------------------

constexpr int TS = 16;                  // slots a tile (P.V's k)
constexpr int NS = 2;                   // stages of a warp's K/V ring
constexpr int GWARPS = 4;               // warps a block
constexpr int GTHREADS = 32 * GWARPS;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared (a shared-space address); zero-filled, nothing
// read, when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// whether the slot holding position `at` is seen from `pos`
__device__ __forceinline__ bool slot_seen(int at, int pos, int window) {
  return at >= 0 && at <= pos && (window <= 0 || at > pos - window);
}

// One 16-slot tile of a warp: the scores of its q heads (rows g of the
// mma, slots 8 j + 2 tg + e), the online-softmax step for row g, and
// O += P.V.  `mask` has bit i set where slot i of the tile is valid (some
// bit is); Kt / Vt are this lane's ldmatrix addresses in the tile's stage.
// m is row g's running max on the log2 scale, l this thread's part of its
// denominator; o[j] holds dims 8 j + 2 tg + (0, 1) of row g's hi sums in
// [0..1] and of its lo sums in [2..3].
template <int HD>
__device__ __forceinline__ void grouped_tile(
    uint32_t Kt, uint32_t Vt, const uint32_t (&qa)[HD / 16][2],
    float (&o)[HD / 8][4], float& m, float& l, unsigned mask, int tg,
    float scale_log2) {
  constexpr int KS = HD / 16;
  constexpr int DN = HD / 8;
  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    // slots 0..7 (kf[0], kf[1]) and 8..15 (kf[2], kf[3]), dims 16 kk + 0..15
    uint32_t kf[4];
    ldsm_x4(kf, Kt + kk * 32);
    const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
    mma_bf16(s[0], a, kf[0], kf[1]);
    mma_bf16(s[1], a, kf[2], kf[3]);
  }
  float mx = NEG_INF;                   // of the raw scores of valid slots
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if ((mask >> (8 * j + 2 * tg + e)) & 1u) mx = fmaxf(mx, s[j][e]);
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
  const float m_new = fmaxf(m, mx * scale_log2);      // scale > 0
  const float alpha = exp2f(m - m_new);
  m = m_new;
  l *= alpha;
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha;
  // P's A fragment for the tile's 16 slots: hi in rows g, lo in rows g + 8
  uint32_t pa[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float p[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[e] = (mask >> (8 * j + 2 * tg + e)) & 1u
                 ? exp2f(fmaf(s[j][e], scale_log2, -m))
                 : 0.f;
      l += p[e];
    }
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p[0], p[1]);
    const float2 hf = __bfloat1622float2(hi);
    pa[2 * j] = bits(hi);
    pa[2 * j + 1] = bits(__floats2bfloat162_rn(p[0] - hf.x, p[1] - hf.y));
  }
#pragma unroll
  for (int dp = 0; dp < DN / 2; ++dp) {
    // slots 0..7 / 8..15 by dims 16 dp + 0..7 (vf[0], vf[1]) and + 8..15
    // (vf[2], vf[3]), transposed
    uint32_t vf[4];
    ldsm_x4_trans(vf, Vt + dp * 32);
    mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
    mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(GTHREADS)
decode_kernel_grouped(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ slot_pos,
                      __nv_bfloat16* __restrict__ out, int H, int K, int W,
                      int pos, const int* __restrict__ pos_at, int window,
                      float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= HD_MAX, "hd: a multiple of 16");
  if (pos_at != nullptr) pos = __ldg(pos_at);
  constexpr int LD = HD + 8;            // shared row stride, bf16
  constexpr uint32_t ROW = LD * 2;      // bytes
  constexpr uint32_t TILE = TS * ROW;   // a K or a V tile
  constexpr uint32_t STAGE = 2 * TILE;  // K, then V
  constexpr int CH = HD / 8;            // 16-byte chunks a row
  constexpr int KS = HD / 16;           // k-steps of the scores
  constexpr int DN = HD / 8;            // n-tiles of O
  constexpr int LW = HD + 4;            // a warp's partial: row stride
  static_assert(G_MAX * LW * 4 <= NS * STAGE, "a warp's partial fits");
  __shared__ int sps[SPC];              // slot_pos of the current chunk
  __shared__ float wm[GWARPS][G_MAX], wl[GWARPS][G_MAX];
  __shared__ float wf[GWARPS][G_MAX];
  __shared__ float bm[G_MAX], bl[G_MAX];
  __shared__ float rf[CLUSTER_MAX][G_MAX], rl[G_MAX];
  // the warps' rings [GWARPS][NS][K, V][TS][LD] bf16, then the slices the
  // cluster's blocks store here for this block to merge
  extern __shared__ float4 gsm[];

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int G = H / K;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;         // mma row, thread in quad
  const size_t row = (size_t)K * HD;    // elements from slot to slot
  const size_t kv0 = ((size_t)b * W * K + kh) * HD;
  const __nv_bfloat16* kb = k + kv0;
  const __nv_bfloat16* vb = v + kv0;
  const uint32_t ring = smem_addr(gsm) + warp * NS * STAGE;
  // this lane's ldmatrix rows: K (slots + 0..7 | 8..15, dims + 0 | 8) and
  // V transposed (slots + 0..7 | 8..15, dims + 0 | 8)
  const uint32_t k_lane = ((lane & 7) + ((lane >> 4) << 3)) * ROW +
                          ((lane >> 3) & 1) * 16;
  const uint32_t v_lane = TILE + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                          (lane >> 4) * 16;

  // Q's A fragments of row g (q head kh G + g; zero past G), dims
  // 16 kk + 2 tg + (0, 1) and + 8; rows 8..15 are zero
  uint32_t qa[KS][2];
  {
    const bool on = g < G;
    const __nv_bfloat16* qr =
        q + ((size_t)b * H + kh * G + (on ? g : 0)) * HD + 2 * tg;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = on ? __ldg(reinterpret_cast<const unsigned*>(qr + 16 * kk))
                     : 0u;
      qa[kk][1] = on ? __ldg(reinterpret_cast<const unsigned*>(
                           qr + 16 * kk + 8))
                     : 0u;
    }
  }
  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int nw = C * GWARPS;            // warps of the cluster
  const int wc = rank * GWARPS + warp;  // this one
  for (int c0 = 0; c0 < W; c0 += SPC) {
    const int cn = min(SPC, W - c0);
    int spv[SPC / GTHREADS];            // all loads in flight at once
#pragma unroll
    for (int j = 0; j < SPC / GTHREADS; ++j) {
      const int i = threadIdx.x + j * GTHREADS;
      spv[j] = i < cn ? __ldg(slot_pos + c0 + i) : -1;
    }
    __syncthreads();                    // the last chunk's readers are done
#pragma unroll
    for (int j = 0; j < SPC / GTHREADS; ++j)
      sps[threadIdx.x + j * GTHREADS] = spv[j];
    __syncthreads();
    const int nt = (cn + TS - 1) / TS;
    int t = wc;                         // the next tile to look at
    // this warp's next tile with a valid slot (-1: none left) and its mask
    auto next = [&](unsigned& mask) {
      for (; t < nt; t += nw) {
        const int w = t * TS + (lane & 15);
        mask = __ballot_sync(FULL, w < cn && slot_seen(sps[w], pos, window)) &
               0xffffu;
        if (mask) {
          t += nw;
          return t - nw;
        }
      }
      return -1;
    };
    // the tile's K and V rows into a stage; one commit group either way
    auto issue = [&](uint32_t stage, int tile, unsigned mask) {
      if (tile >= 0) {
#pragma unroll
        for (int i = 0; i < TS * CH / 32; ++i) {
          const int c = lane + 32 * i, r = c / CH, d = (c - r * CH) * 8;
          const bool in = (mask >> r) & 1u;
          const size_t at = (size_t)(c0 + tile * TS + (in ? r : 0)) * row + d;
          cp_async16(stage + r * ROW + d * 2, kb + at, in);
          cp_async16(stage + TILE + r * ROW + d * 2, vb + at, in);
        }
      }
      cp_async_commit();
    };
    int tl[NS];
    unsigned mk[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tl[s] = next(mk[s]);
      issue(ring + s * STAGE, tl[s], mk[s]);
    }
    bool more = tl[0] >= 0;
    while (more) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (tl[s] < 0) {                // warp-uniform; the rest are too
          more = false;
          break;
        }
        cp_async_wait<NS - 1>();        // this stage's group has landed
        __syncwarp();
        grouped_tile<HD>(ring + s * STAGE + k_lane, ring + s * STAGE + v_lane,
                         qa, o, m, l, mk[s], tg, scale_log2);
        __syncwarp();                   // the stage is read
        tl[s] = next(mk[s]);
        issue(ring + s * STAGE, tl[s], mk[s]);
      }
    }
    cp_async_wait<0>();
    __syncwarp();
  }

  // the warp's partial into its own ring: [G_MAX][LW] fp32, hi + lo rows
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  float* wacc = reinterpret_cast<float*>(gsm) + warp * (NS * STAGE / 4);
#pragma unroll
  for (int j = 0; j < DN; ++j)
    *reinterpret_cast<float2*>(wacc + g * LW + 8 * j + 2 * tg) =
        make_float2(o[j][0] + o[j][2], o[j][1] + o[j][3]);
  if (tg == 0) {
    wm[warp][g] = m;
    wl[warp][g] = l;
  }
  __syncthreads();

  // the block's partial: each head's warp factors once, then the sums in
  // warp order.  Block j of the cluster merges elements [j SL, (j + 1) SL)
  // of the G x HD output, so each block stores slice j of its partial into
  // block j's shared memory, with its maxima and denominators
  if (threadIdx.x < G) {
    const int h = threadIdx.x;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < GWARPS; ++w) M = fmaxf(M, wm[w][h]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < GWARPS; ++w) {
      const float c = exp2f(wm[w][h] - M);
      wf[w][h] = c;
      L += wl[w][h] * c;
    }
    bm[h] = M;
    bl[h] = L;
  }
  __syncthreads();
  cluster_wait();                       // the whole cluster is running
  const int SL = (G * HD + C - 1) / C;
  // [C][SL] slices of the blocks' partials, then [C][G] maxima and [C][G]
  // denominators
  float* mine = reinterpret_cast<float*>(gsm) + GWARPS * (NS * STAGE / 4);
  for (int j = 0; j < C; ++j) {
    float* peer = cluster.map_shared_rank(mine, j);
    const int e1 = min(G * HD, (j + 1) * SL);
    for (int i = j * SL + threadIdx.x; i < e1; i += GTHREADS) {
      const int h = i / HD, d = i - h * HD;
      const float* src = reinterpret_cast<const float*>(gsm) + h * LW + d;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < GWARPS; ++w)
        A += src[w * (NS * STAGE / 4)] * wf[w][h];
      peer[rank * SL + i - j * SL] = A;
    }
    if (threadIdx.x < G) {
      peer[C * SL + rank * G + threadIdx.x] = bm[threadIdx.x];
      peer[C * SL + (C + rank) * G + threadIdx.x] = bl[threadIdx.x];
    }
  }
  cluster_arrive();                     // every block holds its slices
  cluster_wait();

  // each (block, head)'s factor once, then this block's slice summed in
  // rank order
  const float* pmax = mine + C * SL;
  const float* pden = pmax + C * G;
  if (threadIdx.x < G) {
    const int h = threadIdx.x;
    float M = NEG_INF;
    for (int r = 0; r < C; ++r) M = fmaxf(M, pmax[r * G + h]);
    float L = 0.f;
    for (int r = 0; r < C; ++r) {
      const float c = exp2f(pmax[r * G + h] - M);
      rf[r][h] = c;
      L += pden[r * G + h] * c;
    }
    rl[h] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int e1 = min(G * HD, (rank + 1) * SL);
  for (int i = rank * SL + threadIdx.x; i < e1; i += GTHREADS) {
    const int h = i / HD;
    float A = 0.f;
    for (int r = 0; r < C; ++r) A += mine[r * SL + i - rank * SL] * rf[r][h];
    out[((size_t)b * H + kh * G) * HD + i] = __float2bfloat16_rn(A / rl[h]);
  }
}

template <int HD>
cudaError_t launch_grouped(const void* q, const void* k, const void* v,
                           const int* slot_pos, void* out, int B, int H,
                           int K, int W, int pos, const int* pos_at,
                           int window, float scale, int cluster,
                           cudaStream_t stream) {
  constexpr size_t ring = (size_t)GWARPS * NS * 2 * TS * (HD + 8) * 2;
  // once per instance: room for the largest cluster's slices
  static const cudaError_t smem_attr = cudaFuncSetAttribute(
      decode_kernel_grouped<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(ring + (G_MAX * HD + CLUSTER_MAX * (1 + 2 * G_MAX)) *
                       sizeof(float)));
  if (smem_attr != cudaSuccess) return smem_attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, K, B);
  cfg.blockDim = dim3(GTHREADS);
  const int G = H / K, slice = (G * HD + cluster - 1) / cluster;
  cfg.dynamicSmemBytes =
      ring + (size_t)cluster * (slice + 2 * G) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_kernel_grouped<HD>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), slot_pos,
      static_cast<__nv_bfloat16*>(out), H, K, W, pos, pos_at, window,
      scale * 1.4426950408889634f);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const int* slot_pos, void* out, int B, int H, int K,
                     int W, int hd, int pos, const int* pos_at, int window,
                     float scale, int cluster, cudaStream_t s) {
#define DECODE_G(n)                                                        \
  case n:                                                                  \
    return launch<T, n>(q, k, v, slot_pos, out, B, H, K, W, hd, pos,       \
                        pos_at, window, scale, cluster, s);
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
// the slots of each (b, kv head), 1 to 8.  `pos_at`: null, or one int32 in
// device memory that takes the place of `pos`.  Launches on `stream`;
// returns the launch's error code (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* slot_pos, void* out, int B, int H,
                                int K, int W, int hd, int pos,
                                const int* pos_at, int window, float scale,
                                int cluster, int dtype, void* stream) {
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
                                pos, pos_at, window, scale, cluster, s);
  if (dtype == 1)
    return (int)launch_g<__nv_bfloat16>(G, q, k, v, slot_pos, out, B, H, K,
                                        W, hd, pos, pos_at, window, scale,
                                        cluster, s);
  return (int)cudaErrorInvalidValue;
}

// The grouped route: bf16 (q, the cache and out), hd a multiple of 16 up
// to 128, H / K at most 8, `cluster` as above.  The same arguments as
// decode_attention (dtype must be 1); returns the launch's error code.
extern "C" int decode_attention_grouped(const void* q, const void* k,
                                        const void* v, const int* slot_pos,
                                        void* out, int B, int H, int K, int W,
                                        int hd, int pos, const int* pos_at,
                                        int window, float scale, int cluster,
                                        int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dtype != 1 || K <= 0 || H % K != 0 || H / K > G_MAX || W <= 0 ||
      hd <= 0 || hd > HD_MAX || hd % 16 != 0 || window < 0 || B > 65535 ||
      K > 65535 || cluster < 1 || cluster > CLUSTER_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DECODE_HD(n)                                                       \
  case n:                                                                  \
    return (int)launch_grouped<n>(q, k, v, slot_pos, out, B, H, K, W, pos, \
                                  pos_at, window, scale, cluster, s);
  switch (hd) {
    DECODE_HD(16) DECODE_HD(32) DECODE_HD(48) DECODE_HD(64)
    DECODE_HD(80) DECODE_HD(96) DECODE_HD(112) DECODE_HD(128)
  }
#undef DECODE_HD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
