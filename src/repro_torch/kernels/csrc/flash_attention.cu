// Flash attention (causal, sliding-window or full) on Hopper (sm_90a):
//
//     out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, kh] * scale + mask)
//                    * v[b, j, kh],        kh = h / (H / K)  (GQA)
//
// q (B, S, H, hd), k/v (B, S, K, hd) in the model's layout, fp32 or bf16;
// out (B, S, H, hd) in q's type.  mask: j <= i when causal, i - j < window
// when window > 0, j < S always.
//
// Replaces: repro/kernels/flash_attention.py::_attn_kernel (pallas_call in
// flash_attention), reached through models/attention.attention when
// cfg.use_flash_kernel is set; the port also routes the cache prefill
// (models/transformer.block_fwd_cache) here, which computes the same
// function with _sdpa and causal_mask.
//
// Both routes share the reference's online softmax: a block owns one (b, h)
// and a tile of BQ = 64 query rows and walks the kv tiles of BK = 64 keys
// that its mask reaches; the running max m, the denominator l and the
// output accumulator stay in registers in fp32, as the reference keeps them
// in VMEM scratch.  Tiles wholly before the window or after the causal
// diagonal are skipped (they add exact zeros); inside a tile a masked score
// is -1e30 and its probability is forced to 0 after the exponential, so a
// row whose whole tile is masked adds nothing even while its max is still
// -1e30.  out = acc / max(l, 1e-30), as the reference.  The kv head of q
// head h is read in place: no transpose and no GQA copy.  No atomics: the
// result does not depend on scheduling.  No fast-math.
//
// What bounds it on the H100: 4*B*H*S*S*hd operations (half of them under a
// causal mask) against 989 TFLOP/s of bf16 tensor cores or 67 TFLOP/s of
// fp32; at S >= 128 the operations dominate the bytes of q, k, v and out.
//
// fp32 route (flash_kernel, any hd <= 128): IEEE fp32 FMAs on the
// CUDA cores, no TF32, so it holds the reference's fp32 bound.  256
// threads: tx = tid % 16, ty = tid / 16; a thread owns query rows
// ty + 16*i (i < 4); for scores the key columns tx + 16*j (j < 4), for the
// output the head dims tx + 16*j (j < 8).  The 16 threads of a row form a
// half-warp, whose max and sum are butterfly shuffles.  The kv tiles pass
// through shared memory as fp32, expf on the natural-log scale.
//
// bf16 route (flash_kernel_mma<HD>, hd a multiple of 16 up to 128): the
// FlashAttention-2 design on warp-level tensor cores, which is as far as
// mma.sync goes: it reaches only part of the 989 TFLOP/s that wgmma with
// TMA and warp specialisation can.  4 warps (128 threads) a block, 16 query
// rows a warp.
//   - Copies: Q once, then K and V through a two-stage ring, all as 16-byte
//     cp.async.cg with commit_group / wait_group; tile j+1's copies are in
//     flight while tile j's math runs.  Rows past S are zero-filled by
//     cp.async's src-size operand (so 0 * p stays 0) and masked.  Shared
//     rows are padded to hd + 8 bf16: the eight 16-byte rows that one
//     ldmatrix phase reads land in eight distinct bank quads: a block holds
//     5 * 64 * (hd + 8) bf16 (87,040 bytes at hd 128, two blocks an SM).
//   - S = Q.K^T on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: Q's
//     A fragments come from ldmatrix.x4 once and stay in registers across
//     the kv tiles; K's B fragments from ldmatrix (K is (keys, hd) row-major,
//     the "col" operand).  Products of bf16 are exact in fp32, so this step
//     differs from the reference in summation order only.
//   - Softmax in registers: the scale is folded into log2(e) and the
//     exponentials are exp2f.  A thread holds parts of two rows; a row's
//     max is two __shfl_xor_sync within the quad, its sum stays a
//     per-thread partial (rescaled like the accumulator) and is reduced
//     once at the end.  The mask is evaluated only on tiles that cross the
//     diagonal, the window's edge or S.
//   - O += P.V: P is rounded to bf16 (round to nearest even) and used in
//     place as the A fragment of the second mma.sync (the m16n8 accumulator
//     layout pairs into the m16n8k16 A layout), so P never goes through
//     shared memory; V's B fragments come from ldmatrix.trans.  Rounding P
//     to bf16 is the one rounding the reference (fp32 P) does not have; it
//     stays inside the reference's bf16 bound.
//   - Under a causal mask the q tiles of a (b, h) launch heaviest first
//     (blockIdx.x reversed), so the long diagonal rows do not form the tail.
// What holds it below the bound: a warp's softmax (exponentials, shuffles,
// the rescale of O) does not overlap its own products, and 8 warps an SM
// (hd 128: 2 blocks by registers and shared memory) do not hide that, so
// the tensor cores are only partly busy; wgmma with warp specialisation is
// the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // key rows per kv tile
constexpr int HD_MAX = 128;
constexpr int THREADS = 256;
constexpr int RPT = BQ / 16;            // query rows per thread
constexpr int CPT = BK / 16;            // score columns per thread
constexpr int DPT = HD_MAX / 16;        // output dims per thread
constexpr int LDP = BK + 16;            // P tile row: two half-warps, two banks
constexpr float NEG_INF = -1e30f;

// shared floats of one block: Q [BQ][hd+16], K [BK][hd+1], V [BK][hd],
// P [BQ][LDP]
__host__ __device__ inline size_t smem_floats(int hd) {
  return (size_t)BQ * (hd + 16) + (size_t)BK * (hd + 1) + (size_t)BK * hd +
         (size_t)BQ * LDP;
}

__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int H, int K, int hd, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  const int ldq = hd + 16, ldk = hd + 1;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * ldq;
  float* Vs = Ks + BK * ldk;
  float* Ps = Vs + BK * hd;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = (size_t)H * hd, ks = (size_t)K * hd;   // per position
  const float* qb = q + ((size_t)b * S * H + h) * hd;
  const float* kb = k + ((size_t)b * S * K + kh) * hd;
  const float* vb = v + ((size_t)b * S * K + kh) * hd;

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    Qs[r * ldq + d] = q0 + r < S ? qb[(size_t)(q0 + r) * qs + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // kv tiles the mask reaches: none after the diagonal of the tile's last
  // row, none wholly before the window of its first row
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();            // the previous tile's K, V and P are read
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int r = e / hd, d = e - r * hd;
      const bool in = k0 + r < S;
      Ks[r * ldk + d] = in ? kb[(size_t)(k0 + r) * ks + d] : 0.f;
      Vs[r * hd + d] = in ? vb[(size_t)(k0 + r) * ks + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      bool ok[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < S && (!causal || col <= row) &&
                (window <= 0 || row - col < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        // masked again after the exponential: exp(-1e30 - -1e30) = 1
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * LDP + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = Vs[c * hd + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  float* ob = out + ((size_t)b * S * H + h) * hd;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[(size_t)row * qs + d] = acc[i][j] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;        // 4 warps of 16 query rows
constexpr float LOG2E = 1.4426950408889634f;

// one block's shared memory, bf16: Q [BQ][hd+8], then K and V, two stages
// each of [BK][hd+8]
__host__ __device__ constexpr size_t mma_smem_bytes(int hd) {
  return (size_t)(BQ + 4 * BK) * (hd + 8) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared (a shared-space address); zero-filled (nothing
// read) when !in
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

// two fp32 -> one bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One kv tile's online-softmax step on a warp's score fragments, in place:
// s[j][e] (raw q.k) becomes p = exp2(s * scale_log2 - m), with m the new
// running max of its row (log2 scale), and alpha the factor that rescales
// the row's accumulators (and this thread's part l of its denominator).
// s[j][e] sits at row row0 + 8 * (e >> 1), key col0 + 8 * j + (e & 1).
// MASK: the tile crosses the diagonal, the window's edge or S, so each
// score is masked to -1e30 and its p forced to 0 after the exponential
// (exp2(-1e30 - -1e30) = 1); other tiles skip the mask entirely.
template <bool MASK, int NT>
__device__ __forceinline__ void online_softmax(
    float (&s)[NT][4], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale_log2, int row0, int col0, int S, int causal, int window) {
  uint32_t keep = 0xffffffffu;          // bit 4*j + e: s[j][e] unmasked
  float mx[2] = {NEG_INF, NEG_INF};     // of the raw scores
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int row = row0 + (e >> 1) * 8, col = col0 + j * 8 + (e & 1);
        if (!(col < S && (!causal || col <= row) &&
              (window <= 0 || row - col < window))) {
          s[j][e] = NEG_INF;
          keep &= ~(1u << (4 * j + e));
        }
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);   // scale > 0
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(s[j][e], scale_log2, -m[e >> 1]));
      if (MASK && !((keep >> (4 * j + e)) & 1u)) p = 0.f;
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
}

// min blocks 1: ptxas keeps the registers the kernel needs (<= 255) rather
// than capping them for occupancy and spilling; shared memory sets the
// blocks an SM at hd 128 anyway
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int S, int H, int K,
                 int causal, int window, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= HD_MAX, "hd: a multiple of 16");
  constexpr int LD = HD + 8;            // shared row stride, bf16
  constexpr int CH = HD / 8;            // 16-byte chunks per row
  constexpr int KS = HD / 16;           // k-steps of Q.K^T
  constexpr int DN = HD / 8;            // n-tiles of O
  constexpr int NT = BK / 8;            // n-tiles of S
  constexpr uint32_t ROW = LD * 2;      // bytes
  constexpr uint32_t STAGE = BK * ROW;
  extern __shared__ float4 smem4[];
  // shared-space byte addresses: Q [BQ][LD], K [2][BK][LD], V [2][BK][LD]
  const uint32_t Qs = smem_addr(smem4), Ks = Qs + BQ * ROW;
  const uint32_t Vs = Ks + 2 * STAGE;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;         // mma group, thread in it
  const size_t qs = (size_t)H * HD;     // per position
  const int ks = K * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * S * K + kh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * S * K + kh) * HD;

  for (int c = tid; c < BQ * CH; c += MMA_THREADS) {
    const int r = c / CH, d = (c - r * CH) * 8;
    const bool in = q0 + r < S;
    cp_async16(Qs + r * ROW + d * 2, qb + (size_t)(in ? q0 + r : 0) * qs + d,
               in);
  }
  cp_async_commit();

  // kv tiles the mask reaches: none after the diagonal of the tile's last
  // row, none wholly before the window of its first row
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const int k0 = kv_begin + t * BK;
    const uint32_t stage = (t & 1) * STAGE;
    for (int c = tid; c < BK * CH; c += MMA_THREADS) {
      const int r = c / CH, d = (c - r * CH) * 8;
      const bool in = k0 + r < S;
      // 32-bit offsets (S * K * hd < 2^31, checked at launch) spare
      // registers
      const int off = (in ? k0 + r : 0) * ks + d;
      cp_async16(Ks + stage + r * ROW + d * 2, kb + off, in);
      cp_async16(Vs + stage + r * ROW + d * 2, vb + off, in);
    }
    cp_async_commit();
  };
  load_kv(0);

  uint32_t qf[KS][4];                   // Q's A fragments, from tile 0 on
  // this lane's ldmatrix rows: K (keys + 0..7 | 8..15, dims + 0 | 8) and V
  // transposed (keys + 0..7 | 8..15, dims + 0 | 8)
  const uint32_t k_lane = Ks + ((lane & 7) + ((lane >> 4) << 3)) * ROW +
                          ((lane >> 3) & 1) * 16;
  const uint32_t v_lane = Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                          (lane >> 4) * 16;

  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (log2 scale) and this
  // thread's part of the denominator
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);                   // its stage was freed by the last
      cp_async_wait<1>();               // barrier; tile t (and Q) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * ROW +
                            (kk * 16 + (lane >> 4) * 8) * 2);
    }
    const uint32_t Kt = k_lane + (t & 1) * STAGE;
    const uint32_t Vt = v_lane + (t & 1) * STAGE;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        // keys jp*16 + 0..7 (b0, b1) and + 8..15 (b2, b3), dims kk*16 + 0..15
        uint32_t kf[4];
        ldsm_x4(kf, Kt + jp * 16 * ROW + kk * 32);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const int k0 = kv_begin + t * BK;
    float alpha[2];
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
        (window > 0 && q0 + BQ - 1 - k0 >= window))
      online_softmax<true>(s, m, l, alpha, scale_log2, row0, k0 + tg * 2, S,
                           causal, window);
    else
      online_softmax<false>(s, m, l, alpha, scale_log2, row0, k0 + tg * 2, S,
                            causal, window);
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // P's A fragment for keys kk*16 + 0..15, straight from the
      // accumulators of n-tiles 2kk and 2kk + 1
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        // keys kk*16 + 0..7 / 8..15 by dims dp*16 + 0..7 (b0, b1) and
        // dp*16 + 8..15 (b2, b3), transposed
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vt + kk * 16 * ROW + dp * 32);
        mma_bf16(o[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();                    // tile t's stage is read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * qs + j * 8 +
                                         tg * 2) =
          __floats2bfloat162_rn(o[j][2 * i] / denom, o[j][2 * i + 1] / denom);
  }
}

// raise a kernel's dynamic shared-memory limit once per device and size,
// outside any launch, so the launch itself can be captured in a CUDA graph
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, size_t smem, size_t (&granted)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) granted[dev] = smem;
  }
  return cudaSuccess;
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int K, int hd, int causal, int window,
               float scale, cudaStream_t stream) {
  static size_t granted[64] = {};
  const size_t smem = smem_floats(hd) * sizeof(float);
  const cudaError_t e = grant_smem(flash_kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, K, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int K, int causal, int window, float scale,
               cudaStream_t stream) {
  static size_t granted[64] = {};
  constexpr size_t smem = mma_smem_bytes(HD);
  const cudaError_t e = grant_smem(flash_kernel_mma<HD>, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel_mma<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, H, K, causal, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int K, int hd, int causal, int window,
                float scale, cudaStream_t stream) {
#define FLASH_MMA_CASE(D)                                                   \
  case D:                                                                   \
    return launch_mma<D>(q, k, v, out, B, S, H, K, causal, window, scale,   \
                         stream);
  switch (hd) {
    FLASH_MMA_CASE(16)
    FLASH_MMA_CASE(32)
    FLASH_MMA_CASE(48)
    FLASH_MMA_CASE(64)
    FLASH_MMA_CASE(80)
    FLASH_MMA_CASE(96)
    FLASH_MMA_CASE(112)
    FLASH_MMA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_MMA_CASE
}

}  // namespace

extern "C" int flash_attention_max_hd() { return HD_MAX; }

// dtype 0 = fp32 (any hd <= 128), 1 = bf16 (hd a multiple of 16 up to 128);
// q, k, v and out alike, 16-byte aligned for bf16.  Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int K, int hd,
                               int causal, int window, float scale,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || K <= 0 || H % K != 0 || hd <= 0 || hd > HD_MAX ||
      window < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, S, H, K, hd, causal, window, scale,
                      s);
  if (dtype == 1 && (long long)S * K * hd >= (1LL << 31))
    return (int)cudaErrorInvalidValue;  // the kv copies' 32-bit offsets
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, S, H, K, hd, causal, window, scale,
                       s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
