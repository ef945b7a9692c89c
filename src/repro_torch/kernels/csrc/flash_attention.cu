// Flash attention (causal, sliding-window or full) on Hopper (sm_90a):
//
//     out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, kh] * scale + mask)
//                    * v[b, j, kh],        kh = h / (H / K)  (GQA)
//
// q (B, S, H, hd), k/v (B, T, K, hd) in the model's layout, fp32 or bf16;
// out (B, S, H, hd) in q's type.  mask: j <= i when causal, i - j < window
// when window > 0, j < T always.  T is the key length: T = S for
// self-attention, and a length of its own (T != S) for the VLM's
// cross-attention from S text positions to T image tokens, which takes
// neither a causal mask nor a window (the C API refuses them at T != S).
//
// Replaces: repro/kernels/flash_attention.py::_attn_kernel (pallas_call in
// flash_attention), reached through models/attention.attention when
// cfg.use_flash_kernel is set; the port also routes the cache prefill
// (models/transformer.block_fwd_cache) here, which computes the same
// function with _sdpa and causal_mask, and the VLM's cross-attention
// (models/attention.cross_attention), which the reference computes with
// _sdpa and a zero bias.
//
// Both routes share the reference's online softmax: a 64-row query tile of
// one (b, h) walks the kv tiles of BK = 64 keys (of T) that its mask
// reaches; the running max m, the denominator l and the output accumulator
// stay in registers in fp32, as the reference keeps them in VMEM scratch.
// Tiles wholly before the window or after the causal diagonal are skipped
// (they add exact zeros); inside a tile a masked score is -1e30 and its
// probability is forced to 0 after the exponential, so a row whose whole
// tile is masked adds nothing even while its max is still -1e30.  out =
// acc / max(l, 1e-30), as the reference.  The kv head of q head h is read
// in place: no transpose and no GQA copy.  No atomics: the result does not
// depend on scheduling.  No fast-math.
//
// What bounds it on the H100: 4*B*H*S*T*hd operations (half of them under a
// causal mask) against 989 TFLOP/s of bf16 tensor cores or 67 TFLOP/s of
// fp32; at S, T >= 128 the operations dominate the bytes of q, k, v and out.
//
// fp32 route (flash_kernel, any hd <= 128): IEEE fp32 FMAs on the
// CUDA cores, no TF32, so it holds the reference's fp32 bound.  256
// threads: tx = tid % 16, ty = tid / 16; a thread owns query rows
// ty + 16*i (i < 4); for scores the key columns tx + 16*j (j < 4), for the
// output the head dims tx + 16*j (j < 8).  The 16 threads of a row form a
// half-warp, whose max and sum are butterfly shuffles.  The kv tiles pass
// through shared memory as fp32, expf on the natural-log scale.
//
// bf16 route (flash_kernel_wgmma<HD>, hd a multiple of 16 up to 128): Hopper's
// warpgroup tensor cores fed by TMA, one block of three warpgroups a
// 128-row q tile of one (b, h).
//   - Warp specialisation: warpgroup 0 gives its registers away
//     (setmaxnreg.dec) and one of its threads issues every copy; warpgroups 1
//     and 2 (setmaxnreg.inc) each own 64 rows and do the arithmetic.
//   - Copies: cp.async.bulk.tensor (TMA) through 4-D tensor maps over the
//     model's layout (hd, heads, rows, B), encoded on the host at each launch
//     (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint: no
//     -lcuda).  Q once, in two 64-row halves (consumer 1's first: under a
//     causal mask its walk is the longer); K and V of each tile into two
//     rings of NSTAGE stages, each stage with a full and an empty mbarrier
//     (phase parity per round).
//     A row of hd is cut into boxes of 64, 32 and 16 columns (Chunks), each
//     in the widest swizzle its rows fill (128, 64, 32 bytes): hd 80 is a
//     128-byte box and a 32-byte one.  Rows past S or T land as zeros (the
//     TMA unit's out-of-bounds fill), so 0 * p stays 0, and are masked.
//   - S = Q.K^T on wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulation):
//     Q's A fragments come from ldmatrix once and stay in registers (so only
//     K is read from shared memory, through a K-major descriptor), one
//     wgmma a 16-column step of hd, in order, from zero.
//   - Softmax in registers (online_softmax<MASK>): wgmma's accumulator
//     layout a warp is mma.sync m16n8's repeated, so the code written for
//     that layout runs on it unchanged.  The scale is folded
//     into log2(e), the exponentials are exp2f; a row's max is two
//     __shfl_xor_sync within the quad, its sum a per-thread partial reduced
//     once at the end; the mask runs only on tiles that cross the diagonal,
//     the window's edge or T.
//   - O += P.V: P is rounded to bf16 (round to nearest even) and used in
//     place as the register A operand of wgmma m64n{hd}k16, V as the
//     transposed (MN-major) B operand, which 16-bit types allow; one wgmma a
//     16-key step in order over the 64-column boxes (n128 or n64), then one
//     a 32- and a 16-column box.  Rounding P to bf16 is the one rounding the
//     reference (fp32 P) does not have; it stays inside the reference's bf16
//     bound.
//   - Overlap: a consumer issues tile t's S and tile t-1's P.V together, then
//     runs t's softmax while the P.V and the other consumer's products run
//     (FlashAttention-3's intra-warpgroup overlap); named barriers give the
//     two consumers turns at the tensor cores (its ping-pong), consumer 1
//     first.  O is rescaled once P.V(t-1) is done: each row's O is
//     alpha_t * O + P_t V_t, tile by tile.
//   - Bits: the output equals, bit for bit, that of this route's earlier
//     design on mma.sync m16n8k16 (64-row blocks; tests/test_torch_gpu.py
//     holds the two equal): each 64-row consumer walks the same tiles in
//     the same order, with the same softmax and P, and wgmma sums a 16-wide
//     k step as mma.sync does (tools/flash_k16_check.py).
//   - Grid: one dimension, q tiles outermost (under a causal mask heaviest
//     first), so every head's long walks start in the first wave.
// What holds it below the bound (tools/kernel_variants.py flash, PERF.md
// section 6): the softmax's issue (exp2f's range fix-up, the row maxima and
// sums: ~7 instructions a score) is not hidden behind the products, whose
// 64-key tiles (the bits need BK = 64) give it little to hide behind; and
// the copies with their ring rounds alone take 59-82% of the time at the
// zoo's shapes, the bare copies 43-60%.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

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
             int T, int H, int K, int hd, int causal, int window,
             float scale) {
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
  const float* kb = k + ((size_t)b * T * K + kh) * hd;
  const float* vb = v + ((size_t)b * T * K + kh) * hd;

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
  const int kv_end = causal ? min(T, q0 + BQ) : T;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();            // the previous tile's K, V and P are read
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int r = e / hd, d = e - r * hd;
      const bool in = k0 + r < T;
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
        ok[j] = col < T && (!causal || col <= row) &&
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
// bf16 on Hopper's warpgroup tensor cores
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;         // a warpgroup: 4 warps of 16 rows
constexpr int WS_THREADS = 3 * WG_THREADS;   // a producer, two consumers
constexpr int BQ2 = 2 * BQ;             // query rows a block: BQ a consumer
constexpr int NSTAGE = 3;               // the K/V ring
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // setmaxnreg
constexpr float LOG2E = 1.4426950408889634f;
// a failed tensor-map encode returns ENCODE_ERROR + its CUresult
constexpr int ENCODE_ERROR = 1 << 16;

// A row of hd bf16 is cut into TMA boxes ("chunks") of 64, 32 and 16
// columns, each in the widest swizzle its rows fill: chunk class c is
// 64 >> c columns, rows of 128 >> c bytes, swizzle atoms of 8 rows (1024 >>
// c bytes).  Columns [0, 64 * (hd / 64)) are class-0 chunks, then a class-1
// chunk where hd % 64 >= 32 and a class-2 chunk where hd % 32 == 16.  A
// tile of R rows keeps the chunk that starts at column c0 at byte c0 * R * 2,
// its rows one after another, as TMA writes them.
template <int HD>
struct Chunks {
  static constexpr int n64 = HD / 64;                     // class-0 chunks
  static constexpr int c32 = HD % 64 >= 32 ? 64 * n64 : -1;   // class 1
  static constexpr int c16 = HD % 32 == 16 ? HD - 16 : -1;    // class 2
  // the class of the chunk that holds column col, and its first column
  __host__ __device__ static constexpr int cls(int col) {
    return col < 64 * n64 ? 0 : (c16 >= 0 && col >= c16 ? 2 : 1);
  }
  __host__ __device__ static constexpr int start(int col) {
    return cls(col) == 0 ? col / 64 * 64 : (cls(col) == 2 ? c16 : c32);
  }
};

// one block's shared memory: Q [BQ2 rows], K and V [NSTAGE][BK rows], by
// chunks; then the barriers (K's and V's full and empty a stage, each Q
// half's); 1024 bytes of slack to align the tiles to the 128-byte swizzle's
// 1024-byte atom
__host__ __device__ constexpr size_t ws_smem_bytes(int hd) {
  return (size_t)(BQ2 + 2 * NSTAGE * BK) * hd * 2 + 8 * (4 * NSTAGE + 2) +
         1024;
}

struct FlashMaps {                      // by chunk class
  CUtensorMap q[3], k[3], v[3];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA writes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of `map` at (col, head, row, batch) into shared memory at dst;
// its bytes complete a transaction of `bar`; rows out of bounds land as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(&map))
               : "memory");
}

// named barriers 1 and 2 order the two consumers' turns at the tensor cores
__device__ __forceinline__ void turn_wait(int consumer) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + consumer),
               "n"(2 * WG_THREADS)
               : "memory");
}

__device__ __forceinline__ void turn_pass(int consumer) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - consumer),
               "n"(2 * WG_THREADS)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the compiler may neither move a register's reads and writes across this
// point nor give the register away while a wgmma still reads or writes it
template <int N, int M>
__device__ __forceinline__ void pin(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, and the swizzle of chunk class cls (128, 64, 32 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int cls) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)(cls + 1) << 62;
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
// MASK: the tile crosses the diagonal, the window's edge or T, so each
// score is masked to -1e30 and its p forced to 0 after the exponential
// (exp2(-1e30 - -1e30) = 1); other tiles skip the mask entirely.
template <bool MASK, int NT>
__device__ __forceinline__ void online_softmax(
    float (&s)[NT][4], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale_log2, int row0, int col0, int T, int causal, int window) {
  uint32_t keep = 0xffffffffu;          // bit 4*j + e: s[j][e] unmasked
  float mx[2] = {NEG_INF, NEG_INF};     // of the raw scores
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int row = row0 + (e >> 1) * 8, col = col0 + j * 8 + (e & 1);
        if (!(col < T && (!causal || col <= row) &&
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

// d[J .. J + 15] (64 x 128, fp32) += A (64 x 16, bf16 fragments in
// registers: mma.sync m16n8k16's A layout a warp) * B (16 x 128, at
// descriptor b: K-major for TB 0, MN-major for TB 1)
template <int TB, int J, int DN>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[DN][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]),
        "+f"(d[J + 0][2]), "+f"(d[J + 0][3]),
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]),
        "+f"(d[J + 1][2]), "+f"(d[J + 1][3]),
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]),
        "+f"(d[J + 2][2]), "+f"(d[J + 2][3]),
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]),
        "+f"(d[J + 3][2]), "+f"(d[J + 3][3]),
        "+f"(d[J + 4][0]), "+f"(d[J + 4][1]),
        "+f"(d[J + 4][2]), "+f"(d[J + 4][3]),
        "+f"(d[J + 5][0]), "+f"(d[J + 5][1]),
        "+f"(d[J + 5][2]), "+f"(d[J + 5][3]),
        "+f"(d[J + 6][0]), "+f"(d[J + 6][1]),
        "+f"(d[J + 6][2]), "+f"(d[J + 6][3]),
        "+f"(d[J + 7][0]), "+f"(d[J + 7][1]),
        "+f"(d[J + 7][2]), "+f"(d[J + 7][3]),
        "+f"(d[J + 8][0]), "+f"(d[J + 8][1]),
        "+f"(d[J + 8][2]), "+f"(d[J + 8][3]),
        "+f"(d[J + 9][0]), "+f"(d[J + 9][1]),
        "+f"(d[J + 9][2]), "+f"(d[J + 9][3]),
        "+f"(d[J + 10][0]), "+f"(d[J + 10][1]),
        "+f"(d[J + 10][2]), "+f"(d[J + 10][3]),
        "+f"(d[J + 11][0]), "+f"(d[J + 11][1]),
        "+f"(d[J + 11][2]), "+f"(d[J + 11][3]),
        "+f"(d[J + 12][0]), "+f"(d[J + 12][1]),
        "+f"(d[J + 12][2]), "+f"(d[J + 12][3]),
        "+f"(d[J + 13][0]), "+f"(d[J + 13][1]),
        "+f"(d[J + 13][2]), "+f"(d[J + 13][3]),
        "+f"(d[J + 14][0]), "+f"(d[J + 14][1]),
        "+f"(d[J + 14][2]), "+f"(d[J + 14][3]),
        "+f"(d[J + 15][0]), "+f"(d[J + 15][1]),
        "+f"(d[J + 15][2]), "+f"(d[J + 15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
}

// d[J .. J + 7] (64 x 64, fp32) += A (64 x 16, bf16 fragments in
// registers: mma.sync m16n8k16's A layout a warp) * B (16 x 64, at
// descriptor b: K-major for TB 0, MN-major for TB 1)
template <int TB, int J, int DN>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[DN][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]),
        "+f"(d[J + 0][2]), "+f"(d[J + 0][3]),
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]),
        "+f"(d[J + 1][2]), "+f"(d[J + 1][3]),
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]),
        "+f"(d[J + 2][2]), "+f"(d[J + 2][3]),
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]),
        "+f"(d[J + 3][2]), "+f"(d[J + 3][3]),
        "+f"(d[J + 4][0]), "+f"(d[J + 4][1]),
        "+f"(d[J + 4][2]), "+f"(d[J + 4][3]),
        "+f"(d[J + 5][0]), "+f"(d[J + 5][1]),
        "+f"(d[J + 5][2]), "+f"(d[J + 5][3]),
        "+f"(d[J + 6][0]), "+f"(d[J + 6][1]),
        "+f"(d[J + 6][2]), "+f"(d[J + 6][3]),
        "+f"(d[J + 7][0]), "+f"(d[J + 7][1]),
        "+f"(d[J + 7][2]), "+f"(d[J + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
}

// d[J .. J + 3] (64 x 32, fp32) += A (64 x 16, bf16 fragments in
// registers: mma.sync m16n8k16's A layout a warp) * B (16 x 32, at
// descriptor b: K-major for TB 0, MN-major for TB 1)
template <int TB, int J, int DN>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[DN][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]),
        "+f"(d[J + 0][2]), "+f"(d[J + 0][3]),
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]),
        "+f"(d[J + 1][2]), "+f"(d[J + 1][3]),
        "+f"(d[J + 2][0]), "+f"(d[J + 2][1]),
        "+f"(d[J + 2][2]), "+f"(d[J + 2][3]),
        "+f"(d[J + 3][0]), "+f"(d[J + 3][1]),
        "+f"(d[J + 3][2]), "+f"(d[J + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
}

// d[J .. J + 1] (64 x 16, fp32) += A (64 x 16, bf16 fragments in
// registers: mma.sync m16n8k16's A layout a warp) * B (16 x 16, at
// descriptor b: K-major for TB 0, MN-major for TB 1)
template <int TB, int J, int DN>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[DN][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[J + 0][0]), "+f"(d[J + 0][1]),
        "+f"(d[J + 0][2]), "+f"(d[J + 0][3]),
        "+f"(d[J + 1][0]), "+f"(d[J + 1][1]),
        "+f"(d[J + 1][2]), "+f"(d[J + 1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
}


// four 8 x 8 bf16 matrices from shared memory, a row address a lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// this consumer's 64 rows of Q (at q, a BQ2-row tile) as the A fragments of
// each 16-column step of hd, read through the chunks' swizzle
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 16][4], uint32_t q,
                                       int consumer, int warp, int lane) {
  using C = Chunks<HD>;
  const int r = consumer * BQ + warp * 16 + (lane & 15);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int col = 16 * ks, cls = C::cls(col), c0 = C::start(col);
    const int u = (col - c0) / 8 + (lane >> 4);      // 16-byte unit of the row
    const int sw = cls == 0 ? (r & 7) : cls == 1 ? (r >> 1) & 3 : (r >> 2) & 1;
    ldsm_x4(qf[ks], q + c0 * BQ2 * 2 + r * (128 >> cls) + ((u ^ sw) << 4));
  }
}

// S (64 x 64) = this consumer's 64 rows of Q (qf, from load_q) times the K
// tile (at k, K-major) transposed: one m64n64k16 a 16-column step of hd, in
// order.  s must be zero and pinned.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 8][4],
                                         const uint32_t (&qf)[HD / 16][4],
                                         uint32_t k) {
  using C = Chunks<HD>;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int col = 16 * ks, cls = C::cls(col), c0 = C::start(col);
    const uint32_t off = (col - c0) * 2, sbo = 1024 >> cls;
    wgmma_rs_n64<0, 0>(s, qf[ks], gmma_desc(k + c0 * BK * 2 + off, 16, sbo,
                                             cls));
  }
}

// O (64 x hd) += P (64 x 64, bf16 A fragments, pf[kk] for keys 16kk..+15)
// times the V tile (at v, MN-major): for each 16-key step in order, one
// wgmma over the class-0 chunks (their atoms 64 * BK * 2 bytes apart), then
// one a class-1 and one a class-2 chunk
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 8][4],
                                         const uint32_t (&pf)[BK / 16][4],
                                         uint32_t v) {
  using C = Chunks<HD>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t d0 = gmma_desc(v + kk * 16 * 128, 64 * BK * 2, 1024, 0);
    if constexpr (C::n64 == 2) wgmma_rs_n128<1, 0>(o, pf[kk], d0);
    if constexpr (C::n64 == 1) wgmma_rs_n64<1, 0>(o, pf[kk], d0);
    if constexpr (C::c32 >= 0)
      wgmma_rs_n32<1, C::c32 / 8>(
          o, pf[kk],
          gmma_desc(v + C::c32 * BK * 2 + kk * 16 * 64, 32 * BK * 2, 512, 1));
    if constexpr (C::c16 >= 0)
      wgmma_rs_n16<1, C::c16 / 8>(
          o, pf[kk],
          gmma_desc(v + C::c16 * BK * 2 + kk * 16 * 32, 16 * BK * 2, 256, 2));
  }
}

// P's A fragments for keys 16kk..+15, straight from the accumulators of
// n-tiles 2kk and 2kk + 1, rounded to bf16
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BK / 16][4],
                                       const float (&s)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// One block: one (b, h) and BQ2 = 128 query rows.  Warpgroup 0 is the
// producer: one thread loads Q once (a 64-row half for each consumer) and
// the block's K and V tiles into two NSTAGE-deep rings by TMA.  Warpgroups
// 1 and 2 are consumers of BQ rows each; each walks exactly the kv tiles its
// 64 rows reach, in order (a tile of the block it does not walk it only
// waits for and frees).  A consumer holds its Q rows as A fragments, issues
// tile t's S product and tile t-1's P.V product in its turn (named barriers
// alternate the two consumers, consumer 1, whose causal walk is the longer,
// first), then runs t's softmax while they run.
template <int HD>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_kernel_wgmma(const __grid_constant__ FlashMaps maps,
                   __nv_bfloat16* __restrict__ out, int S, int T, int H,
                   int K, int causal, int window, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= HD_MAX, "hd: a multiple of 16");
  using C = Chunks<HD>;
  constexpr int DN = HD / 8;            // n-tiles of O
  constexpr int NT = BK / 8;            // n-tiles of S
  constexpr uint32_t Q_BYTES = BQ2 * HD * 2, KV_BYTES = BK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Ks = Qs + Q_BYTES, Vs = Ks + NSTAGE * KV_BYTES;
  // barriers, + 8 s for stage s: K's and V's tile landed, K's and V's tile
  // read by both consumers; + 8 c: consumer c's Q rows landed
  const uint32_t full_k = Vs + NSTAGE * KV_BYTES, full_v = full_k + 8 * NSTAGE;
  const uint32_t empty_k = full_v + 8 * NSTAGE, empty_v = empty_k + 8 * NSTAGE;
  const uint32_t qbar = empty_v + 8 * NSTAGE;

  // blocks in order of their q tile (heaviest first under a causal mask),
  // then of h, then of b: every head's long diagonal walks start first
  const int nq = (S + BQ2 - 1) / BQ2, heads = gridDim.x / nq;   // H * B
  const int qi = blockIdx.x / heads, hb = blockIdx.x - qi * heads;
  const int qt = causal ? nq - 1 - qi : qi;
  const int q0 = qt * BQ2, h = hb % H, b = hb / H;
  const int kh = h / (H / K);
  // each consumer's walk, [beg, end) in keys: the parent's for the 64-row
  // tile at qw; none for rows past S
  int beg[2], end[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int qw = q0 + c * BQ;
    end[c] = qw >= S ? 0 : causal ? min(T, qw + BQ) : T;
    beg[c] = qw >= S ? 0 : window > 0 ? max(0, qw - window + 1) / BK * BK
                                      : 0;
  }
  const int kv_begin = beg[0];          // consumer 0's rows are < S
  const int n_tiles = max(0, max(end[0], end[1]) - kv_begin + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * WG_THREADS / 32);   // each consumer warp
      mbar_init(empty_v + 8 * s, 2 * WG_THREADS / 32);
    }
    mbar_init(qbar, 1);
    mbar_init(qbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG_THREADS) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      // the maps' descriptors on their way before the first copy needs them
      // (k's and v's are encoded only where there are keys)
#pragma unroll
      for (int col = 0; col < HD; col += 64 >> C::cls(col)) {
        prefetch_map(maps.q[C::cls(col)]);
        if (n_tiles > 0) {
          prefetch_map(maps.k[C::cls(col)]);
          prefetch_map(maps.v[C::cls(col)]);
        }
      }
      // consumer c's 64 rows of Q, into their place in the 128-row tile
      auto copy_q = [&](int c) {
        mbar_expect_tx(qbar + 8 * c, Q_BYTES / 2);
#pragma unroll
        for (int col = 0; col < HD; col += 64 >> C::cls(col))
          tma_load(Qs + col * BQ2 * 2 + c * BQ * (128 >> C::cls(col)),
                   maps.q[C::cls(col)], qbar + 8 * c, col, h, q0 + c * BQ, b);
      };
      // consumer 1's rows first (its causal walk is the longer), consumer
      // 0's after the first K tile; then K and V of each tile, each into
      // its own ring, once both consumers have freed the stage
      copy_q(1);
      if (n_tiles == 0) copy_q(0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NSTAGE;
        if (t >= NSTAGE) mbar_wait(empty_k + 8 * s, (t / NSTAGE - 1) & 1);
        mbar_expect_tx(full_k + 8 * s, KV_BYTES);
#pragma unroll
        for (int col = 0; col < HD; col += 64 >> C::cls(col))
          tma_load(Ks + s * KV_BYTES + col * BK * 2, maps.k[C::cls(col)],
                   full_k + 8 * s, col, kh, kv_begin + t * BK, b);
        if (t == 0) copy_q(0);
        if (t >= NSTAGE) mbar_wait(empty_v + 8 * s, (t / NSTAGE - 1) & 1);
        mbar_expect_tx(full_v + 8 * s, KV_BYTES);
#pragma unroll
        for (int col = 0; col < HD; col += 64 >> C::cls(col))
          tma_load(Vs + s * KV_BYTES + col * BK * 2, maps.v[C::cls(col)],
                   full_v + 8 * s, col, kh, kv_begin + t * BK, b);
      }
    }
  } else {
    // a consumer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = tid / WG_THREADS - 1, qw = q0 + c * BQ;
    const int warp = (tid % WG_THREADS) >> 5, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;       // mma group, thread in it
    // this consumer's tiles [tb, te) of the block's n_tiles
    const int cb = c ? beg[1] : beg[0], ce = c ? end[1] : end[0];
    const int tb = ce > cb ? (cb - kv_begin) / BK : n_tiles;
    const int te = ce > cb ? (ce - kv_begin + BK - 1) / BK : n_tiles;
    auto stage = [&](int t) { return (uint32_t)(t % NSTAGE); };
    // wait for tile t of a ring (full_k or full_v) to land; free it (empty_k
    // or empty_v) once this consumer's products have read it
    auto landed = [&](uint32_t full, int t) {
      mbar_wait(full + 8 * stage(t), (t / NSTAGE) & 1);
    };
    auto release = [&](uint32_t empty, int t) {
      if (lane == 0) mbar_arrive(empty + 8 * stage(t));
    };
    // a tile this consumer does not walk: its turn passes unused
    auto skip = [&](int t) {
      landed(full_k, t);
      release(empty_k, t);
      landed(full_v, t);
      release(empty_v, t);
      turn_wait(c);
      turn_pass(c);
    };

    float o[DN][4];
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    // rows g and g + 8 of the warp's 16: running max (log2 scale) and this
    // thread's part of the denominator
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const int row0 = qw + warp * 16 + g;
    float s[NT][4];
    uint32_t pf[BK / 16][4];

    // tile t's scores (S waited for) through the online softmax; alpha is
    // the factor that rescales O
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int k0 = kv_begin + t * BK;
      if (k0 + BK > T || (causal && k0 + BK - 1 > qw) ||
          (window > 0 && qw + BQ - 1 - k0 >= window))
        online_softmax<true>(s, m, l, alpha, scale_log2, row0, k0 + tg * 2,
                             T, causal, window);
      else
        online_softmax<false>(s, m, l, alpha, scale_log2, row0, k0 + tg * 2,
                              T, causal, window);
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    };
    auto zero_s = [&]() {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    };

    mbar_wait(qbar + 8 * c, 0);
    uint32_t qf[HD / 16][4];
    load_q<HD>(qf, Qs, c, warp, lane);
    if (c == 0) turn_pass(0);           // consumer 1 takes the first turn
    for (int t = 0; t < tb; ++t) skip(t);
    if (tb < te) {
      // tile tb: S alone in this turn
      float alpha[2];
      landed(full_k, tb);
      turn_wait(c);
      zero_s();
      pin(s);
      wgmma_fence();
      issue_qk<HD>(s, qf, Ks + stage(tb) * KV_BYTES);
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<0>();
      pin(s);
      release(empty_k, tb);
      softmax(tb, alpha);
      rescale(alpha);
      pack_p(pf, s);
      for (int t = tb + 1; t < te; ++t) {
        // tile t's S and tile t-1's P.V in one turn; t's softmax overlaps
        // the P.V and the other consumer's turn
        landed(full_k, t);
        landed(full_v, t - 1);
        turn_wait(c);
        zero_s();
        pin(s);
        pin(o);
        wgmma_fence();
        issue_qk<HD>(s, qf, Ks + stage(t) * KV_BYTES);
        wgmma_commit();
        issue_pv<HD>(o, pf, Vs + stage(t - 1) * KV_BYTES);
        wgmma_commit();
        turn_pass(c);
        wgmma_wait<1>();                // S done, P.V may run on
        pin(s);
        release(empty_k, t);
        softmax(t, alpha);
        wgmma_wait<0>();
        pin(o);
        pin(pf);
        release(empty_v, t - 1);
        rescale(alpha);
        pack_p(pf, s);
      }
      // the last tile's P.V
      landed(full_v, te - 1);
      turn_wait(c);
      pin(o);
      wgmma_fence();
      issue_pv<HD>(o, pf, Vs + stage(te - 1) * KV_BYTES);
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<0>();
      pin(o);
      pin(pf);
      release(empty_v, te - 1);
    } else {
      turn_wait(c);                     // the turn a walk's last P.V takes
      turn_pass(c);
    }
    for (int t = te; t < n_tiles; ++t) skip(t);
    if (c == 1) turn_wait(1);           // consumer 0's last pass

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const size_t qs = (size_t)H * HD;   // per position
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
            __floats2bfloat162_rn(o[j][2 * i] / denom,
                                  o[j][2 * i + 1] / denom);
    }
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
               int S, int T, int H, int K, int hd, int causal, int window,
               float scale, cudaStream_t stream) {
  static size_t granted[64] = {};
  const size_t smem = smem_floats(hd) * sizeof(float);
  const cudaError_t e = grant_smem(flash_kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T, H, K,
      hd, causal, window, scale);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda); null if the driver has none
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// the map of a (B, rows, heads, hd) bf16 tensor in place, read in boxes of
// box_rows rows of one head and one chunk of class cls; rows past `rows`
// read as zeros
CUresult encode_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map,
                    const void* base, int B, int rows, int heads, int hd,
                    int box_rows, int cls) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(64 >> cls), 1,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle[3] = {CU_TENSOR_MAP_SWIZZLE_128B,
                                         CU_TENSOR_MAP_SWIZZLE_64B,
                                         CU_TENSOR_MAP_SWIZZLE_32B};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle[cls],
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// q's, k's and v's maps for every chunk class of HD (none for k and v when
// there are no keys); 0 or ENCODE_ERROR + the CUresult
template <int HD>
int encode_maps(FlashMaps* maps, const void* q, const void* k, const void* v,
                int B, int S, int T, int H, int K) {
  using C = Chunks<HD>;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return ENCODE_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  memset(maps, 0, sizeof(FlashMaps));
  for (int cls = 0; cls < 3; ++cls) {
    if ((cls == 0 && C::n64 == 0) || (cls == 1 && C::c32 < 0) ||
        (cls == 2 && C::c16 < 0))
      continue;
    CUresult r = encode_map(encode, &maps->q[cls], q, B, S, H, HD, BQ, cls);
    if (r == CUDA_SUCCESS && T > 0)
      r = encode_map(encode, &maps->k[cls], k, B, T, K, HD, BK, cls);
    if (r == CUDA_SUCCESS && T > 0)
      r = encode_map(encode, &maps->v[cls], v, B, T, K, HD, BK, cls);
    if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  }
  return 0;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int T, int H, int K, int causal, int window,
                 float scale, cudaStream_t stream) {
  static size_t granted[64] = {};
  constexpr size_t smem = ws_smem_bytes(HD);
  const cudaError_t e = grant_smem(flash_kernel_wgmma<HD>, smem, granted);
  if (e != cudaSuccess) return (int)e;
  FlashMaps maps;
  const int rc = encode_maps<HD>(&maps, q, k, v, B, S, T, H, K);
  if (rc != 0) return rc;
  // one dimension: q tile, then h, then b
  const long long blocks = (long long)((S + BQ2 - 1) / BQ2) * H * B;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  flash_kernel_wgmma<HD><<<(unsigned)blocks, WS_THREADS, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(out), S, T, H, K, causal, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int T, int H, int K, int hd, int causal,
                int window, float scale, cudaStream_t stream) {
#define FLASH_WGMMA_CASE(D)                                                 \
  case D:                                                                   \
    return launch_wgmma<D>(q, k, v, out, B, S, T, H, K, causal, window,     \
                           scale, stream);
  switch (hd) {
    FLASH_WGMMA_CASE(16)
    FLASH_WGMMA_CASE(32)
    FLASH_WGMMA_CASE(48)
    FLASH_WGMMA_CASE(64)
    FLASH_WGMMA_CASE(80)
    FLASH_WGMMA_CASE(96)
    FLASH_WGMMA_CASE(112)
    FLASH_WGMMA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_WGMMA_CASE
}

}  // namespace

extern "C" int flash_attention_max_hd() { return HD_MAX; }

// dtype 0 = fp32 (any hd <= 128), 1 = bf16 (hd a multiple of 16 up to 128);
// q, k, v and out alike, 16-byte aligned for bf16.  S query rows, T keys; T
// != S only without a causal mask or a window.  Launches on `stream`;
// returns cudaGetLastError() (0 = launched), or ENCODE_ERROR (65536) plus
// the CUresult of a failed tensor-map encode.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int T, int H, int K,
                               int hd, int causal, int window, float scale,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T < 0 || H <= 0 || K <= 0 || H % K != 0 || hd <= 0 || hd > HD_MAX ||
      window < 0 || H > 65535 || B > 65535 ||
      (T != S && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, S, T, H, K, hd, causal, window, scale,
                      s);
  if (dtype == 1 && (long long)T * K * hd >= (1LL << 31))
    return (int)cudaErrorInvalidValue;  // a batch row of k/v: < 2^31
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, S, T, H, K, hd, causal, window,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= ENCODE_ERROR) {
    static thread_local char msg[64];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed, CUresult %d",
             code - ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
