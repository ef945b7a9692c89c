#!/usr/bin/env python3
"""Do ``wgmma`` and ``mma.sync`` sum a bf16 product's 16-wide k steps to the
same fp32 bits on this card?  The question decides whether the bf16 flash
kernel on ``wgmma`` can keep the bits of the route before it, which ran on
``mma.sync`` m16n8k16.

    python3 tools/flash_k16_check.py

Builds, with one ``nvcc``, a check kernel that includes
``csrc/flash_attention.cu`` and uses its own helpers: one warpgroup loads a
64-row Q tile, a 64-key K tile and a V tile by TMA into the kernel's
chunked, swizzled layout, computes S = Q.K^T with ``issue_qk`` (m64n64k16,
Q's fragments in registers through ``load_q``, K from shared memory) and O
= P.V with ``issue_pv`` (P's fragments in registers, V as the transposed B
operand); then each warp computes the same two products on ``mma.sync``
m16n8k16 from fragments read straight from global memory, k steps in the
same order, from zero.  At every head dim the kernel takes (16 to 128,
every chunk class) and two input kinds (normal, and entries spread over
2^-8..2^8 so that the order of a sum shows), it prints whether the two are
``torch.equal`` and how far each lies from the product in fp32 on the card.
It also counts, per kernel function of the built ``flash_attention``
library, its HGMMA, HMMA.16816, UTMALDG, LDGSTS and LDSM instructions
(``cuobjdump -sass``), times on the host one call of the C interface in
bf16, its tensor maps' encode included, beside one in fp32 (``host_us``),
and times ``nvcc`` on the source alone (``nvcc_seconds``).  The last
line is a JSON summary; exit 0 when every pair is equal.  Needs one card
and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDS = (16, 32, 48, 64, 80, 96, 112, 128)

CHECK_CU = r'''
#include "%(source)s"

namespace {

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%%0, %%1, %%2, %%3}, {%%4, %%5, %%6, %%7}, {%%8, %%9}, "
      "{%%0, %%1, %%2, %%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbours, or p[0] and p[stride], as one bf16x2 register
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p, int stride) {
  __nv_bfloat162 h;
  h.x = p[0];
  h.y = p[stride];
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS)
k16_check_kernel(const __grid_constant__ FlashMaps maps,
                 const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* p, const __nv_bfloat16* v,
                 float* s_wg, float* s_mma, float* o_wg, float* o_mma) {
  using C = Chunks<HD>;
  // Q's tile has the kernel's BQ2 rows a chunk; its first BQ are loaded
  constexpr uint32_t Q_BYTES = BQ2 * HD * 2, KV_BYTES = BK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Ks = Qs + Q_BYTES, Vs = Ks + KV_BYTES;
  const uint32_t bar = Vs + KV_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3, r = warp * 16 + g;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, BQ * HD * 2 + 2 * KV_BYTES);
    for (int col = 0; col < HD; col += 64 >> C::cls(col)) {
      tma_load(Qs + col * BQ2 * 2, maps.q[C::cls(col)], bar, col, 0, 0, 0);
      tma_load(Ks + col * BK * 2, maps.k[C::cls(col)], bar, col, 0, 0, 0);
      tma_load(Vs + col * BK * 2, maps.v[C::cls(col)], bar, col, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);

  float s[BK / 8][4], o[HD / 8][4];
  uint32_t qf[HD / 16][4], pf[BK / 16][4];
  load_q<HD>(qf, Qs, 0, warp, lane);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = ld2(p + r * BK + 16 * kk + 2 * tg);
    pf[kk][1] = ld2(p + (r + 8) * BK + 16 * kk + 2 * tg);
    pf[kk][2] = ld2(p + r * BK + 16 * kk + 8 + 2 * tg);
    pf[kk][3] = ld2(p + (r + 8) * BK + 16 * kk + 8 + 2 * tg);
  }
  pin(s);
  pin(o);
  pin(pf);
  wgmma_fence();
  issue_qk<HD>(s, qf, Ks);
  wgmma_commit();
  issue_pv<HD>(o, pf, Vs);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  pin(o);
  pin(pf);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_wg[(r + 8 * (e >> 1)) * BK + 8 * j + 2 * tg + (e & 1)] = s[j][e];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_wg[(r + 8 * (e >> 1)) * HD + 8 * j + 2 * tg + (e & 1)] = o[j][e];

#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t a[4] = {ld2(q + r * HD + 16 * kk + 2 * tg),
                           ld2(q + (r + 8) * HD + 16 * kk + 2 * tg),
                           ld2(q + r * HD + 16 * kk + 8 + 2 * tg),
                           ld2(q + (r + 8) * HD + 16 * kk + 8 + 2 * tg)};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const __nv_bfloat16* kr = k + (8 * j + g) * HD + 16 * kk + 2 * tg;
      mma_16816(s[j], a, ld2(kr), ld2(kr + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat16* vc = v + (16 * kk + 2 * tg) * HD + 8 * j + g;
      mma_16816(o[j], pf[kk], pair(vc, HD), pair(vc + 8 * HD, HD));
    }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_mma[(r + 8 * (e >> 1)) * BK + 8 * j + 2 * tg + (e & 1)] = s[j][e];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_mma[(r + 8 * (e >> 1)) * HD + 8 * j + 2 * tg + (e & 1)] = o[j][e];
}

template <int HD>
int run(const void* q, const void* k, const void* p, const void* v,
        float* s_wg, float* s_mma, float* o_wg, float* o_mma) {
  FlashMaps maps;
  const int rc = encode_maps<HD>(&maps, q, k, v, 1, BK, BK, 1, 1);
  if (rc) return rc;
  const size_t smem = (size_t)(BQ2 + 2 * BK) * HD * 2 + 8 + 1024;
  cudaFuncSetAttribute(k16_check_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k16_check_kernel<HD><<<1, WG_THREADS, smem>>>(
      maps, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)p, (const __nv_bfloat16*)v, s_wg, s_mma, o_wg,
      o_mma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k16_check(const void* q, const void* k, const void* p,
                         const void* v, float* s_wg, float* s_mma,
                         float* o_wg, float* o_mma, int hd) {
  switch (hd) {
    case 16: return run<16>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
    case 32: return run<32>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
    case 48: return run<48>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
    case 64: return run<64>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
    case 80: return run<80>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
    case 96: return run<96>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
    case 112: return run<112>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
    case 128: return run<128>(q, k, p, v, s_wg, s_mma, o_wg, o_mma);
  }
  return (int)cudaErrorInvalidValue;
}
'''


def build() -> ctypes.CDLL:
    sys.path[:0] = [os.path.join(ROOT, "src")]
    from repro_torch.kernels import _build
    out = os.path.join(_build.BUILD_DIR, "k16_check")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "k16_check.cu"), os.path.join(out,
                                                              "k16_check.so")
    with open(cu, "w") as fh:
        fh.write(CHECK_CU % {"source": os.path.join(_build.CSRC,
                                                    "flash_attention.cu")})
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode:
        raise SystemExit("nvcc failed for the check kernel")
    lib = ctypes.CDLL(so)
    lib.k16_check.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
    lib.k16_check.restype = ctypes.c_int
    return lib


def sass_census() -> dict:
    """Per kernel function of the built ``flash_attention`` library, the
    count of each tensor-core and copy instruction in its SASS
    (``cuobjdump -sass``): HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA
    loads), LDGSTS (cp.async), LDSM (ldmatrix)."""
    from repro_torch.kernels import _build
    return _build.sass_census("flash_attention", (
        "HGMMA", "HMMA.16816", "UTMALDG", "LDGSTS", "LDSM"))


def nvcc_seconds(runs: int = 2) -> list:
    """Seconds one ``nvcc`` takes for ``csrc/flash_attention.cu`` alone,
    with the flags the port builds with, ``runs`` times."""
    import time
    from repro_torch.kernels import _build
    out = os.path.join(_build.BUILD_DIR, "k16_check", "flash_alone.so")
    took = []
    for _ in range(runs):
        t0 = time.perf_counter()
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                        os.path.join(_build.CSRC, "flash_attention.cu")],
                       check=True, capture_output=True)
        took.append(time.perf_counter() - t0)
    return took


def host_us(n: int = 100, batches: int = 50) -> dict:
    """Host microseconds one call of the library's C ``flash_attention``
    takes to return (it encodes and launches; nothing waits for the card)
    at the engine's one-prompt prefill (B 1, S 128, H 16, K 8, hd 128,
    causal): the median over ``batches`` batches of ``n`` calls, the card
    idle before each batch so that no call waits for a full launch queue;
    bf16, whose launch encodes three tensor maps, beside fp32, whose launch
    encodes none."""
    import math
    import time
    import torch
    from repro_torch.kernels import flash_attention as fa
    lib = fa._lib()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 128, 16, 128, device="cuda", dtype=dtype)
        k, v = (torch.randn(1, 128, 8, 128, device="cuda", dtype=dtype)
                for _ in range(2))
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                128, 128, 16, 8, 128, 1, 0, 1.0 / math.sqrt(128),
                fa.DTYPES[dtype], stream)
        per_call = []
        for _ in range(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                rc = lib.flash_attention(*args)
            per_call.append((time.perf_counter() - t0) / n * 1e6)
            if rc:
                raise SystemExit(f"flash_attention: CUDA error {rc}")
        torch.cuda.synchronize()
        out[str(dtype).split(".")[1]] = sorted(per_call)[batches // 2]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_k16_check: needs a CUDA card")
    lib = build()
    census = sass_census()
    for name, counts in census.items():
        print(f"sass {name}: {counts}", flush=True)
    host = host_us()
    print(f"host us a C launch call at B 1, S 128: {host}", flush=True)
    nvcc_s = nvcc_seconds()
    print(f"nvcc seconds for csrc/flash_attention.cu alone: {nvcc_s}",
          flush=True)
    gen = torch.Generator().manual_seed(0)
    summary, ok = {}, True
    for hd in HDS:
        for kind in ("normal", "spread"):
            def draw(*shape):
                x = torch.randn(shape, generator=gen)
                if kind == "spread":
                    x = x * 2.0 ** torch.randint(-8, 9, shape, generator=gen)
                return x.bfloat16().cuda()
            q, k, v = draw(64, hd), draw(64, hd), draw(64, hd)
            p = torch.rand((64, 64), generator=gen).bfloat16().cuda()
            outs = [torch.full((64, n), float("nan"), device="cuda")
                    for n in (64, 64, hd, hd)]
            rc = lib.k16_check(*(t.data_ptr() for t in (q, k, p, v, *outs)),
                               hd)
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"hd {hd}: launch failed, code {rc}")
            s_wg, s_mma, o_wg, o_mma = outs
            s32, o32 = q.float() @ k.float().T, p.float() @ v.float()
            row = {"S equal": torch.equal(s_wg, s_mma),
                   "O equal": torch.equal(o_wg, o_mma),
                   "S differing": int((s_wg != s_mma).sum()),
                   "O differing": int((o_wg != o_mma).sum()),
                   "S wgmma vs fp32": float((s_wg - s32).abs().max()),
                   "S mma.sync vs fp32": float((s_mma - s32).abs().max()),
                   "O wgmma vs fp32": float((o_wg - o32).abs().max()),
                   "O mma.sync vs fp32": float((o_mma - o32).abs().max())}
            ok = ok and row["S equal"] and row["O equal"]
            summary[f"hd={hd} {kind}"] = row
            print(f"hd={hd} {kind}: {row}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"device": smi, "equal": ok, "cases": summary,
                      "sass": census, "host_us": host, "nvcc_s": nvcc_s}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
