// Register probe for the dk/dv kernel of flash attention's backward (B2)
// on Hopper (sm_90a). Compiled, never launched: tools/setmaxnreg_probe.py
// builds it in several configurations and reads ptxas's report and the
// SASS (local-memory loads and stores are spills).
//
// The body is the dk/dv step with its live state: dk and dv [64 x 128]
// f32 a warpgroup (128 registers a thread), S^T and dP^T [64 x kQN] f32
// (kQN / 2 each), P^T and dS^T rounded to bf16 as register A operands,
// and the per-column lse and delta read from shared memory.
//
//   PROBE_THREADS  384: a producer warpgroup; 288: a producer warp
//   PROBE_PROD     registers the producer keeps after setmaxnreg.dec (0: none)
//   PROBE_CONS     registers the consumers take by setmaxnreg.inc (0: none)
//   PROBE_QN       q columns of S^T and dP^T: 64 or 32
//   PROBE_TRAP     1: each step first waits on a shared-memory word with
//                  the timeout of flash_attention.cu's mbar_wait (a trap
//                  after 2^35 cycles) in the consumers' path

#include <cuda_bf16.h>
#include <stdint.h>

#ifndef PROBE_THREADS
#define PROBE_THREADS 384
#endif
#ifndef PROBE_PROD
#define PROBE_PROD 24
#endif
#ifndef PROBE_CONS
#define PROBE_CONS 240
#endif
#ifndef PROBE_QN
#define PROBE_QN 64
#endif
#ifndef PROBE_TRAP
#define PROBE_TRAP 0
#endif

#define STR2(x) #x
#define STR(x) STR2(x)

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define F4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d[64 x 64] (+)= A . B, both K-major in shared memory.
__device__ __forceinline__ void ss_n64(float (&d)[8][4], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F4(0), F4(1), F4(2), F4(3), F4(4), F4(5), F4(6), F4(7)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 32] (+)= A . B, both K-major in shared memory.
__device__ __forceinline__ void ss_n32(float (&d)[4][4], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : F4(0), F4(1), F4(2), F4(3)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 128] += A[64 x 16] (registers) . B (MN-major in shared memory).
__device__ __forceinline__ void rs_n128(float (&d)[16][4],
                                        const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : F4(0), F4(1), F4(2), F4(3), F4(4), F4(5), F4(6), F4(7), F4(8), F4(9),
        F4(10), F4(11), F4(12), F4(13), F4(14), F4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NT>
__device__ __forceinline__ void pin(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(a[i][e])::"memory");
}

template <int NT>
__device__ __forceinline__ void score_step(float (&st)[NT][4], uint32_t k_s,
                                           uint32_t q_s) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t da = desc(k_s + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc(q_s + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024);
    if constexpr (NT == 8)
      ss_n64(st, da, db, kk > 0);
    else
      ss_n32(st, da, db, kk > 0);
  }
}

__global__ void __launch_bounds__(PROBE_THREADS, 1)
    probe_dkv(float* out, int n_it, float scale) {
  constexpr int kQN = PROBE_QN, NT = kQN / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t k_s = base, v_s = base + 16384, q_s = base + 32768,
                 do_s = base + 49152;
  const float* stats = reinterpret_cast<const float*>(smem + 65536);
  if (threadIdx.x >= 256) {
#if PROBE_PROD > 0
    asm volatile("setmaxnreg.dec.sync.aligned.u32 " STR(PROBE_PROD) ";\n");
#endif
    if (threadIdx.x == 256) out[0] = 0.f;
  } else {
#if PROBE_CONS > 0
    asm volatile("setmaxnreg.inc.sync.aligned.u32 " STR(PROBE_CONS) ";\n");
#endif
    const int t = threadIdx.x % 4;
    float dk[16][4], dv[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
    for (int it = 0; it < n_it; ++it) {
#if PROBE_TRAP
      const long long t0 = clock64();
      while (*reinterpret_cast<volatile const int*>(stats + 128) != it)
        if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
#endif
      float st[NT][4], dpt[NT][4];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      score_step<NT>(st, k_s, q_s);
      score_step<NT>(dpt, v_s, do_s);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(st);
      pin(dpt);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const float pe = expf(st[nt][e] * scale - stats[col]);
          st[nt][e] = pe;
          dpt[nt][e] = pe * (dpt[nt][e] - stats[64 + col]) * scale;
        }
      uint32_t pa[kQN / 16][4];
#pragma unroll
      for (int kc = 0; kc < kQN / 16; ++kc) {
        pa[kc][0] = pack(st[2 * kc][0], st[2 * kc][1]);
        pa[kc][1] = pack(st[2 * kc][2], st[2 * kc][3]);
        pa[kc][2] = pack(st[2 * kc + 1][0], st[2 * kc + 1][1]);
        pa[kc][3] = pack(st[2 * kc + 1][2], st[2 * kc + 1][3]);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kc = 0; kc < kQN / 16; ++kc)
        rs_n128(dv, pa[kc], desc(do_s + kc * 2048, 8192, 1024));
      // dS^T in registers of its own: P^T's stay read by the dv products.
      uint32_t dsa[kQN / 16][4];
#pragma unroll
      for (int kc = 0; kc < kQN / 16; ++kc) {
        dsa[kc][0] = pack(dpt[2 * kc][0], dpt[2 * kc][1]);
        dsa[kc][1] = pack(dpt[2 * kc][2], dpt[2 * kc][3]);
        dsa[kc][2] = pack(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]);
        dsa[kc][3] = pack(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3]);
      }
#pragma unroll
      for (int kc = 0; kc < kQN / 16; ++kc)
        rs_n128(dk, dsa[kc], desc(q_s + kc * 2048, 8192, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(dk);
      pin(dv);
    }
    float* o = out + threadIdx.x * 128;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[i * 4 + e] = dk[i][e];
        o[64 + i * 4 + e] = dv[i][e];
      }
  }
}
