// Flash attention, forward (B1) and backward (B2), written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/pallas_attention.py:
//   - flash_fwd_kernel  <- _flash_forward / _flash_kernel (B1);
//   - flash_dq_kernel   <- flash_backward_T / _bwd_dq_kernel (B2);
//   - flash_dkv_kernel  <- flash_backward_T / _bwd_dkv_kernel (B2).
// Same math: logits from bf16 products with f32 accumulation, scaled
// after the product; causal mask (row >= column) with the finite
// NEG_INF = -2^30; online softmax with P rounded to bf16 before P.V;
// out = acc / max(l, 1e-30), rows whose max stayed at NEG_INF give 0,
// lse = m + log(max(l, 1e-30)). The backward recomputes
// P = exp(s * scale - lse), dP = dO.V^T, dS = P (dP - delta) scale
// rounded to bf16 before dq = dS.K and dk = dS^T.Q, and P rounded to
// bf16 before dv = P^T.dO.
//
// Bound on the H100: tensor-core operations. At the training shape
// (s = 2048, d = 128) each block does ~64 flops per byte it loads, and
// the whole call moves only q/k/v/out once (the s x s scores never
// leave the chip). Design, simple and right first:
//   - mma.sync.m16n8k16 bf16 -> f32 (Hopper's warp-level tensor-core
//     path; wgmma, TMA and warp specialisation are later perf work);
//   - 4 warps per block, each owning 16 rows of a 64-row tile; the
//     score tile stays in registers and is turned into the A operand
//     of the next product without touching shared memory;
//   - 64-row tiles staged through shared memory with cp.async, two
//     buffers, so the next tile loads while this one computes; rows
//     padded by 16 bytes so ldmatrix reads are free of bank conflicts;
//   - the TPU ran its grid cell after cell and carried (acc, m, l) in
//     scratch; here the kv loop lives inside the block and the cells
//     run as concurrent blocks; causal blocks with the most tiles are
//     scheduled first;
//   - the GQA sum of dk/dv stays inside one block (it loops over the
//     group's query heads), so there are no atomics and the result is
//     deterministic;
//   - q/k/v/dO are read through their [b, s, h, d] strides; a ragged
//     tail (s not a multiple of 64) is zero-filled by cp.async, masked
//     with NEG_INF, and never stored.
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch
// headers, so nvcc builds this file in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // rows of a q or kv tile (16 per warp)
constexpr float kNegInf = -1073741824.f;  // -2^30, ops/attention.py NEG_INF

struct Strides {
  long long b, s, h;  // element strides of a [b, s, h, d] tensor (d: 1)
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse_in;
  const float* delta;
  bf16* out;
  float* lse;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, sdo;
  int b, h, kh, seq_q, seq_k, d, causal;
  float scale;
};

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- warp-level products --------------------------------------------------
//
// Fragment layout of an m16n8 f32 accumulator c[4] (lane = 4 g + t):
// c[0], c[1] at row g, columns 2t, 2t + 1; c[2], c[3] at row g + 8.

// acc[16 x 8 NT] += A[16 x kD] . B[8 NT x kD]^T; A and B rows in shared
// memory with row stride kD + 8.
template <int kD, int NT>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const bf16* a_s,
                                        const bf16* b_s, int lane) {
  constexpr int ld = kD + 8;
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t a[4];
    ldmatrix_x4(a, a_s + (lane % 16) * ld + kc * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_s + (nt * 8 + r + (i / 2) * 8) * ld + kc * 16 +
                         (i % 2) * 8);
      mma_bf16(acc[nt], a, b[0], b[1]);
      mma_bf16(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x kD] += P[16 x 16 KC] . B[16 KC x kD]; P as A fragments in
// registers, B row-major in shared memory (row stride kD + 8).
template <int kD, int KC>
__device__ __forceinline__ void gemm_pv(float (&acc)[kD / 8][4],
                                        const uint32_t (&pa)[KC][4],
                                        const bf16* b_s, int lane) {
  constexpr int ld = kD + 8;
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int dt = 0; dt < kD / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_s + (kc * 16 + r + (i % 2) * 8) * ld + dt * 8 +
                               (i / 2) * 8);
      mma_bf16(acc[dt], pa[kc], b[0], b[1]);
      mma_bf16(acc[dt + 1], pa[kc], b[2], b[3]);
    }
  }
}

// An accumulator tile [16 x 8 NT], rounded to bf16, as the A operand
// [16 x 16 (NT / 2)] of the next product.
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&pa)[NT / 2][4],
                                     const float (&s)[NT][4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// Rows row0 .. row0 + 63 of one (batch, head) slice into shared memory
// (row stride kD + 8); rows >= n and columns >= d are zero-filled.
template <int kD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long row_stride, int row0,
                                          int n, int d) {
  constexpr int kChunks = kD / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < n && c * 8 < d;
    const bf16* src =
        valid ? base + static_cast<long long>(row0 + r) * row_stride + c * 8
              : base;
    cp_async16(dst + r * (kD + 8) + c * 8, src, valid);
  }
}

// 64 per-row f32 statistics (lse or delta) of rows row0 .. into shared.
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int row0, int n) {
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, r < n ? src + r : src, r < n);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a warp's [16 x kD] f32 tile as bf16 rows (row0 + g, row0 + g + 8)
// of a contiguous [., rows, heads, d] output; row r at dst + r * row_stride.
template <int kD>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           int row0, int n, int d,
                                           const float (&acc)[kD / 8][4],
                                           const float (&div)[2], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= n) continue;
    bf16* p = dst + static_cast<long long>(row) * row_stride;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(p + col) =
            pack_bf16(acc[dt][2 * half] / div[half],
                      acc[dt][2 * half + 1] / div[half]);
    }
  }
}

// ---- B1: forward ------------------------------------------------------------
//
// Grid (q tiles, h, b). Shared: Q tile, two K and two V buffers.

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int ld = kD + 8;
  constexpr int kTileElems = kTile * ld;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kTileElems;
  bf16* v_s = k_s + 2 * kTileElems;

  const int n_qt = (p.seq_q + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;  // the longest causal rows first
  const int head = blockIdx.y, bi = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* qb = p.q + bi * p.sq.b + head * p.sq.h;
  const bf16* kb = p.k + bi * p.sk.b + kvh * p.sk.h;
  const bf16* vb = p.v + bi * p.sv.b + kvh * p.sv.h;

  // Causal: the tile's last row sees kv tiles up to its own index. Tile
  // 0 comes first, so every row has a finite max before any tile that
  // masks all of its columns.
  int n_kt = (p.seq_k + kTile - 1) / kTile;
  if (p.causal) {
    const int last_row = min(q0 + kTile - 1, p.seq_q - 1);
    n_kt = min(n_kt, last_row / kTile + 1);
  }

  load_tile<kD>(q_s, qb, p.sq.s, q0, p.seq_q, p.d);
  load_tile<kD>(k_s, kb, p.sk.s, 0, p.seq_k, p.d);
  load_tile<kD>(v_s, vb, p.sv.s, 0, p.seq_k, p.d);
  cp_async_commit();

  float o[kD / 8][4];
  zero(o);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int row_base = q0 + warp * 16 + g;  // rows row_base, row_base + 8

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_kt) {
      load_tile<kD>(k_s + (buf ^ 1) * kTileElems, kb, p.sk.s,
                    (it + 1) * kTile, p.seq_k, p.d);
      load_tile<kD>(v_s + (buf ^ 1) * kTileElems, vb, p.sv.s,
                    (it + 1) * kTile, p.seq_k, p.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4];
    zero(s);
    gemm_nt<kD, 8>(s, q_s + warp * 16 * ld, k_s + buf * kTileElems, lane);

    const int k0 = it * kTile;
    const bool masked =
        (p.causal && k0 + kTile - 1 > q0) || k0 + kTile > p.seq_k;
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (masked) {
          const int row = row_base + (e >> 1) * 8;
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          if (col >= p.seq_k || (p.causal && col > row)) x = kNegInf;
        }
        s[nt][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = quad_max(mt[r]);  // the new running max of the row
      corr[r] = expf(m[r] - mt[r]);
      m[r] = mt[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
    uint32_t pa[4][4];
    to_a<8>(pa, s);
    gemm_pv<kD, 4>(o, pa, v_s + buf * kTileElems, lane);
    __syncthreads();  // all warps are done with buf before it is refilled
  }

  float div[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);  // the row's l is split over the quad
    div[r] = fmaxf(l[r], 1e-30f);
  }
  // Rows that saw no key: the output is zero (acc / +inf), not acc / l.
  float o_div[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    o_div[r] = m[r] > kNegInf / 2 ? div[r] : __int_as_float(0x7f800000);
  const long long row_stride = static_cast<long long>(p.h) * p.d;
  store_rows<kD>(p.out + (static_cast<long long>(bi) * p.seq_q * p.h + head) *
                             p.d,
                 row_stride, q0 + warp * 16, p.seq_q, p.d, o, o_div, lane);
  if (t == 0) {
    float* lse = p.lse + (static_cast<long long>(bi) * p.h + head) * p.seq_q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_base + r * 8;
      if (row < p.seq_q) lse[row] = m[r] + logf(div[r]);
    }
  }
}

// ---- B2: dq ---------------------------------------------------------------
//
// Grid (q tiles, h, b). Shared: Q and dO tiles, two K and two V buffers.

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  constexpr int ld = kD + 8;
  constexpr int kTileElems = kTile * ld;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kTileElems;
  bf16* k_s = do_s + kTileElems;
  bf16* v_s = k_s + 2 * kTileElems;

  const int n_qt = (p.seq_q + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;
  const int head = blockIdx.y, bi = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* qb = p.q + bi * p.sq.b + head * p.sq.h;
  const bf16* dob = p.dout + bi * p.sdo.b + head * p.sdo.h;
  const bf16* kb = p.k + bi * p.sk.b + kvh * p.sk.h;
  const bf16* vb = p.v + bi * p.sv.b + kvh * p.sv.h;

  int n_kt = (p.seq_k + kTile - 1) / kTile;
  if (p.causal) {
    const int last_row = min(q0 + kTile - 1, p.seq_q - 1);
    n_kt = min(n_kt, last_row / kTile + 1);
  }

  load_tile<kD>(q_s, qb, p.sq.s, q0, p.seq_q, p.d);
  load_tile<kD>(do_s, dob, p.sdo.s, q0, p.seq_q, p.d);
  load_tile<kD>(k_s, kb, p.sk.s, 0, p.seq_k, p.d);
  load_tile<kD>(v_s, vb, p.sv.s, 0, p.seq_k, p.d);
  cp_async_commit();

  const int row_base = q0 + warp * 16 + g;
  const long long stat0 = (static_cast<long long>(bi) * p.h + head) * p.seq_q;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + r * 8;
    lse[r] = row < p.seq_q ? p.lse_in[stat0 + row] : 0.f;
    dl[r] = row < p.seq_q ? p.delta[stat0 + row] : 0.f;
  }

  float dq[kD / 8][4];
  zero(dq);
  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_kt) {
      load_tile<kD>(k_s + (buf ^ 1) * kTileElems, kb, p.sk.s,
                    (it + 1) * kTile, p.seq_k, p.d);
      load_tile<kD>(v_s + (buf ^ 1) * kTileElems, vb, p.sv.s,
                    (it + 1) * kTile, p.seq_k, p.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    gemm_nt<kD, 8>(s, q_s + warp * 16 * ld, k_s + buf * kTileElems, lane);
    gemm_nt<kD, 8>(dp, do_s + warp * 16 * ld, v_s + buf * kTileElems, lane);
    const int k0 = it * kTile;
    const bool masked =
        (p.causal && k0 + kTile - 1 > q0) || k0 + kTile > p.seq_k;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (masked) {
          const int row = row_base + (e >> 1) * 8;
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          if (col >= p.seq_k || (p.causal && col > row)) x = kNegInf;
        }
        const float pe = expf(x - lse[e >> 1]);
        s[nt][e] = pe * (dp[nt][e] - dl[e >> 1]) * p.scale;  // dS
      }
    }
    uint32_t dsa[4][4];
    to_a<8>(dsa, s);
    gemm_pv<kD, 4>(dq, dsa, k_s + buf * kTileElems, lane);
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  store_rows<kD>(p.dq + (static_cast<long long>(bi) * p.seq_q * p.h + head) *
                            p.d,
                 static_cast<long long>(p.h) * p.d, q0 + warp * 16, p.seq_q,
                 p.d, dq, one, lane);
}

// ---- B2: dk / dv ----------------------------------------------------------
//
// Grid (kv tiles, kh, b). Each warp owns 16 kv rows and works on the
// transposed products: S^T = K.Q^T, dP^T = V.dO^T, then dv += P^T.dO and
// dk += dS^T.Q. The loop runs over the group's query heads and, for each,
// the q tiles at or past the diagonal, in halves of 32 q rows to keep
// the two [16 x kD] accumulators and the score tiles in registers.
// Shared: K and V tiles, two Q, dO, lse and delta buffers.

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  constexpr int ld = kD + 8;
  constexpr int kTileElems = kTile * ld;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTileElems;
  bf16* q_s = v_s + kTileElems;         // 2 buffers
  bf16* do_s = q_s + 2 * kTileElems;    // 2 buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // 2 x 64
  float* dl_s = lse_s + 2 * kTile;                                 // 2 x 64

  const int kt = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int group = p.h / p.kh;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* kb = p.k + bi * p.sk.b + kvh * p.sk.h;
  const bf16* vb = p.v + bi * p.sv.b + kvh * p.sv.h;

  const int n_qt = (p.seq_q + kTile - 1) / kTile;
  const int first_qt = p.causal ? min(kt, n_qt) : 0;
  const int per_head = n_qt - first_qt;
  const int n_it = group * per_head;

  // Sources of iteration j: query head kvh * group + j / per_head, q tile
  // first_qt + j % per_head.
  auto prefetch = [&](int j, int buf) {
    const int head = kvh * group + j / per_head;
    const int q0 = (first_qt + j % per_head) * kTile;
    load_tile<kD>(q_s + buf * kTileElems, p.q + bi * p.sq.b + head * p.sq.h,
                  p.sq.s, q0, p.seq_q, p.d);
    load_tile<kD>(do_s + buf * kTileElems,
                  p.dout + bi * p.sdo.b + head * p.sdo.h, p.sdo.s, q0,
                  p.seq_q, p.d);
    const long long stat0 =
        (static_cast<long long>(bi) * p.h + head) * p.seq_q;
    load_stats(lse_s + buf * kTile, p.lse_in + stat0, q0, p.seq_q);
    load_stats(dl_s + buf * kTile, p.delta + stat0, q0, p.seq_q);
  };

  load_tile<kD>(k_s, kb, p.sk.s, k0, p.seq_k, p.d);
  load_tile<kD>(v_s, vb, p.sv.s, k0, p.seq_k, p.d);
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();

  float dk[kD / 8][4], dv[kD / 8][4];
  zero(dk);
  zero(dv);
  const int n_base = k0 + warp * 16 + g;  // kv rows n_base, n_base + 8

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      prefetch(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int q0 = (first_qt + it % per_head) * kTile;
    const bool masked =
        (p.causal && k0 + kTile - 1 > q0) || q0 + kTile > p.seq_q;
    const bf16* qt_s = q_s + buf * kTileElems;
    const bf16* dot_s = do_s + buf * kTileElems;
    const float* lse_t = lse_s + buf * kTile;
    const float* dl_t = dl_s + buf * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float st[4][4], dpt[4][4];
      zero(st);
      zero(dpt);
      gemm_nt<kD, 4>(st, k_s + warp * 16 * ld, qt_s + half * 32 * ld, lane);
      gemm_nt<kD, 4>(dpt, v_s + warp * 16 * ld, dot_s + half * 32 * ld,
                     lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mi = half * 32 + nt * 8 + 2 * t + (e & 1);  // q row in tile
          float x = st[nt][e] * p.scale;
          if (masked) {
            const int n = n_base + (e >> 1) * 8;
            const int row = q0 + mi;
            if (row >= p.seq_q || (p.causal && n > row)) x = kNegInf;
          }
          const float pe = expf(x - lse_t[mi]);
          st[nt][e] = pe;
          dpt[nt][e] = pe * (dpt[nt][e] - dl_t[mi]) * p.scale;  // dS^T
        }
      }
      uint32_t pa[2][4];
      to_a<4>(pa, st);
      gemm_pv<kD, 2>(dv, pa, dot_s + half * 32 * ld, lane);
      to_a<4>(pa, dpt);
      gemm_pv<kD, 2>(dk, pa, qt_s + half * 32 * ld, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // a block with no q tile still started K/V loads

  const float one[2] = {1.f, 1.f};
  const long long row_stride = static_cast<long long>(p.kh) * p.d;
  const long long base =
      (static_cast<long long>(bi) * p.seq_k * p.kh + kvh) * p.d;
  store_rows<kD>(p.dk + base, row_stride, k0 + warp * 16, p.seq_k, p.d, dk,
                 one, lane);
  store_rows<kD>(p.dv + base, row_stride, k0 + warp * 16, p.seq_k, p.d, dv,
                 one, lane);
}

// ---- launch ---------------------------------------------------------------

constexpr size_t tile_bytes(int kd) {
  return static_cast<size_t>(kTile) * (kd + 8) * sizeof(bf16);
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dims: b, h, kh, seq_q, seq_k, d, causal. strides: (b, s, h) of each
// strided input in the order the entry point names them.
int fill(Params* p, const long long* dims, const long long* strides,
         int n_strided, float scale) {
  p->b = static_cast<int>(dims[0]);
  p->h = static_cast<int>(dims[1]);
  p->kh = static_cast<int>(dims[2]);
  p->seq_q = static_cast<int>(dims[3]);
  p->seq_k = static_cast<int>(dims[4]);
  p->d = static_cast<int>(dims[5]);
  p->causal = static_cast<int>(dims[6]);
  p->scale = scale;
  Strides* s[4] = {&p->sq, &p->sk, &p->sv, &p->sdo};
  for (int i = 0; i < n_strided; ++i)
    *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (p->b < 1 || p->h < 1 || p->kh < 1 || p->h % p->kh != 0 ||
      p->seq_q < 1 || p->seq_k < 1 || p->d < 16 || p->d % 16 != 0 ||
      p->d > 128 || p->b > 65535 || p->h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 on a clean launch.
int dlr_flash_forward(const void* q, const void* k, const void* v, void* out,
                      void* lse, const long long* dims,
                      const long long* strides, float scale, void* stream) {
  Params p = {};
  int rc = fill(&p, dims, strides, 3, scale);
  if (rc) return rc;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  const dim3 grid((p.seq_q + kTile - 1) / kTile, p.h, p.b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.d <= 64)
    return launch(flash_fwd_kernel<64>, grid, 5 * tile_bytes(64), p, s);
  return launch(flash_fwd_kernel<128>, grid, 5 * tile_bytes(128), p, s);
}

int dlr_flash_backward_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, const long long* dims,
                          const long long* strides, float scale,
                          void* stream) {
  Params p = {};
  int rc = fill(&p, dims, strides, 4, scale);
  if (rc) return rc;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  const dim3 grid((p.seq_q + kTile - 1) / kTile, p.h, p.b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.d <= 64)
    return launch(flash_dq_kernel<64>, grid, 6 * tile_bytes(64), p, s);
  return launch(flash_dq_kernel<128>, grid, 6 * tile_bytes(128), p, s);
}

int dlr_flash_backward_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv,
                           const long long* dims, const long long* strides,
                           float scale, void* stream) {
  Params p = {};
  int rc = fill(&p, dims, strides, 4, scale);
  if (rc) return rc;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const dim3 grid((p.seq_k + kTile - 1) / kTile, p.kh, p.b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t stats = 4 * kTile * sizeof(float);
  if (p.d <= 64)
    return launch(flash_dkv_kernel<64>, grid, 6 * tile_bytes(64) + stats, p,
                  s);
  return launch(flash_dkv_kernel<128>, grid, 6 * tile_bytes(128) + stats, p,
                s);
}

const char* dlr_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
