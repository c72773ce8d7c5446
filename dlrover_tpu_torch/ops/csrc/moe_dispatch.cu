// Grouped expert FFN over the expert-sorted MoE dispatch layout: forward
// (B7) and backward (B8: dx, dw_gu, dw_down), written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/moe_dispatch.py:
//   - B7 <- _grouped_ffn_fwd / _fwd_kernel: moe_gate_up_kernel then
//     moe_out_kernel<.., false>;
//   - B8 dx <- _grouped_ffn_bwd / _dx_kernel: moe_dx_gate_up_kernel then
//     moe_out_kernel<.., true>;
//   - B8 dw_gu <- _dw_accum_kernel and dw_down <- _dw_sorted_lhs_kernel:
//     moe_dw_kernel.
// Same math. The layout (ops/moe_dispatch.py build_dispatch_layout) cuts
// the m_pad = T * tile_m sorted slots into tiles of one expert each
// (tile_expert[t]); slot j reads source row row_ids[j] and writes output
// row dest_ids[j], -1 marking padding. Per tile of expert e:
//   h = x[row_ids] @ w_gu[e] (f32 sums of bf16 products), a =
//   bf16(silu(h[:, :f]) * h[:, f:]), y[dest_ids] = bf16(a @ w_down[e]);
//   dx: da = dy[dest_ids] @ w_down[e]^T, dh = bf16(silu-gate backward of
//   (h, da)), dx_c[dest_ids] = bf16(dh @ w_gu[e]^T), and the sorted a and
//   dh are written for the weight gradients;
//   dw_gu[e] = sum over e's tiles of x[row_ids]^T @ dh, dw_down[e] = sum
//   of a^T @ dy[dest_ids], in f32.
// Rows of id -1 read as zeros and are never written.
//
// Bound on the H100: tensor-core operations at the training shape (m =
// 32768 copies, d = f = 1024, 8 experts: B7 6 m d f flops, B8 dx 10 m d
// f, dw_gu 4 m d f, dw_down 2 m d f; 69-347 us at 989 TFLOP/s); at a
// decode step (16 copies) the bytes of the experts' weights. Design,
// simple and right first:
//   - the TPU kernel keeps a 128-row tile and its [128, 2f] hidden in
//     VMEM; a block here has 227 KB of shared memory (a [128, 1024] bf16
//     x tile alone is 256 KB), so each product is a tiled GEMM over
//     K-slices of 32 through a 3-stage cp.async ring, with mma.sync
//     m16n8k16 (bf16 in, f32 accumulate) and ldmatrix, 8 warps;
//   - the forward runs in two launches: a block owns one tile and 64
//     columns of f and computes their gate AND up columns (interleaved
//     8 by 8 in its B tile, so one thread holds h_g and h_u of the same
//     element), writing a in x's dtype; then a block owns one tile and
//     128 columns of d for a @ w_down and scatters its rows. The sorted a
//     makes one extra round trip through memory (2 x 69 MB at the
//     training shape), which the backward needs anyway;
//   - dx likewise: the first launch computes the gathered x @ w_gu and
//     dy @ w_down^T for the same 64 columns of f (the contraction is d
//     for both) and applies the silu-gate backward in registers; the
//     second is the forward's second launch with w_gu read transposed;
//   - the weight gradients: one block per (expert, 128 x 128 output
//     tile) walks that expert's slots in order (the wrapper finds each
//     expert's tile range on the device), so sums run in a fixed order
//     with no atomics and reruns are bitwise equal; an expert with no
//     rows still owns its all-padding tile and writes zeros;
//   - gathers are cp.async 16-byte vectors per row; an id of -1
//     zero-fills; a tile whose ids are all -1 skips its products (the
//     first launches still write its zero a and dh rows, which the
//     weight gradients read).
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch headers,
// so nvcc builds this file in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBK = 32;         // contraction slice of one stage
constexpr int kStages = 3;
constexpr int kBN = 128;        // output columns of a block
constexpr int kBF = 64;         // f columns of a gate|up block (x2: gate, up)
constexpr int kLd = kBK + 8;    // row stride of a [rows][kBK] smem tile
constexpr int kLdN = kBN + 8;   // row stride of a [kBK][kBN] smem tile
constexpr int kMaxTile = 128;

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

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&a)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][j][e] = 0.f;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Warps of a block over a [BM x kBN] output tile: 4 x 2 for 128-row
// tiles, 1 x 8 for 16-row ones; each warp holds MT 16-row mma tiles.
template <int BM>
struct Warps {
  static constexpr int M = BM == 128 ? 4 : 1;
  static constexpr int N = 8 / M;
  static constexpr int MT = BM / M / 16;
  static constexpr int NT = kBN / N / 8;  // 8-column mma tiles of kBN
};

// ---- staging --------------------------------------------------------------
//
// Fragment layout of an m16n8 f32 accumulator c[4] (lane = 4 g + t):
// c[0], c[1] at row g, columns 2t, 2t + 1; c[2], c[3] at row g + 8.

// dst[r][c] = src[row(r)][k0 + c] for r < BM, c < kBK, row(r) = ids[r]
// (ids in shared memory; -1 zero-fills) or row0 + r when ids is null.
template <int BM>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, const int* ids,
                                          long long row0, int k0) {
  constexpr int chunks = kBK / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const long long row = ids ? ids[r] : row0 + r;
    const bool valid = row >= 0;
    const bf16* p = valid ? src + row * ld + k0 + c : src;
    cp_async16(dst + r * kLd + c, p, valid);
  }
}

// A [kBK][kBN] tile of w's rows k0 .. (row stride ldw). kGateUp: chunk j
// (8 columns) holds w's columns (j odd ? f : 0) + c0 + 8 (j / 2), so
// gate and up columns alternate 8 by 8; else columns c0 + 8 j.
template <bool kGateUp>
__device__ __forceinline__ void load_kn(bf16* dst, const bf16* w,
                                        long long ldw, int k0, int c0,
                                        int f) {
  constexpr int chunks = kBN / 8;
  for (int i = threadIdx.x; i < kBK * chunks; i += kThreads) {
    const int r = i / chunks, j = i % chunks;
    const int col = kGateUp ? ((j & 1) ? f : 0) + c0 + (j >> 1) * 8
                            : c0 + j * 8;
    cp_async16(dst + r * kLdN + j * 8, w + (k0 + r) * ldw + col, true);
  }
}

// A [ROWS][kBK] tile: w's rows n0 .. n0 + ROWS, columns k0 .. k0 + kBK.
template <int ROWS>
__device__ __forceinline__ void load_nk(bf16* dst, const bf16* w,
                                        long long ldw, int n0, int k0) {
  constexpr int chunks = kBK / 8;
  for (int i = threadIdx.x; i < ROWS * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    cp_async16(dst + r * kLd + c, w + (n0 + r) * ldw + k0 + c, true);
  }
}

// A [kBK][kBN] tile of slots s0 .. s0 + kBK (slots >= s_end zero-fill):
// row ids[slot] of src (-1 zero-fills) or row slot when ids is null,
// columns col0 .. col0 + kBN.
__device__ __forceinline__ void load_slots(bf16* dst, const bf16* src,
                                           long long ld, const int* ids,
                                           long long s0, long long s_end,
                                           int col0) {
  constexpr int chunks = kBN / 8;
  for (int i = threadIdx.x; i < kBK * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const long long slot = s0 + r;
    long long row = -1;
    if (slot < s_end) row = ids ? ids[slot] : slot;
    const bool valid = row >= 0;
    const bf16* p = valid ? src + row * ld + col0 + c : src;
    cp_async16(dst + r * kLdN + c, p, valid);
  }
}

// ---- warp-level products over one kBK slice -------------------------------

// acc[16 MT x 8 NT] += A . B; A row-major [rows][kLd] from the warp's
// first row, B a [kBK][kLdN] tile from the warp's first column.
template <int MT, int NT>
__device__ __forceinline__ void mma_kn(float (&acc)[MT][NT][4], const bf16* a,
                                       const bf16* b, int lane) {
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(af[mt], a + (mt * 16 + lane % 16) * kLd + kc * 16 +
                              (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, b + (kc * 16 + r + (i % 2) * 8) * kLdN +
                                 nt * 8 + (i / 2) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][nt], af[mt], bfr[0], bfr[1]);
        mma_bf16(acc[mt][nt + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// acc[16 MT x 8 NT] += A . B^T; A as in mma_kn, B^T a [n rows][kLd] tile
// from the warp's first output column (row).
template <int MT, int NT>
__device__ __forceinline__ void mma_nk(float (&acc)[MT][NT][4], const bf16* a,
                                       const bf16* b, int lane) {
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(af[mt], a + (mt * 16 + lane % 16) * kLd + kc * 16 +
                              (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt + 1 < NT; nt += 2) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, b + (nt * 8 + r + (i / 2) * 8) * kLd + kc * 16 +
                           (i % 2) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][nt], af[mt], bfr[0], bfr[1]);
        mma_bf16(acc[mt][nt + 1], af[mt], bfr[2], bfr[3]);
      }
    }
    if (NT % 2) {
      uint32_t bfr[2];
      ldmatrix_x2(bfr, b + ((NT - 1) * 8 + r) * kLd + kc * 16 + (i % 2) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_bf16(acc[mt][NT - 1], af[mt], bfr[0], bfr[1]);
    }
  }
}

// acc[16 MT x 8 NT] += At^T . B; At and B [kBK][kLdN] tiles whose rows
// are the contraction, At from the warp's first output row (column of
// At), B from its first output column.
template <int MT, int NT>
__device__ __forceinline__ void mma_tn(float (&acc)[MT][NT][4],
                                       const bf16* at, const bf16* b,
                                       int lane) {
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    uint32_t bfr[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t q[4];
      ldmatrix_x4_trans(q, b + (kc * 16 + r + (i % 2) * 8) * kLdN + nt * 8 +
                               (i / 2) * 8);
      bfr[nt][0] = q[0];
      bfr[nt][1] = q[1];
      bfr[nt + 1][0] = q[2];
      bfr[nt + 1][1] = q[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, at + (kc * 16 + (lane / 16) * 8 + r) * kLdN +
                                mt * 16 + (i % 2) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], af, bfr[nt][0], bfr[nt][1]);
    }
  }
}

// ---- kernels --------------------------------------------------------------

struct Params {
  const bf16* x;          // [n_src, d]
  const bf16* dy;         // [n_out, d]
  const bf16* w_gu;       // [e, d, 2f]
  const bf16* w_down;     // [e, f, d]
  const int* row_ids;     // [m_pad]
  const int* dest_ids;    // [m_pad]
  const int* tile_expert; // [T]
  bf16* a;                // [m_pad, f]
  bf16* dh;               // [m_pad, 2f]
  bf16* out;              // [n_out, d]: y or dx_c
  int n_src, n_out, d, f, T, tile_m, e;
};

// Loads the tile's ids (and, with dy_ids, the dest ids of its valid rows)
// into shared memory; true if any row of the tile is valid.
template <int BM>
__device__ __forceinline__ bool tile_ids(const Params& p, int tile, int* ids,
                                         int* dy_ids) {
  const int tid = threadIdx.x;
  int id = -1;
  if (tid < BM) {
    id = p.row_ids[tile * BM + tid];
    ids[tid] = id;
    if (dy_ids) dy_ids[tid] = id >= 0 ? p.dest_ids[tile * BM + tid] : -1;
  }
  return __syncthreads_or(id >= 0) != 0;
}

// Zeros in rows of a [m_pad, ld] bf16 matrix: the tile's BM rows,
// columns c0 .. c0 + kBF.
template <int BM>
__device__ __forceinline__ void zero_rows(bf16* dst, long long ld, int tile,
                                          int c0) {
  constexpr int chunks = kBF / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    *reinterpret_cast<uint4*>(dst + (static_cast<long long>(tile) * BM + r) *
                                        ld + c0 + c) = make_uint4(0, 0, 0, 0);
  }
}

// B7, launch 1. Grid (f / kBF, T). a[slot, c0 .. c0 + kBF) =
// bf16(silu(h_g) h_u) with h = x[row_ids] @ w_gu[e] over those columns.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
    moe_gate_up_kernel(Params p) {
  using W = Warps<BM>;
  constexpr int MT = W::MT, NT = W::NT;
  constexpr int kA = BM * kLd, kB = kBK * kLdN;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ids[kMaxTile];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + kStages * kA;

  const int tile = blockIdx.y, c0 = blockIdx.x * kBF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % W::M, wn = warp / W::M;
  if (!tile_ids<BM>(p, tile, ids, nullptr)) {
    zero_rows<BM>(p.a, p.f, tile, c0);
    return;
  }
  const long long ldw = 2LL * p.f;
  const bf16* w =
      p.w_gu + static_cast<long long>(p.tile_expert[tile]) * p.d * ldw;
  const int n_k = p.d / kBK;
  auto load = [&](int it) {
    if (it < n_k) {
      load_rows<BM>(a_s + (it % kStages) * kA, p.x, p.d, ids, 0, it * kBK);
      load_kn<true>(b_s + (it % kStages) * kB, w, ldw, it * kBK, c0, p.f);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  float acc[MT][NT][4];
  zero(acc);
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();  // slice it has landed
    __syncthreads();  // and every warp is done with the stage refilled next
    load(it + kStages - 1);
    const int s = it % kStages;
    mma_kn<MT, NT>(acc, a_s + s * kA + wm * MT * 16 * kLd,
                   b_s + s * kB + wn * NT * 8, lane);
  }
  cp_async_wait<0>();

  // h tiles 2i (gate) and 2i + 1 (up) cover the same f columns.
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long slot =
          static_cast<long long>(tile) * BM + wm * MT * 16 + mt * 16 + g +
          8 * h;
      bf16* out = p.a + slot * p.f + c0 + wn * (NT / 2) * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) {
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float hg = acc[mt][2 * i][2 * h + j];
          v[j] = hg * sigmoid(hg) * acc[mt][2 * i + 1][2 * h + j];
        }
        *reinterpret_cast<uint32_t*>(out + i * 8) = pack_bf16(v[0], v[1]);
      }
    }
  }
}

// B8 dx, launch 1. Grid (f / kBF, T). Over the same 64 columns of f:
// h = x[row_ids] @ w_gu[e] (gate and up), da = dy[dest_ids] @
// w_down[e]^T; writes a = bf16(silu(h_g) h_u) and dh = bf16 of the
// silu-gate backward (gate half at c, up half at f + c).
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
    moe_dx_gate_up_kernel(Params p) {
  using W = Warps<BM>;
  constexpr int MT = W::MT, NT = W::NT, ND = NT / 2;
  constexpr int kA = BM * kLd, kB = kBK * kLdN, kD = kBF * kLd;
  constexpr int kStage = 2 * kA + kB + kD;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ids[kMaxTile], dy_ids[kMaxTile];
  bf16* base = reinterpret_cast<bf16*>(smem);

  const int tile = blockIdx.y, c0 = blockIdx.x * kBF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % W::M, wn = warp / W::M;
  if (!tile_ids<BM>(p, tile, ids, dy_ids)) {
    zero_rows<BM>(p.a, p.f, tile, c0);
    zero_rows<BM>(p.dh, 2LL * p.f, tile, c0);
    zero_rows<BM>(p.dh, 2LL * p.f, tile, p.f + c0);
    return;
  }
  const int e = p.tile_expert[tile];
  const long long ldw = 2LL * p.f;
  const bf16* wgu = p.w_gu + static_cast<long long>(e) * p.d * ldw;
  const bf16* wdn = p.w_down + static_cast<long long>(e) * p.f * p.d;
  const int n_k = p.d / kBK;
  auto load = [&](int it) {
    if (it < n_k) {
      bf16* st = base + (it % kStages) * kStage;
      load_rows<BM>(st, p.x, p.d, ids, 0, it * kBK);
      load_rows<BM>(st + kA, p.dy, p.d, dy_ids, 0, it * kBK);
      load_kn<true>(st + 2 * kA, wgu, ldw, it * kBK, c0, p.f);
      load_nk<kBF>(st + 2 * kA + kB, wdn, p.d, c0, it * kBK);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  float acc[MT][NT][4], dacc[MT][ND][4];
  zero(acc);
  zero(dacc);
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load(it + kStages - 1);
    const bf16* st = base + (it % kStages) * kStage;
    mma_kn<MT, NT>(acc, st + wm * MT * 16 * kLd, st + 2 * kA + wn * NT * 8,
                   lane);
    mma_nk<MT, ND>(dacc, st + kA + wm * MT * 16 * kLd,
                   st + 2 * kA + kB + wn * ND * 8 * kLd, lane);
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long slot =
          static_cast<long long>(tile) * BM + wm * MT * 16 + mt * 16 + g +
          8 * h;
      const int col = c0 + wn * ND * 8 + 2 * t;
      bf16* a_out = p.a + slot * p.f + col;
      bf16* dh_out = p.dh + slot * 2LL * p.f + col;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        float av[2], dg[2], du[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float hg = acc[mt][2 * i][2 * h + j];
          const float hu = acc[mt][2 * i + 1][2 * h + j];
          const float da = dacc[mt][i][2 * h + j];
          const float sg = sigmoid(hg);
          const float silu = hg * sg;
          av[j] = silu * hu;
          du[j] = da * silu;
          dg[j] = da * hu * (sg * (1.f + hg * (1.f - sg)));
        }
        *reinterpret_cast<uint32_t*>(a_out + i * 8) = pack_bf16(av[0], av[1]);
        *reinterpret_cast<uint32_t*>(dh_out + i * 8) =
            pack_bf16(dg[0], dg[1]);
        *reinterpret_cast<uint32_t*>(dh_out + p.f + i * 8) =
            pack_bf16(du[0], du[1]);
      }
    }
  }
}

// B7 launch 2 (kNK false) and B8 dx launch 2 (kNK true). Grid (d / kBN,
// T). out[dest_ids[slot], n0 .. n0 + kBN) = bf16(src[slot] @ B) with
// src the sorted a [m_pad, f] and B = w_down[e] [f, d] (kNK false), or
// src the sorted dh [m_pad, 2f] and B = w_gu[e]^T, read from w_gu[e] [d,
// 2f] (kNK true).
template <int BM, bool kNK>
__global__ void __launch_bounds__(kThreads, 2) moe_out_kernel(Params p) {
  using W = Warps<BM>;
  constexpr int MT = W::MT, NT = W::NT;
  constexpr int kA = BM * kLd;
  constexpr int kB = kNK ? kBN * kLd : kBK * kLdN;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int dest[kMaxTile];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + kStages * kA;

  const int tile = blockIdx.y, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % W::M, wn = warp / W::M;
  const int tid = threadIdx.x;
  int id = -1;
  if (tid < BM) {
    id = p.dest_ids[tile * BM + tid];
    dest[tid] = id;
  }
  if (!__syncthreads_or(id >= 0)) return;

  const int e = p.tile_expert[tile];
  const int K = kNK ? 2 * p.f : p.f;
  const bf16* src = kNK ? p.dh : p.a;
  const bf16* w = kNK ? p.w_gu + e * static_cast<long long>(p.d) * K
                      : p.w_down + e * static_cast<long long>(p.f) * p.d;
  const long long row0 = static_cast<long long>(tile) * BM;
  const int n_k = K / kBK;
  auto load = [&](int it) {
    if (it < n_k) {
      load_rows<BM>(a_s + (it % kStages) * kA, src, K, nullptr, row0,
                    it * kBK);
      if (kNK)
        load_nk<kBN>(b_s + (it % kStages) * kB, w, K, n0, it * kBK);
      else
        load_kn<false>(b_s + (it % kStages) * kB, w, p.d, it * kBK, n0, 0);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  float acc[MT][NT][4];
  zero(acc);
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load(it + kStages - 1);
    const int s = it % kStages;
    const bf16* a = a_s + s * kA + wm * MT * 16 * kLd;
    if (kNK)
      mma_nk<MT, NT>(acc, a, b_s + s * kB + wn * NT * 8 * kLd, lane);
    else
      mma_kn<MT, NT>(acc, a, b_s + s * kB + wn * NT * 8, lane);
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d_row = dest[wm * MT * 16 + mt * 16 + g + 8 * h];
      if (d_row < 0) continue;
      bf16* out = p.out + static_cast<long long>(d_row) * p.d + n0 +
                  wn * NT * 8 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(out + nt * 8) =
            pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
  }
}

struct DwParams {
  const bf16* lhs;       // [lhs_rows, M]
  const bf16* rhs;       // [rhs_rows, N]
  const int* lhs_ids;    // [m_pad] or null (slot order)
  const int* rhs_ids;    // [m_pad] or null
  const int* bounds;     // [E + 1]: expert e's tiles [b[e], b[e + 1])
  float* dw;             // [E, M, N]
  int M, N, tile_m;
};

// B8 dw_gu and dw_down. Grid (N / kBN, M / kBN, E). dw[e] over a
// 128 x 128 tile = sum over e's slots s of lhs[row_l(s)]^T rhs[row_r(s)],
// in slot order.
__global__ void __launch_bounds__(kThreads, 2) moe_dw_kernel(DwParams p) {
  constexpr int MT = 2, NT = 8;  // warps 4 x 2 over 128 x 128
  constexpr int kT = kBK * kLdN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* l_s = reinterpret_cast<bf16*>(smem);
  bf16* r_s = l_s + kStages * kT;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBN, e = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const long long s0 = static_cast<long long>(p.bounds[e]) * p.tile_m;
  const long long s_end = static_cast<long long>(p.bounds[e + 1]) * p.tile_m;
  const int n_k = static_cast<int>((s_end - s0 + kBK - 1) / kBK);
  auto load = [&](int it) {
    if (it < n_k) {
      const long long s = s0 + static_cast<long long>(it) * kBK;
      load_slots(l_s + (it % kStages) * kT, p.lhs, p.M, p.lhs_ids, s, s_end,
                 m0);
      load_slots(r_s + (it % kStages) * kT, p.rhs, p.N, p.rhs_ids, s, s_end,
                 n0);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  float acc[MT][NT][4];
  zero(acc);
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load(it + kStages - 1);
    const int s = it % kStages;
    mma_tn<MT, NT>(acc, l_s + s * kT + wm * MT * 16, r_s + s * kT + wn * NT * 8,
                   lane);
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm * MT * 16 + mt * 16 + g + 8 * h;
      float* out = p.dw + (static_cast<long long>(e) * p.M + row) * p.N + n0 +
                   wn * NT * 8 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(out + nt * 8) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
  }
}

// ---- launch ---------------------------------------------------------------

template <typename Kernel, typename P>
int launch(Kernel kernel, dim3 grid, size_t smem, const P& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

size_t bf16_bytes(long long elems) {
  return static_cast<size_t>(elems) * sizeof(bf16);
}

// dims: n_src, n_out, d, f, T, tile_m, e.
int fill(Params* p, const long long* dims) {
  for (int i = 0; i < 7; ++i)
    if (dims[i] < 1 || dims[i] > (1LL << 30))
      return static_cast<int>(cudaErrorInvalidValue);
  p->n_src = static_cast<int>(dims[0]);
  p->n_out = static_cast<int>(dims[1]);
  p->d = static_cast<int>(dims[2]);
  p->f = static_cast<int>(dims[3]);
  p->T = static_cast<int>(dims[4]);
  p->tile_m = static_cast<int>(dims[5]);
  p->e = static_cast<int>(dims[6]);
  if (p->d % kBN || p->f % kBN || (p->tile_m != 16 && p->tile_m != 128) ||
      p->T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int BM>
size_t gate_up_smem() {
  return bf16_bytes(kStages * (BM * kLd + kBK * kLdN));
}

template <int BM>
size_t dx_gate_up_smem() {
  return bf16_bytes(kStages * (2 * BM * kLd + kBK * kLdN + kBF * kLd));
}

template <int BM, bool kNK>
size_t out_smem() {
  return bf16_bytes(kStages * (BM * kLd + (kNK ? kBN * kLd : kBK * kLdN)));
}

template <int BM>
int forward(const Params& p, cudaStream_t stream) {
  int rc = launch(moe_gate_up_kernel<BM>, dim3(p.f / kBF, p.T),
                  gate_up_smem<BM>(), p, stream);
  if (rc) return rc;
  return launch(moe_out_kernel<BM, false>, dim3(p.d / kBN, p.T),
                out_smem<BM, false>(), p, stream);
}

template <int BM>
int backward_dx(const Params& p, cudaStream_t stream) {
  int rc = launch(moe_dx_gate_up_kernel<BM>, dim3(p.f / kBF, p.T),
                  dx_gate_up_smem<BM>(), p, stream);
  if (rc) return rc;
  return launch(moe_out_kernel<BM, true>, dim3(p.d / kBN, p.T),
                out_smem<BM, true>(), p, stream);
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code; 0 on a clean launch.

int dlr_moe_forward(const void* x, const void* w_gu, const void* w_down,
                    const void* row_ids, const void* dest_ids,
                    const void* tile_expert, void* a, void* y,
                    const long long* dims, void* stream) {
  Params p = {};
  int rc = fill(&p, dims);
  if (rc) return rc;
  p.x = static_cast<const bf16*>(x);
  p.w_gu = static_cast<const bf16*>(w_gu);
  p.w_down = static_cast<const bf16*>(w_down);
  p.row_ids = static_cast<const int*>(row_ids);
  p.dest_ids = static_cast<const int*>(dest_ids);
  p.tile_expert = static_cast<const int*>(tile_expert);
  p.a = static_cast<bf16*>(a);
  p.out = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.tile_m == 128 ? forward<128>(p, s) : forward<16>(p, s);
}

int dlr_moe_backward_dx(const void* x, const void* dy, const void* w_gu,
                        const void* w_down, const void* row_ids,
                        const void* dest_ids, const void* tile_expert,
                        void* dx_c, void* dh, void* a, const long long* dims,
                        void* stream) {
  Params p = {};
  int rc = fill(&p, dims);
  if (rc) return rc;
  p.x = static_cast<const bf16*>(x);
  p.dy = static_cast<const bf16*>(dy);
  p.w_gu = static_cast<const bf16*>(w_gu);
  p.w_down = static_cast<const bf16*>(w_down);
  p.row_ids = static_cast<const int*>(row_ids);
  p.dest_ids = static_cast<const int*>(dest_ids);
  p.tile_expert = static_cast<const int*>(tile_expert);
  p.out = static_cast<bf16*>(dx_c);
  p.dh = static_cast<bf16*>(dh);
  p.a = static_cast<bf16*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.tile_m == 128 ? backward_dx<128>(p, s) : backward_dx<16>(p, s);
}

// dims: M, N, m_pad, tile_m, E, lhs_rows, rhs_rows.
int dlr_moe_backward_dw(const void* lhs, const void* rhs, const void* lhs_ids,
                        const void* rhs_ids, const void* bounds, void* dw,
                        const long long* dims, void* stream) {
  for (int i = 0; i < 7; ++i)
    if (dims[i] < 1 || dims[i] > (1LL << 30))
      return static_cast<int>(cudaErrorInvalidValue);
  DwParams p = {};
  p.lhs = static_cast<const bf16*>(lhs);
  p.rhs = static_cast<const bf16*>(rhs);
  p.lhs_ids = static_cast<const int*>(lhs_ids);
  p.rhs_ids = static_cast<const int*>(rhs_ids);
  p.bounds = static_cast<const int*>(bounds);
  p.dw = static_cast<float*>(dw);
  p.M = static_cast<int>(dims[0]);
  p.N = static_cast<int>(dims[1]);
  p.tile_m = static_cast<int>(dims[3]);
  const int n_groups = static_cast<int>(dims[4]);
  // Slots read without ids must exist in their operand (the sorted a or
  // dh has m_pad rows).
  if (p.M % kBN || p.N % kBN || (p.tile_m != 16 && p.tile_m != 128) ||
      n_groups > 65535 || (!lhs_ids && dims[5] < dims[2]) ||
      (!rhs_ids && dims[6] < dims[2]))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(moe_dw_kernel, dim3(p.N / kBN, p.M / kBN, n_groups),
                bf16_bytes(2LL * kStages * kBK * kLdN), p,
                static_cast<cudaStream_t>(stream));
}

const char* dlr_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
