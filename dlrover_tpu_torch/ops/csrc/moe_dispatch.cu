// Grouped expert FFN over the expert-sorted MoE dispatch layout: forward
// (B7) and backward (B8: dx, dw_gu, dw_down), written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/moe_dispatch.py:
//   - B7 <- _grouped_ffn_fwd / _fwd_kernel: moe_ffn_kernel<.., kFfnGateUp>
//     then moe_ffn_kernel<.., kFfnDown>;
//   - B8 dx <- _grouped_ffn_bwd / _dx_kernel: moe_dx_gate_up_kernel then
//     moe_ffn_kernel<.., kFfnDownNK>;
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
// decode step (16 copies) the bytes of the experts' weights. Design:
//   - the TPU kernel keeps a 128-row tile and its [128, 2f] hidden in
//     VMEM; a block here has 227 KB of shared memory (a [128, 2f] bf16
//     hidden tile alone is 512 KB at f = 1024), so the forward runs in
//     two launches on one TMA + wgmma grouped-GEMM body (see "B7" below):
//     the gathered x @ w_gu with silu(h_g) h_u in registers, writing the
//     sorted a in x's dtype, then a @ w_down scattered to dest_ids. The
//     sorted a makes one extra round trip through memory (2 x 69 MB at
//     the training shape), which the backward needs anyway;
//   - dx: the first launch (the first design: cp.async K-slices of 32
//     through a 3-stage ring, mma.sync m16n8k16 with ldmatrix, 8 warps)
//     computes the gathered x @ w_gu and dy @ w_down^T for the same 64
//     columns of f and applies the silu-gate backward in registers; the
//     second is the forward's second launch on the same body with w_gu
//     read transposed;
//   - the weight gradients run on Hopper's own path (TMA, wgmma,
//     warp specialisation; see "B8 dw" below): persistent blocks take
//     (expert, output tile) units, experts with the most rows first
//     (ranked from the wrapper's tile ranges on the device), and each
//     unit walks its expert's slots in order, so sums run in a fixed
//     order with no atomics and reruns are bitwise equal; an expert with
//     no rows writes zeros;
//   - gathered rows come by cp.async 16-byte vectors and one-row TMA
//     boxes; an id of -1 zero-fills; a tile whose ids are all -1 skips
//     its products (the first launches still write its zero a and dh
//     rows, which the weight gradients read).
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch headers,
// so nvcc builds this file in seconds.

#include <cuda.h>
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

// dst[r][c] = src[ids[r]][k0 + c] for r < BM, c < kBK (ids in shared
// memory; -1 zero-fills).
template <int BM>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, const int* ids,
                                          int k0) {
  constexpr int chunks = kBK / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const long long row = ids[r];
    const bool valid = row >= 0;
    const bf16* p = valid ? src + row * ld + k0 + c : src;
    cp_async16(dst + r * kLd + c, p, valid);
  }
}

// A [kBK][kBN] tile of w's rows k0 .. (row stride ldw): chunk j (8
// columns) holds w's columns (j odd ? f : 0) + c0 + 8 (j / 2), so gate
// and up columns alternate 8 by 8.
__device__ __forceinline__ void load_kn(bf16* dst, const bf16* w,
                                        long long ldw, int k0, int c0,
                                        int f) {
  constexpr int chunks = kBN / 8;
  for (int i = threadIdx.x; i < kBK * chunks; i += kThreads) {
    const int r = i / chunks, j = i % chunks;
    const int col = ((j & 1) ? f : 0) + c0 + (j >> 1) * 8;
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
      load_rows<BM>(st, p.x, p.d, ids, it * kBK);
      load_rows<BM>(st + kA, p.dy, p.d, dy_ids, it * kBK);
      load_kn(st + 2 * kA, wgu, ldw, it * kBK, c0, p.f);
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

// ---- B8 dw: TMA + wgmma, warp-specialised, persistent ----------------------
//
// dw[e] = sum over e's slots s of lhs[row_l(s)]^T rhs[row_r(s)]: both
// operands are read along the slots, so both sit MN-major in shared
// memory (wgmma's transpose bits). One operand is in slot order (the
// sorted dh or a) and arrives by TMA in [64 slots x 64 columns] boxes.
// The other is gathered by ids (x by row_ids, dy by dest_ids), which
// TMA cannot do; the producer's 128 threads load each of its rows'
// 64-column segments by both routes at once (gather_stage): some as
// [1 row x 64 columns] TMA boxes at the row the id names (the 128-byte
// swizzle follows the shared-memory address, so a row lands where a
// [64 x 64] box would put it; row -1 is zero-filled), the others as
// eight 16-byte cp.async written into the same swizzle, whose arrival on
// the stage's full barrier fires when they land
// (cp.async.mbarrier.arrive.noinc; the consumers fence the async proxy
// before wgmma reads them). The gathered rows bound the kernel, so the
// tile is shaped to fetch each as few times as the registers allow:
// [128 x 256] for dw_gu (x's rows, 128 columns, once per 256 columns of
// dh; [64 x 512] halves the fetches but doubles dh's, and ran slower),
// [256 x 128] for dw_down (dy's rows, 128 columns, once per 256 rows of
// a), else [128 x 256] or [128 x 128]. Pairs of blocks sharing each
// gathered row by TMA multicast also ran slower (the pair waits on its
// slower block).
//
// A unit is one [kTileM x kTileN] tile of one expert's dw; the block
// walks the expert's slots in stages of 64, in order, and owns the tile
// alone, so there are no atomics on dw and reruns are bitwise equal.
// Blocks are persistent (one an SM) and take units from a work counter
// (an int the wrapper zeroes), experts with the most slots first (the
// order is ranked from `bounds` in the kernel: nothing is read back to
// the host). Under skew the heavy expert's units start first and the
// others fill the remaining SMs; whichever block takes a unit computes
// the same bits.
//
// 384 threads: warpgroups 0 and 1 are consumers, each with a
// [kWM x kWN] f32 accumulator (16384 elements, 128 a thread) in
// registers (setmaxnreg.inc kConsumerRegs); warpgroup 2 is the producer
// (setmaxnreg.dec). A ring of stages, each the lhs tile [64 slots x
// kTileM] and the rhs tile [64 slots x kTileN] as 1024-byte-aligned
// boxes of [64 slots x 64 columns]; full barriers count the producer's
// 128 threads (thread 0 adds the stage's TMA bytes), empty barriers one
// arrival per consumer warp. Each stage carries its unit and flags
// (first, last, no slots) for the consumers, who keep one stage's
// products in flight behind the next. The consumers' barrier waits carry
// no trap (a trap in their path makes ptxas ignore setmaxnreg); they
// give up after ~2^32 cycles, and the producer keeps watch, trapping,
// until every stage is released.

constexpr int kDwThreads = 384;
constexpr int kDwK = 64;           // slots of a stage
constexpr int kBox = kDwK * 128;   // one [64 slots x 64 columns] box
constexpr int kDwMaxGroups = 1024;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// A [kTileM x kTileN] unit; the two consumer warpgroups split it along M.
template <int kTileM, int kTileN>
struct DwCfg {
  static constexpr int kWM = kTileM / 2, kWN = kTileN;
  static_assert(kWM % 64 == 0 && kWN % 128 == 0 && kWM * kWN <= 16384,
                "warpgroup tile");
  static constexpr int kABytes = (kTileM / 64) * kBox;
  static constexpr int kBBytes = (kTileN / 64) * kBox;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kStageBytes <= 6 * kBox ? 4 : 3;
  static constexpr int kBars = kStages * kStageBytes;
  // Barriers (full, empty), the stages' unit and flags, the unit
  // broadcast slots and the expert order.
  static constexpr int kSmem =
      1024 + kBars + 16 * kStages + 16 * kStages + 16 + 4 * kDwMaxGroups;
};

struct DwParams {
  const bf16* gathered;  // [rows, width]: lhs or rhs, rows gathered by ids
  const int* ids;        // [m_pad], -1 on padding
  const int* bounds;     // [E + 1]: expert e's tiles [b[e], b[e + 1])
  int* next_unit;        // work counter, 0 at launch
  float* dw;             // [E, M, N]
  int M, N, tile_m, n_groups;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Adds to the transaction count of the current phase without arriving.
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The producer's wait: one that outlasts ~2^35 cycles (a lost TMA
// completion or arrival) traps, so a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
}

// The consumers' wait: no trap (see above). After ~2^32 cycles it gives
// up and clears `live`, and a thread that has given up waits no more,
// so a fault ends the launch with wrong sums instead of a hang.
__device__ __forceinline__ void mbar_spin(uint32_t bar, int parity,
                                          bool& live) {
  if (!live || mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) {
      live = false;
      return;
    }
}

// One [64 rows x 64 columns] box of a 2-D (columns, rows) tensor map at
// (col, row); rows past the tensor are zero-filled.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// 16-byte cp.async to a shared-memory address; valid == false
// zero-fills and reads nothing.
__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The producer warpgroup's own barrier (id 3, 128 threads).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 3, 128;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), and
// the swizzle mode in bits 62-63. MN-major: the leading offset steps 64
// elements of M or N (one box), the stride offset 8 rows of K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// Pins accumulator registers after a wait: the compiler may not move
// their uses above it.
template <int NT>
__device__ __forceinline__ void fence_operands(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(a[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B MN-major in shared
// memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tt_n128(float (&d)[16][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Of every 8 row segments of a gathered tile, kLsuRows go by 16-byte
// cp.async (the load/store path) and the rest by TMA: the two run side
// by side, and TMA alone spends ~25 cycles a one-row box. 6 of 8 ran
// fastest of the nine splits tools/torch_dw_probe.py times (PERF.md).
constexpr int kLsuRows = 6;

// The gathered tile of one stage: rows ids[s + r] (r < kRows; slots
// past s_end and ids of -1 read as zeros) of the gathered tensor, columns
// col0 .. col0 + kCols, at row r of the tile's [kRows x 64] boxes, each
// [1 row x 64 columns] segment by TMA (row -1 is zero-filled) or by
// eight 16-byte cp.async written into the same 128-byte swizzle
// (chunk j of row r at chunk j ^ (r % 8)). Producer thread pt of 128
// issues its segments; pt 0 counts the TMA bytes of the stage.
template <int kRows, int kCols>
__device__ __forceinline__ void gather_stage(uint32_t dst,
                                             const CUtensorMap* map,
                                             const bf16* src, int ld,
                                             uint32_t bar, const int* ids,
                                             long long s, long long s_end,
                                             int col0, int pt) {
  constexpr int kRowBoxes = kRows * (kCols / 64);
  for (int i = pt; i < kRowBoxes; i += 128) {
    const int r = i % kRows, bx = i / kRows;
    const long long slot = s + r;
    const int row = slot < s_end ? ids[slot] : -1;
    const uint32_t at = dst + bx * kRows * 128 + r * 128;
    if (i % 8 < kLsuRows) {
      const bf16* from =
          src + (row >= 0 ? static_cast<long long>(row) * ld + col0 + 64 * bx
                          : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cp_async16_to(at + ((j ^ (r % 8)) << 4), from + 8 * j, row >= 0);
    } else {
      tma_load_2d(at, map, bar, col0 + 64 * bx, row);
    }
  }
}

// Bytes of a stage's gathered tile that arrive by TMA.
template <int kRows, int kCols>
__host__ __device__ constexpr int gathered_tma_bytes() {
  return (kRows * (kCols / 64) / 8) * (8 - kLsuRows) * 128;
}

template <bool kGatherLhs, int kTileM, int kTileN>
__global__ void __launch_bounds__(kDwThreads, 1)
    moe_dw_kernel(const __grid_constant__ CUtensorMap map_sorted,
                  const __grid_constant__ CUtensorMap map_gathered,
                  const DwParams p) {
  using Cfg = DwCfg<kTileM, kTileN>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  auto a_s = [&](int st) { return base + st * Cfg::kStageBytes; };
  auto b_s = [&](int st) { return a_s(st) + Cfg::kABytes; };
  const uint32_t bars = base + Cfg::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  int4* meta = reinterpret_cast<int4*>(gbase + Cfg::kBars + 16 * kStages);
  int* sched = reinterpret_cast<int*>(meta + kStages);
  int* order = sched + 4;

  const int n_n = p.N / kTileN, per_group = (p.M / kTileM) * n_n;
  const int n_units = p.n_groups * per_group;
  // The experts by slot count, most first (ties by index).
  for (int e = threadIdx.x; e < p.n_groups; e += kDwThreads) {
    const int ce = p.bounds[e + 1] - p.bounds[e];
    int rank = 0;
    for (int o = 0; o < p.n_groups; ++o) {
      const int co = p.bounds[o + 1] - p.bounds[o];
      rank += co > ce || (co == ce && o < e);
    }
    order[rank] = e;
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 128);  // the producer's threads, with their bytes
      mbar_init(empty(st), 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Unit u: expert order[u / per_group], tile (m0, n0) of its dw.
  auto decode = [&](int u, int& e, int& m0, int& n0) {
    e = order[u / per_group];
    const int t = u % per_group;
    m0 = (t / n_n) * kTileM;
    n0 = (t % n_n) * kTileN;
  };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - 256;
    int g = 0;  // stages issued
    for (int i = 0;; ++i) {
      if (pt == 0) sched[i & 1] = atomicAdd(p.next_unit, 1);
      producer_sync();
      const int u = sched[i & 1];
      const bool done = u >= n_units;
      int e = 0, m0 = 0, n0 = 0, n_k = 1;
      long long s0 = 0, s_end = 0;
      if (!done) {
        decode(u, e, m0, n0);
        s0 = static_cast<long long>(p.bounds[e]) * p.tile_m;
        s_end = static_cast<long long>(p.bounds[e + 1]) * p.tile_m;
        n_k = max(1, static_cast<int>((s_end - s0 + kDwK - 1) / kDwK));
      }
      // done: one stage of unit -1 tells the consumers to stop.
      for (int k = 0; k < n_k; ++k, ++g) {
        const int st = g % kStages;
        if (g >= kStages) mbar_wait(empty(st), (g / kStages - 1) & 1);
        const long long s = s0 + static_cast<long long>(k) * kDwK;
        const bool has = !done && s < s_end;
        if (pt == 0) {
          meta[st] = make_int4(done ? -1 : u,
                               (k == 0) | ((k == n_k - 1) << 1) | (!has << 2),
                               0, 0);
          if (has) {
            constexpr int kBytes = kGatherLhs ? Cfg::kBBytes : Cfg::kABytes;
            const uint32_t dst = kGatherLhs ? b_s(st) : a_s(st);
            const int col0 = kGatherLhs ? n0 : m0;
            mbar_expect_tx_only(
                full(st),
                kBytes + gathered_tma_bytes<kDwK, kGatherLhs ? kTileM : kTileN>());
            for (int bx = 0; bx < kBytes / kBox; ++bx)
              tma_load_2d(dst + bx * kBox, &map_sorted, full(st),
                          col0 + 64 * bx, static_cast<int>(s));
          }
        }
        if (has) {
          if (kGatherLhs)
            gather_stage<kDwK, kTileM>(a_s(st), &map_gathered, p.gathered, p.M,
                                 full(st), p.ids, s, s_end, m0, pt);
          else
            gather_stage<kDwK, kTileN>(b_s(st), &map_gathered, p.gathered, p.N,
                                 full(st), p.ids, s, s_end, n0, pt);
        }
        // This thread's arrival, once its cp.async copies have landed.
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                full(st))
            : "memory");
      }
      if (done) break;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (pt == 0)  // the watch
      for (int j = max(0, g - kStages); j < g; ++j)
        mbar_wait(empty(j % kStages), (j / kStages) & 1);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    // This warpgroup's [kWM x kWN], rows mo .. of the unit: kH products
    // m64n128, (mi, ni) over the rows and columns.
    constexpr int kMi = Cfg::kWM / 64, kNi = Cfg::kWN / 128, kH = kMi * kNi;
    const int mo = c * Cfg::kWM;
    float acc[kH][16][4];
    bool live = true;
    int held = -1;  // the stage whose products may still be running
    for (int g = 0;; ++g) {
      const int st = g % kStages;
      mbar_spin(full(st), (g / kStages) & 1, live);
      const int4 mt = meta[st];
      if (mt.x < 0 || !live) {
        if (lane == 0) mbar_arrive(empty(st));
        break;
      }
      const bool first = mt.y & 1, last = mt.y & 2, none = mt.y & 4;
      if (!none) {
        // Part of the gathered tile came through the generic proxy
        // (cp.async); wgmma reads through the async proxy.
        fence_proxy_async();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDwK / 16; ++kk)
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNi; ++ni)
              wgmma_tt_n128(
                  acc[mi * kNi + ni],
                  smem_desc(a_s(st) + (mo / 64 + mi) * kBox + kk * 2048, kBox,
                            1024),
                  smem_desc(b_s(st) + 2 * ni * kBox + kk * 2048,
                            kBox, 1024),
                  !(first && kk == 0));
        wgmma_commit();
        // The previous stage's products are done: release its stage.
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(empty(held));
        held = st;
      } else if (lane == 0) {
        mbar_arrive(empty(st));
      }
      if (last) {
        wgmma_wait<0>();
        if (held >= 0 && lane == 0) mbar_arrive(empty(held));
        held = -1;
        int e, m0, n0;
        decode(mt.x, e, m0, n0);
        const int g8 = lane / 4, t = lane % 4;
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long row =
                m0 + mo + 64 * mi + 16 * warp + g8 + 8 * r;
            float* out = p.dw +
                         (static_cast<long long>(e) * p.M + row) * p.N + n0 +
                         2 * t;
#pragma unroll
            for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
              for (int nt = 0; nt < 16; ++nt) {
                const float(&a)[16][4] = acc[mi * kNi + ni];
                *reinterpret_cast<float2*>(out + 128 * ni + 8 * nt) =
                    none ? make_float2(0.f, 0.f)
                         : make_float2(a[nt][2 * r], a[nt][2 * r + 1]);
              }
          }
      }
    }
  }
}

// ---- B7 and B8 dx's second launch: TMA + wgmma grouped GEMM ----------------
//
// One warp-specialised body for three products over the sorted layout,
// each unit a [BM slots x kBN columns] output tile of one row tile:
//   - kFfnGateUp (B7, launch 1): A = x[row_ids] (gathered by gather_stage,
//     an id of -1 zero-fills), B = w_gu[e] read MN-major as two column
//     blocks, gate at c0 and up at f + c0, so that one thread holds h_g
//     and h_u of the same element; writes the sorted a = bf16(silu(h_g)
//     h_u) (an all-padding tile writes its zero rows: the weight
//     gradients read them);
//   - kFfnDown (B7, launch 2): A = the sorted a by TMA, B = w_down[e]
//     MN-major; rows scatter to dest_ids (-1: not written);
//   - kFfnDownNK (B8 dx, launch 2): A = the sorted dh [m_pad, 2f], B =
//     w_gu[e]^T read K-major from w_gu[e] [d, 2f] (one [kBN x 64] box).
// A arrives K-major in the 128-byte swizzle, 64 columns of K a stage.
//
// BM 128 (training): 384 threads, two consumer warpgroups of 64 rows
// each (setmaxnreg.inc kConsumerRegs), each holding [64 x 256] f32 as
// two m64n128 accumulators; a producer warpgroup (setmaxnreg.dec) keeps
// a ring of 4 stages of [128 x 64] A and [64 x 256] B (48 KB each) in
// flight. BM 16 (a decode step): the same body at 256 threads and two
// blocks an SM, one consumer warpgroup whose m64 products carry the
// tile's 16 rows (rows 16-63 of its A window are never stored: a row of
// the product depends on its own row of A only) over [16 x 128]
// units: the step is bound by the experts' weight bytes, which more
// units in flight stream faster.
//
// Blocks are persistent and take units u = blockIdx.x + i gridDim.x in
// order (the n-blocks of a row tile, then the next tile): the blocks in
// flight share their tiles' rows and their expert's weights in L2. Every
// unit has one owner and sums its K in order: no atomics, reruns are
// bitwise equal. The producer reads the tile's ids (a bar.red.or over
// its warpgroup) and sends a tile without a valid row as one stage
// flagged empty: no loads, no products. Consumers' waits carry no trap
// (see B8 dw); the producer's trap and keep watch at the end.

enum FfnMode { kFfnGateUp = 0, kFfnDown = 1, kFfnDownNK = 2 };
// The gathering producer needs more than B8 dw's 40 registers (it
// spills at 40); 2 x 128 x 224 + 128 x 56 fit the SM's 65536.
constexpr int kFfnProducerRegs = 56, kFfnConsumerRegs = 224;

template <int BM>
struct FfnCfg {
  static constexpr int kConsumers = BM == 128 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kMinBlocks = BM == 128 ? 1 : 2;
  static constexpr int kBN = BM == 128 ? 256 : 128;  // columns of a unit
  static constexpr int kHalf = kBN / 2;              // of one product
  static constexpr int kABytes = (BM < 64 ? 64 : BM) * 128;  // rows read
  static constexpr int kBBytes = kBN * 128;          // [64 K x kBN]
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 4;
  static constexpr int kBars = kStages * kStageBytes;
  // Barriers (full, empty) and the stages' unit and flags.
  static constexpr int kSmem = 1024 + kBars + 16 * kStages + 8 * kStages;
};

// True on every thread of the producer warpgroup (named barrier 3) if
// any of its threads passes true.
__device__ __forceinline__ bool producer_any(bool v) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, 3, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"(static_cast<uint32_t>(v))
      : "memory");
  return out != 0;
}

// Stores 4 bytes at dst if keep: a predicated st.global, no branch.
__device__ __forceinline__ void store_if(bf16* dst, uint32_t v, bool keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n"
      "@p st.global.b32 [%0], %1;\n}\n" ::"l"(dst),
      "r"(v), "r"(static_cast<uint32_t>(keep))
      : "memory");
}

// d[64 x 8 NT] (+)= A[64 x 16] . B[16 x 8 NT], A K-major and B MN-major
// (kTransB 1) or K-major (0) in shared memory; scale_d = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// Units of one launch: row tiles x column blocks (gate|up: kHalf columns
// of f, each for gate and up; the down products: kBN columns of d, the
// last block partly past d when d is not a multiple of kBN).
template <int BM, int kMode>
__host__ __device__ __forceinline__ int ffn_col_blocks(const Params& p) {
  using Cfg = FfnCfg<BM>;
  return kMode == kFfnGateUp ? p.f / Cfg::kHalf
                          : (p.d + Cfg::kBN - 1) / Cfg::kBN;
}

template <int BM, int kMode>
__global__ void __launch_bounds__(FfnCfg<BM>::kThreads,
                                  FfnCfg<BM>::kMinBlocks)
    moe_ffn_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const Params p) {
  using Cfg = FfnCfg<BM>;
  constexpr int kStages = Cfg::kStages, kHalf = Cfg::kHalf;
  constexpr int kNT = kHalf / 8;
  constexpr bool kGather = kMode == kFfnGateUp;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  auto a_s = [&](int st) { return base + st * Cfg::kStageBytes; };
  auto b_s = [&](int st) { return a_s(st) + Cfg::kABytes; };
  const uint32_t bars = base + Cfg::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  int2* meta = reinterpret_cast<int2*>(gbase + Cfg::kBars + 16 * kStages);

  const int K = kMode == kFfnGateUp ? p.d : kMode == kFfnDown ? p.f : 2 * p.f;
  const int n_k = K / 64;
  const int n_n = ffn_col_blocks<BM, kMode>(p);
  const int n_units = p.T * n_n;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 128);  // the producer's threads, with their bytes
      mbar_init(empty(st), 4 * Cfg::kConsumers);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == Cfg::kConsumers) {
    if constexpr (Cfg::kConsumers == 2) setmaxnreg_dec<kFfnProducerRegs>();
    const int pt = threadIdx.x - 128 * Cfg::kConsumers;
    const int* ids = kGather ? p.row_ids : p.dest_ids;
    int g = 0;  // stages issued
    for (int u = blockIdx.x;; u += gridDim.x) {
      const bool done = u >= n_units;
      const int tile = done ? 0 : u / n_n, nb = done ? 0 : u % n_n;
      const long long s0 = static_cast<long long>(tile) * BM;
      const bool has = producer_any(!done && pt < BM && ids[s0 + pt] >= 0);
      const int e = has ? p.tile_expert[tile] : 0;
      const int steps = has ? n_k : 1;
      // done: one stage of unit -1 tells the consumers to stop.
      for (int k = 0; k < steps; ++k, ++g) {
        const int st = g % kStages;
        if (g >= kStages) mbar_wait(empty(st), (g / kStages - 1) & 1);
        if (pt == 0) {
          meta[st] = make_int2(done ? -1 : u, (k == 0) |
                                                  ((k == steps - 1) << 1) |
                                                  (!has << 2));
          if (has) {
            const int k0 = 64 * k;
            if constexpr (kMode == kFfnGateUp) {
              mbar_expect_tx_only(
                  full(st), Cfg::kBBytes + gathered_tma_bytes<BM, 64>());
              const int c0 = nb * kHalf;
              for (int bx = 0; bx < Cfg::kBN / 64; ++bx) {
                const int h = bx / (kHalf / 64), j = bx % (kHalf / 64);
                tma_load_2d(b_s(st) + bx * kBox, &map_b, full(st),
                            h * p.f + c0 + 64 * j, e * p.d + k0);
              }
            } else {
              mbar_expect_tx_only(full(st), BM * 128 + Cfg::kBBytes);
              tma_load_2d(a_s(st), &map_a, full(st), k0,
                          static_cast<int>(s0));
              const int n0 = nb * Cfg::kBN;
              if constexpr (kMode == kFfnDown) {
                for (int bx = 0; bx < Cfg::kBN / 64; ++bx)
                  tma_load_2d(b_s(st) + bx * kBox, &map_b, full(st),
                              n0 + 64 * bx, e * p.f + k0);
              } else {  // one [kBN rows of w_gu[e] x 64] box
                tma_load_2d(b_s(st), &map_b, full(st), k0, e * p.d + n0);
              }
            }
          }
        }
        if constexpr (kGather) {
          if (has)
            gather_stage<BM, 64>(a_s(st), &map_a, p.x, p.d, full(st),
                                 p.row_ids, s0, s0 + BM, 64 * k, pt);
        }
        // This thread's arrival, once its cp.async copies have landed.
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                full(st))
            : "memory");
      }
      if (done) break;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (pt == 0)  // the watch
      for (int j = max(0, g - kStages); j < g; ++j)
        mbar_wait(empty(j % kStages), (j / kStages) & 1);
  } else {
    if constexpr (Cfg::kConsumers == 2) setmaxnreg_inc<kFfnConsumerRegs>();
    const int c = wg;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const uint32_t a_row = BM == 128 ? c * 64 * 128 : 0;  // the WG's rows
    float acc[2][kNT][4];
    bool live = true;
    int held = -1;  // the stage whose products may still be running
    for (int g = 0;; ++g) {
      const int st = g % kStages;
      mbar_spin(full(st), (g / kStages) & 1, live);
      const int2 mt = meta[st];
      if (mt.x < 0 || !live) {
        if (lane == 0) mbar_arrive(empty(st));
        break;
      }
      const bool first = mt.y & 1, last = mt.y & 2, none = mt.y & 4;
      if (!none) {
        // Part of a gathered tile came through the generic proxy
        // (cp.async); wgmma reads through the async proxy.
        if constexpr (kGather) fence_proxy_async();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da =
              smem_desc(a_s(st) + a_row + kk * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (kMode == kFfnDownNK)
              wgmma_ss<0>(acc[h], da,
                          smem_desc(b_s(st) + h * kHalf * 128 + kk * 32, 16,
                                    1024),
                          !(first && kk == 0));
            else
              wgmma_ss<1>(acc[h], da,
                          smem_desc(b_s(st) + h * (kHalf / 64) * kBox +
                                        kk * 2048,
                                    kBox, 1024),
                          !(first && kk == 0));
          }
        }
        wgmma_commit();
        // The previous stage's products are done: release its stage.
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(empty(held));
        held = st;
      } else if (lane == 0) {
        mbar_arrive(empty(st));
      }
      if (!last) continue;
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) fence_operands(acc[h]);
      if (held >= 0 && lane == 0) mbar_arrive(empty(held));
      held = -1;
      const int tile = mt.x / n_n, nb = mt.x % n_n;
      const int g8 = lane / 4, t = lane % 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (BM == 128 ? 64 * c : 0) + 16 * warp + g8 + 8 * r;
        const long long slot = static_cast<long long>(tile) * BM + row;
        // Stores under a predicate, not a branch around the accumulator
        // reads (which makes ptxas serialise the products): at BM 16
        // only the first warp's rows are the tile's; dest -1 is padding.
        if constexpr (kMode == kFfnGateUp) {
          const bool keep = row < BM;
          bf16* out = p.a + (keep ? slot : 0) * p.f + nb * kHalf + 2 * t;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            float v[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float hg = acc[0][nt][2 * r + j];
              v[j] = hg * sigmoid(hg) * acc[1][nt][2 * r + j];
            }
            store_if(out + 8 * nt, none ? 0u : pack_bf16(v[0], v[1]), keep);
          }
        } else {
          const int dest = row < BM && !none ? p.dest_ids[slot] : -1;
          const int n0 = nb * Cfg::kBN;
          bf16* out = p.out + static_cast<long long>(max(dest, 0)) * p.d +
                      n0 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              store_if(out + h * kHalf + 8 * nt,
                       pack_bf16(acc[h][nt][2 * r], acc[h][nt][2 * r + 1]),
                       dest >= 0 && n0 + h * kHalf < p.d);
        }
      }
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
size_t dx_gate_up_smem() {
  return bf16_bytes(kStages * (2 * BM * kLd + kBK * kLdN + kBF * kLd));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: taken through the runtime's
// entry-point query, so the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D (cols, rows) map of a row-major [rows, cols] bf16 tensor (cols a
// multiple of 8), boxes of [box_rows x 64 columns] in the 128-byte
// swizzle; rows outside [0, rows) are zero-filled.
int tensor_map_2d(CUtensorMap* map, const void* ptr, long long cols,
                  long long rows, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// B7's launches and B8 dx's second one: the operands' maps (A: x's rows
// as one-row boxes, or the sorted a / dh in [BM x 64] boxes; B: the
// experts' weights in [64 x 64] boxes, or w_gu's rows in [kBN x 64]
// boxes), then one persistent block an SM (two at BM 16), at most one a
// unit.
template <int BM, int kMode>
int launch_ffn(const Params& p, cudaStream_t stream) {
  using Cfg = FfnCfg<BM>;
  const long long m_pad = static_cast<long long>(p.T) * BM;
  const long long two_f = 2LL * p.f;
  CUtensorMap maps[2];
  int rc;
  if (kMode == kFfnGateUp) {
    rc = tensor_map_2d(&maps[0], p.x, p.d, p.n_src, 1);
    if (!rc) rc = tensor_map_2d(&maps[1], p.w_gu, two_f, 1LL * p.e * p.d, 64);
  } else if (kMode == kFfnDown) {
    rc = tensor_map_2d(&maps[0], p.a, p.f, m_pad, BM);
    if (!rc) rc = tensor_map_2d(&maps[1], p.w_down, p.d, 1LL * p.e * p.f, 64);
  } else {
    rc = tensor_map_2d(&maps[0], p.dh, two_f, m_pad, BM);
    if (!rc)
      rc = tensor_map_2d(&maps[1], p.w_gu, two_f, 1LL * p.e * p.d, Cfg::kBN);
  }
  if (rc) return rc;
  auto kernel = moe_ffn_kernel<BM, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = p.T * ffn_col_blocks<BM, kMode>(p);
  const int blocks = sms * Cfg::kMinBlocks;
  kernel<<<units < blocks ? units : blocks, Cfg::kThreads, Cfg::kSmem,
           stream>>>(maps[0], maps[1], p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int forward(const Params& p, cudaStream_t stream) {
  const int rc = launch_ffn<BM, kFfnGateUp>(p, stream);
  return rc ? rc : launch_ffn<BM, kFfnDown>(p, stream);
}

template <int BM>
int backward_dx(const Params& p, cudaStream_t stream) {
  const int rc = launch(moe_dx_gate_up_kernel<BM>, dim3(p.f / kBF, p.T),
                        dx_gate_up_smem<BM>(), p, stream);
  return rc ? rc : launch_ffn<BM, kFfnDownNK>(p, stream);
}

// The unit tile that fetches each gathered row the fewest times (see
// moe_dw_kernel), as the shape allows: dw_gu [128 x 256] (dh's 2f is a
// multiple of 256), dw_down [256 x 128] when f allows, else [128 x 256]
// or [128 x 128].
void dw_tile(bool gather_lhs, int M, int N, int* tm, int* tn) {
  if (!gather_lhs && M % 256 == 0) {
    *tm = 256;
    *tn = 128;
  } else {
    *tm = 128;
    *tn = N % 256 ? 128 : 256;
  }
}

// B8 dw: the slot-ordered operand's map ([m_pad, width], boxes of 64
// rows), the gathered operand's (boxes of one row), and one persistent
// block an SM, at most one a unit.
template <bool kGatherLhs, int kTileM, int kTileN>
int launch_dw(const void* sorted, long long m_pad, long long gathered_rows,
              const DwParams& p, cudaStream_t stream) {
  CUtensorMap maps[2];
  const int width = kGatherLhs ? p.M : p.N;  // of the gathered operand
  int rc = tensor_map_2d(&maps[0], sorted, kGatherLhs ? p.N : p.M, m_pad, 64);
  if (!rc) rc = tensor_map_2d(&maps[1], p.gathered, width, gathered_rows, 1);
  if (rc) return rc;
  auto kernel = moe_dw_kernel<kGatherLhs, kTileM, kTileN>;
  const int smem = DwCfg<kTileM, kTileN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = p.n_groups * (p.M / kTileM) * (p.N / kTileN);
  kernel<<<units < sms ? units : sms, kDwThreads, smem, stream>>>(maps[0],
                                                                 maps[1], p);
  return static_cast<int>(cudaGetLastError());
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
  // TMA reads the weights and the sorted a, cp.async and TMA x's rows:
  // 16-byte aligned.
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_gu) |
       reinterpret_cast<uintptr_t>(w_down) | reinterpret_cast<uintptr_t>(a)) %
      16)
    return static_cast<int>(cudaErrorInvalidValue);
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
  if ((reinterpret_cast<uintptr_t>(w_gu) | reinterpret_cast<uintptr_t>(dh)) %
      16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.tile_m == 128 ? backward_dx<128>(p, s) : backward_dx<16>(p, s);
}

// dims: M, N, m_pad, tile_m, E, lhs_rows, rhs_rows. Exactly one of
// lhs_ids and rhs_ids is given; the other operand is read in slot order
// (its first m_pad rows). work: one int32, zero at launch (the units'
// counter).
int dlr_moe_backward_dw(const void* lhs, const void* rhs, const void* lhs_ids,
                        const void* rhs_ids, const void* bounds, void* dw,
                        const long long* dims, void* work, void* stream) {
  for (int i = 0; i < 7; ++i)
    if (dims[i] < 1 || dims[i] > (1LL << 30))
      return static_cast<int>(cudaErrorInvalidValue);
  const bool gather_lhs = lhs_ids != nullptr;
  DwParams p = {};
  p.gathered = static_cast<const bf16*>(gather_lhs ? lhs : rhs);
  p.ids = static_cast<const int*>(gather_lhs ? lhs_ids : rhs_ids);
  p.bounds = static_cast<const int*>(bounds);
  p.next_unit = static_cast<int*>(work);
  p.dw = static_cast<float*>(dw);
  p.M = static_cast<int>(dims[0]);
  p.N = static_cast<int>(dims[1]);
  p.tile_m = static_cast<int>(dims[3]);
  p.n_groups = static_cast<int>(dims[4]);
  const long long m_pad = dims[2];
  // The slot-ordered operand must hold m_pad rows; TMA and the 16-byte
  // copies need 16-byte aligned rows; a gathered lhs (dw_gu, N = 2f)
  // goes with N in 256s.
  if (p.M % 128 || p.N % (gather_lhs ? 256 : 128) ||
      (p.tile_m != 16 && p.tile_m != 128) ||
      p.n_groups > kDwMaxGroups || (lhs_ids != nullptr) == (rhs_ids != nullptr) ||
      dims[gather_lhs ? 6 : 5] < m_pad ||
      (reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int tm, tn;
  dw_tile(gather_lhs, p.M, p.N, &tm, &tn);
  if (gather_lhs) return launch_dw<true, 128, 256>(rhs, m_pad, dims[5], p, s);
  if (tm == 256) return launch_dw<false, 256, 128>(lhs, m_pad, dims[6], p, s);
  return tn == 256 ? launch_dw<false, 128, 256>(lhs, m_pad, dims[6], p, s)
                   : launch_dw<false, 128, 128>(lhs, m_pad, dims[6], p, s);
}

// The unit tile and dynamic shared memory of a dw launch with M x N
// units, the gathered operand the lhs (dw_gu) or not (dw_down).
int dlr_moe_dw_config(int M, int N, int gather_lhs, int* smem, int* tile_m,
                      int* tile_n) {
  dw_tile(gather_lhs != 0, M, N, tile_m, tile_n);
  *smem = *tile_m == 256   ? DwCfg<256, 128>::kSmem
          : *tile_n == 256 ? DwCfg<128, 256>::kSmem
                           : DwCfg<128, 128>::kSmem;
  return 0;
}

// The launch of the grouped-GEMM body (B7's two launches, B8 dx's
// second) at tile_m: dynamic shared memory, threads and blocks an SM,
// and the unit's columns.
int dlr_moe_ffn_config(int tile_m, int* smem, int* threads, int* blocks,
                       int* tile_n) {
  if (tile_m != 16 && tile_m != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = tile_m == 128 ? FfnCfg<128>::kSmem : FfnCfg<16>::kSmem;
  *threads = tile_m == 128 ? FfnCfg<128>::kThreads : FfnCfg<16>::kThreads;
  *blocks = tile_m == 128 ? FfnCfg<128>::kMinBlocks : FfnCfg<16>::kMinBlocks;
  *tile_n = tile_m == 128 ? FfnCfg<128>::kBN : FfnCfg<16>::kBN;
  return 0;
}

const char* dlr_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
