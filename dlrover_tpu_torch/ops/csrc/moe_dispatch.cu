// Grouped expert FFN over the expert-sorted MoE dispatch layout: forward
// (B7) and backward (B8: dx, dw_gu, dw_down), written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/moe_dispatch.py:
//   - B7 <- _grouped_ffn_fwd / _fwd_kernel: moe_ffn_kernel<.., kFfnGateUp>
//     then moe_ffn_kernel<.., kFfnDown>;
//   - B8 dx <- _grouped_ffn_bwd / _dx_kernel: moe_dx_gu_kernel then
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
//   - dx: the first launch (see "B8 dx, launch 1" below; the same
//     warp-specialised TMA + wgmma pieces) computes the gathered x @ w_gu
//     and dy @ w_down^T for the same 64 columns of f in one K loop and
//     applies the silu-gate backward in registers; the second is the
//     forward's second launch on B7's body with w_gu read transposed;
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

constexpr int kAlign = 128;  // d and f are multiples of this

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

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

// ---- B8 dx, launch 1: TMA + wgmma grouped GEMM ------------------------------
//
// Each unit is [BM slots x 64 columns c0 .. of f] of one row tile (expert
// e) and runs three products that all contract d, so they share one K
// loop:
//   h_g = x[row_ids] @ w_gu[e][:, c0 ..], h_u = x[row_ids] @
//   w_gu[e][:, f + c0 ..], da = dy[dest_ids] @ w_down[e][c0 .., :]^T;
// then in registers a = bf16(silu(h_g) h_u) and dh = bf16 of the
// silu-gate backward (gate half at c0, up half at f + c0), written to the
// sorted a and dh. A stage (64 of d) holds x's and dy's rows, gathered by
// coalesced 16-byte cp.async (GatherRows; an id of -1 zero-fills) and
// read K-major; w_gu[e]'s gate and up boxes [64 x 64] by TMA, read
// MN-major as B7's gate|up reads them; w_down[e]'s rows c0 .. as one
// [64 x 64] box, read K-major as B8 dx's second launch reads w_gu.
//
// Why 64 columns: a consumer thread holds h_g | h_u (one m64n128 product
// over the adjacent gate and up boxes) and da (m64n64) for its rows, 96
// registers; 128 columns would take 192, with four operands a stage only
// two stages of 80 KB would fit, and the epilogue needs all three at
// once. So each gathered row is needed f / 64 times (16 at f = 1024): a
// unit reads 512 KB of gathered rows and 384 KB of weights, and the
// loads, not the products, set its pace (PERF.md). What the design does
// about that:
//   - BM 128 runs in clusters of 2 blocks on neighbouring column blocks
//     of the same row tile. Each gathers half of a stage's x and dy rows
//     and the copy engine pushes that half into its peer (cp.async.bulk
//     between shared memories, completing on the peer's `full`) once it
//     has landed, one stage later, so each gathered row crosses L2 once
//     a pair. A stage is refilled once the consumers of both blocks have
//     released it: `empty` counts the cluster's consumer warps.
//   - the gathers are coalesced (GatherRows: a warp instruction reads
//     four whole 128-byte rows) and each producer thread reads its rows'
//     ids once a unit, holding them in registers: the producer runs at
//     96 registers (it spills below), the consumers at 200.
//   - the epilogue stores 16 bytes a thread: a 4 x 4 transpose within
//     each quad (quad_transpose) turns the accumulator's 4-byte pieces
//     into whole 8-column chunks of a row.
//
// BM 128 (training): 384 threads, two consumer warpgroups of 64 rows
// (setmaxnreg.inc kDxGuConsumerRegs), a producer warpgroup
// (setmaxnreg.dec kDxGuProducerRegs) and 4 stages of 56 KB. BM 16 (a
// decode step): 256 threads, one consumer warpgroup whose m64 products
// carry the tile's 16 rows (rows 16-63 of its A windows are never
// stored), one block an SM and no cluster (96 accumulator registers and
// the epilogue do not fit the 128 a thread of two blocks), 4 stages of
// 40 KB. Blocks (clusters) are persistent and walk the units in order
// (the column blocks of a row tile, then the next tile), so the rows and
// the expert's weights in flight stay in L2. A tile without a valid row
// is one stage flagged empty: no loads, no products, and its zero a and
// dh rows are written (the weight gradients read them). One owner per
// output element, K summed in order: reruns are bitwise equal.
// Consumers' waits carry no trap; the producer's trap.

// The gathered rows of a unit by 16-byte cp.async alone, coalesced:
// producer thread pt copies chunk pt % 8 of rows pt / 8 + 16 q, so a
// warp instruction reads four whole 128-byte rows (gather_stage's
// segments, one row a thread, read half a 32-byte sector an
// instruction). The thread's ids are read once a unit (`load`), then
// each stage copies 64 columns of those rows (`copy`): chunk j of row r
// lands at chunk j ^ (r % 8) of the 128-byte swizzle; an id of -1
// zero-fills.
template <int kRows>
struct GatherRows {
  int id[kRows / 16];

  __device__ __forceinline__ void load(const int* ids, long long s, int pt) {
#pragma unroll
    for (int q = 0; q < kRows / 16; ++q) id[q] = ids[s + pt / 8 + 16 * q];
  }

  __device__ __forceinline__ void copy(uint32_t dst, const bf16* src, int ld,
                                       int col0, int pt) const {
    const int j = pt % 8;
#pragma unroll
    for (int q = 0; q < kRows / 16; ++q) {
      const int r = pt / 8 + 16 * q, row = id[q];
      const bf16* from =
          src + (row >= 0 ? static_cast<long long>(row) * ld + col0 + 8 * j
                          : 0);
      cp_async16_to(dst + r * 128 + ((j ^ (r % 8)) << 4), from, row >= 0);
    }
  }
};

// A quad's 4 x 4 transpose of 32-bit words: thread t of the quad holds
// word t of chunks q = 0 .. 3 (v[q], 4 bytes of a 16-byte chunk each) and
// gets the four words of chunk t, in order. Two rounds of two shuffles
// (xor 1, then xor 2), each thread keeping the chunks whose bit matches
// its own.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4],
                                                int t) {
  const bool o1 = t & 1, o2 = t & 2;
  // Round 1: chunks 2 i + (t & 1) stay; a[i] is this thread's word of
  // chunk 2 i + (t & 1), b[i] the partner's (word t ^ 1).
  uint32_t a[2], b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[i] = o1 ? v[2 * i + 1] : v[2 * i];
    b[i] = __shfl_xor_sync(0xffffffffu, o1 ? v[2 * i] : v[2 * i + 1], 1);
  }
  // Round 2: chunk t stays (i = t >> 1); words t ^ 2 and t ^ 3 of it
  // come from the partner.
  const uint32_t w0 = o2 ? a[1] : a[0], w1 = o2 ? b[1] : b[0];
  const uint32_t w2 = __shfl_xor_sync(0xffffffffu, o2 ? a[0] : a[1], 2);
  const uint32_t w3 = __shfl_xor_sync(0xffffffffu, o2 ? b[0] : b[1], 2);
  // Word s of the chunk is w[s ^ t].
  auto word = [&](int k) {
    return (k & 2) ? ((k & 1) ? w3 : w2) : ((k & 1) ? w1 : w0);
  };
  return make_uint4(word(t), word(1 ^ t), word(2 ^ t), word(3 ^ t));
}

// Stores 16 bytes at dst if keep: a predicated st.global, no branch.
__device__ __forceinline__ void store16_if(bf16* dst, uint4 v, bool keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %5, 0;\n"
      "@p st.global.v4.b32 [%0], {%1, %2, %3, %4};\n}\n" ::"l"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
      "r"(static_cast<uint32_t>(keep))
      : "memory");
}

// The producer holds its rows' ids for a unit and spills below 96
// registers (B7's producer runs at 56); 2 x 128 x 200 + 128 x 96 fit the
// SM's 65536.
constexpr int kDxGuProducerRegs = 96, kDxGuConsumerRegs = 200;

template <int BM>
struct DxGuCfg {
  static constexpr int kConsumers = BM == 128 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kCluster = BM == 128 ? 2 : 1;
  static constexpr int kCols = 64;                             // of f
  static constexpr int kRowBytes = (BM < 64 ? 64 : BM) * 128;  // x or dy
  static constexpr int kPart = BM / kCluster * 128;  // a block's rows
  static constexpr int kStageBytes = 2 * kRowBytes + 3 * kBox;
  static constexpr int kStages = 4;
  static constexpr int kBars = kStages * kStageBytes;
  // Barriers (full, empty, gathered) and the stages' unit and flags.
  static constexpr int kSmem = 1024 + kBars + 24 * kStages + 8 * kStages;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Arrive on the barrier at the same offset in block `rank` of the
// cluster, relaxed: a reader telling the writer that it is done.
__device__ __forceinline__ void mbar_arrive_cluster_relaxed(uint32_t bar,
                                                            int rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          bar),
      "r"(rank)
      : "memory");
}

// The copy engine copies `bytes` of this block's shared memory at addr
// to the same offset in block `rank`, completing them on that block's
// barrier at offset bar.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t addr, int rank,
                                                  int bytes, uint32_t bar) {
  asm volatile(
      "{\n.reg .b32 rd, rb;\n"
      "mapa.shared::cluster.u32 rd, %0, %1;\n"
      "mapa.shared::cluster.u32 rb, %2, %1;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [rd], [%0], %3, [rb];\n}\n" ::"r"(addr),
      "r"(rank), "r"(bar), "r"(bytes)
      : "memory");
}

template <int BM>
__global__ void __launch_bounds__(DxGuCfg<BM>::kThreads, 1)
    moe_dx_gu_kernel(const __grid_constant__ CUtensorMap map_wgu,
                     const __grid_constant__ CUtensorMap map_wdn,
                     const Params p) {
  using Cfg = DxGuCfg<BM>;
  constexpr int kStages = Cfg::kStages, kCols = Cfg::kCols;
  constexpr int kC = Cfg::kCluster;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  auto x_s = [&](int st) { return base + st * Cfg::kStageBytes; };
  auto dy_s = [&](int st) { return x_s(st) + Cfg::kRowBytes; };
  auto wgu_s = [&](int st) { return dy_s(st) + Cfg::kRowBytes; };  // gate, up
  auto wdn_s = [&](int st) { return wgu_s(st) + 2 * kBox; };
  const uint32_t bars = base + Cfg::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  // This block's own gathered rows of a stage have landed.
  auto gathered = [&](int st) { return bars + 8 * (2 * kStages + st); };
  int2* meta = reinterpret_cast<int2*>(gbase + Cfg::kBars + 24 * kStages);

  const int n_k = p.d / 64;
  const int n_n = p.f / kCols;
  // A cluster takes kC neighbouring column blocks of a row tile.
  const int n_units = p.T * (n_n / kC);
  const int rank = kC > 1 ? cluster_rank() : 0;
  const int part_row = rank * (BM / kC);  // this block's rows of a stage

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 128);  // the producer's threads, with the bytes
      mbar_init(empty(st), 4 * Cfg::kConsumers * kC);  // the cluster's
      mbar_init(gathered(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block's barriers exist before any block arrives on them.
  if constexpr (kC > 1)
    cluster_sync();
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == Cfg::kConsumers) {
    if constexpr (Cfg::kConsumers == 2) setmaxnreg_dec<kDxGuProducerRegs>();
    const int pt = threadIdx.x - 128 * Cfg::kConsumers;
    int g = 0;         // stages issued
    int pending = -1;  // a stage whose rows are still to be pushed
    // This block's rows of stage gp into its peers, once they landed.
    auto push = [&](int gp) {
      const int st = gp % kStages;
      mbar_wait(gathered(st), (gp / kStages) & 1);
      fence_proxy_async();
      for (int r = 0; r < kC; ++r)
        if (r != rank) {
          bulk_copy_cluster(x_s(st) + part_row * 128, r, Cfg::kPart, full(st));
          bulk_copy_cluster(dy_s(st) + part_row * 128, r, Cfg::kPart,
                            full(st));
        }
    };
    for (int u = blockIdx.x / kC;; u += gridDim.x / kC) {
      const bool done = u >= n_units;
      const int tile = done ? 0 : u / (n_n / kC);
      const int nb = done ? 0 : (u % (n_n / kC)) * kC + rank;
      const long long s0 = static_cast<long long>(tile) * BM;
      const bool has =
          producer_any(!done && pt < BM && p.row_ids[s0 + pt] >= 0);
      const int e = has ? p.tile_expert[tile] : 0;
      const int steps = has ? n_k : 1;
      GatherRows<BM / kC> xr, dyr;  // this block's rows of the unit
      if (has) {
        xr.load(p.row_ids, s0 + part_row, pt);
        dyr.load(p.dest_ids, s0 + part_row, pt);
      }
      // done: one stage of unit -1 tells the consumers to stop.
      for (int k = 0; k < steps; ++k, ++g) {
        const int st = g % kStages;
        if (g >= kStages) mbar_wait(empty(st), (g / kStages - 1) & 1);
        const int k0 = 64 * k;
        if (pt == 0) {
          meta[st] = make_int2(done ? -1 : u * kC + rank,
                               (k == 0) | ((k == steps - 1) << 1) |
                                   (!has << 2));
          if (has) {
            const int c0 = nb * kCols;
            // The weights, and the peers' rows by their pushes.
            mbar_expect_tx_only(full(st),
                                3 * kBox + 2 * (kC - 1) * Cfg::kPart);
            tma_load_2d(wgu_s(st), &map_wgu, full(st), c0, e * p.d + k0);
            tma_load_2d(wgu_s(st) + kBox, &map_wgu, full(st), p.f + c0,
                        e * p.d + k0);
            tma_load_2d(wdn_s(st), &map_wdn, full(st), k0, e * p.f + c0);
          }
        }
        if (has) {
          xr.copy(x_s(st) + part_row * 128, p.x, p.d, k0, pt);
          dyr.copy(dy_s(st) + part_row * 128, p.dy, p.d, k0, pt);
        }
        // This thread's arrivals, once its cp.async copies have landed.
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                full(st))
            : "memory");
        if constexpr (kC > 1) {
          asm volatile(
              "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                  gathered(st))
              : "memory");
          // The previous stage's rows go to the peers while this one's
          // load.
          if (pt == 0) {
            if (pending >= 0) push(pending);
            pending = has ? g : -1;
          }
        }
      }
      if (done) break;
    }
    if constexpr (kC > 1)
      if (pt == 0 && pending >= 0) push(pending);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (pt == 0)  // the watch
      for (int j = max(0, g - kStages); j < g; ++j)
        mbar_wait(empty(j % kStages), (j / kStages) & 1);
  } else {
    if constexpr (Cfg::kConsumers == 2) setmaxnreg_inc<kDxGuConsumerRegs>();
    const int c = wg;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const uint32_t a_row = BM == 128 ? c * 64 * 128 : 0;  // the WG's rows
    // h_g and h_u as one m64n128 product (gate columns, then up), da.
    float h[16][4], da[8][4];
    bool live = true;
    int held = -1;  // the stage whose products may still be running
    // A stage is free once every consumer warp of the cluster is done.
    auto release = [&](int st) {
      if (lane == 0) {
        mbar_arrive(empty(st));
        if constexpr (kC > 1)
          for (int r = 0; r < kC; ++r)
            if (r != rank) mbar_arrive_cluster_relaxed(empty(st), r);
      }
    };
    for (int g = 0;; ++g) {
      const int st = g % kStages;
      mbar_spin(full(st), (g / kStages) & 1, live);
      const int2 mt = meta[st];
      if (mt.x < 0 || !live) {
        release(st);
        break;
      }
      const bool first = mt.y & 1, last = mt.y & 2, none = mt.y & 4;
      if (!none) {
        // This block's gathered rows came through the generic proxy
        // (cp.async); wgmma reads through the async proxy.
        fence_proxy_async();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dxs = smem_desc(x_s(st) + a_row + kk * 32, 16, 1024);
          const uint64_t dys =
              smem_desc(dy_s(st) + a_row + kk * 32, 16, 1024);
          const int acc = !(first && kk == 0);
          wgmma_ss<1>(h, dxs, smem_desc(wgu_s(st) + kk * 2048, kBox, 1024),
                      acc);
          wgmma_ss<0>(da, dys, smem_desc(wdn_s(st) + kk * 32, 16, 1024), acc);
        }
        wgmma_commit();
        // The previous stage's products are done: release its stage.
        wgmma_wait<1>();
        if (held >= 0) release(held);
        held = st;
      } else {
        release(st);
      }
      if (!last) continue;
      wgmma_wait<0>();
      fence_operands(h);
      fence_operands(da);
      if (held >= 0) release(held);
      held = -1;
      // Unit u * kC + rank: column block nb of row tile `tile`.
      const int cu = mt.x / kC;
      const int tile = cu / (n_n / kC), nb = (cu % (n_n / kC)) * kC + rank;
      const int g8 = lane / 4, t = lane % 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (BM == 128 ? 64 * c : 0) + 16 * warp + g8 + 8 * r;
        // Stores under a predicate, not a branch around the accumulator
        // reads: at BM 16 only the first warp's rows are the tile's.
        const bool keep = row < BM;
        const long long slot = keep ? static_cast<long long>(tile) * BM + row
                                    : 0;
        const int col = nb * kCols + 8 * t;
        bf16* a_out = p.a + slot * p.f + col;
        bf16* dh_out = p.dh + slot * 2LL * p.f + col;
        // Chunks 4 b .. 4 b + 3 (8 columns each) of the row: each thread
        // holds 4 bytes of each, and after quad_transpose 16 bytes of
        // chunk 4 b + t, stored as one vector.
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          uint32_t av[4], dg[4], du[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int nt = 4 * b + q;
            float va[2], vg[2], vu[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float hgv = h[nt][2 * r + j], huv = h[8 + nt][2 * r + j];
              const float dav = da[nt][2 * r + j];
              const float sg = sigmoid(hgv);
              const float silu = hgv * sg;
              va[j] = silu * huv;
              vu[j] = dav * silu;
              vg[j] = dav * huv * (sg * (1.f + hgv * (1.f - sg)));
            }
            av[q] = none ? 0u : pack_bf16(va[0], va[1]);
            dg[q] = none ? 0u : pack_bf16(vg[0], vg[1]);
            du[q] = none ? 0u : pack_bf16(vu[0], vu[1]);
          }
          store16_if(a_out + 32 * b, quad_transpose(av, t), keep);
          store16_if(dh_out + 32 * b, quad_transpose(dg, t), keep);
          store16_if(dh_out + p.f + 32 * b, quad_transpose(du, t), keep);
        }
      }
    }
  }
  // No block leaves while its peer may still push into it or arrive on
  // its barriers.
  if constexpr (kC > 1) cluster_sync();
}

// ---- launch ---------------------------------------------------------------

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
  if (p->d % kAlign || p->f % kAlign || (p->tile_m != 16 && p->tile_m != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
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

// B8 dx's first launch: w_gu's and w_down's maps ([64 x 64] boxes), then
// persistent clusters, one block an SM, at most one cluster a kC units.
template <int BM>
int launch_dx_gu(const Params& p, cudaStream_t stream) {
  using Cfg = DxGuCfg<BM>;
  CUtensorMap maps[2];
  int rc = tensor_map_2d(&maps[0], p.w_gu, 2LL * p.f, 1LL * p.e * p.d, 64);
  if (!rc) rc = tensor_map_2d(&maps[1], p.w_down, p.d, 1LL * p.e * p.f, 64);
  if (rc) return rc;
  auto kernel = moe_dx_gu_kernel<BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kC = Cfg::kCluster;
  const int clusters = p.T * (p.f / Cfg::kCols / kC);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((clusters < sms / kC ? clusters : sms / kC) * kC);
  cfg.blockDim = dim3(Cfg::kThreads);
  cfg.dynamicSmemBytes = Cfg::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B8 dx: launch 1 (h, da, the silu-gate backward; writes a and dh), then
// launch 2 (dh @ w_gu^T scattered); `which` 1 or 2 runs only that one.
template <int BM>
int backward_dx(const Params& p, int which, cudaStream_t stream) {
  const int rc = which == 2 ? 0 : launch_dx_gu<BM>(p, stream);
  return rc || which == 1 ? rc : launch_ffn<BM, kFfnDownNK>(p, stream);
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

// B8 dx's launches; which: 0 both, 1 the first only (h, da and the
// silu-gate backward into a and dh), 2 the second only (dh @ w_gu^T).
int backward_dx_launches(const void* x, const void* dy, const void* w_gu,
                         const void* w_down, const void* row_ids,
                         const void* dest_ids, const void* tile_expert,
                         void* dx_c, void* dh, void* a, const long long* dims,
                         int which, void* stream) {
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
  // TMA and 16-byte cp.async read x's and dy's rows, the weights and the
  // sorted dh: 16-byte aligned.
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(w_gu) |
       reinterpret_cast<uintptr_t>(w_down) |
       reinterpret_cast<uintptr_t>(dh)) %
          16 ||
      which < 0 || which > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.tile_m == 128 ? backward_dx<128>(p, which, s)
                         : backward_dx<16>(p, which, s);
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
  return backward_dx_launches(x, dy, w_gu, w_down, row_ids, dest_ids,
                              tile_expert, dx_c, dh, a, dims, 0, stream);
}

// One of B8 dx's two launches alone (which 1 or 2), for timing them apart.
int dlr_moe_backward_dx_launch(const void* x, const void* dy,
                               const void* w_gu, const void* w_down,
                               const void* row_ids, const void* dest_ids,
                               const void* tile_expert, void* dx_c, void* dh,
                               void* a, const long long* dims, int which,
                               void* stream) {
  if (which != 1 && which != 2) return static_cast<int>(cudaErrorInvalidValue);
  return backward_dx_launches(x, dy, w_gu, w_down, row_ids, dest_ids,
                              tile_expert, dx_c, dh, a, dims, which, stream);
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

// B8 dx's first launch at tile_m (one block an SM): dynamic shared
// memory, threads, cluster size, and the columns of f a unit.
int dlr_moe_dx_gu_config(int tile_m, int* smem, int* threads, int* cluster,
                         int* cols) {
  if (tile_m != 16 && tile_m != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = tile_m == 128 ? DxGuCfg<128>::kSmem : DxGuCfg<16>::kSmem;
  *threads = tile_m == 128 ? DxGuCfg<128>::kThreads : DxGuCfg<16>::kThreads;
  *cluster = tile_m == 128 ? DxGuCfg<128>::kCluster : DxGuCfg<16>::kCluster;
  *cols = DxGuCfg<128>::kCols;
  return 0;
}

const char* dlr_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
