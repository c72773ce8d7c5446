// Fused cross-entropy, forward (B3) and backward (B4: dx and dw), written
// by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/fused_ce.py:
//   - ce_fwd_kernel <- _pallas_forward / _fwd_kernel (B3);
//   - ce_dx_kernel  <- _pallas_backward / _bwd_dx_kernel (B4 dx);
//   - ce_dw_kernel  <- _pallas_backward / _bwd_dw_kernel (B4 dw).
// Same math: logits = x @ w from bf16 products with f32 accumulation, kept
// in f32; columns >= V take NEG_INF = -1e30. B3 keeps an online
// logsumexp (m, l) and the target logit tl per row and writes
// logz = m + log(max(l, 1e-30)) and per_tok = logz - tl + z logz^2. B4
// recomputes the logits tile from (x, w, logz), forms
// g = a exp(logit - logz) - b [col == tgt], rounds it to bf16 and
// accumulates dx = sum_vtiles g @ w_tile^T (stored in bf16) and
// dw = sum_rowtiles x_tile^T @ g (stored in f32), both in f32.
//
// Bound on the H100: tensor-core operations. At the flagship shape
// (n = 16384, d = 1024, V = 32000) B3 runs one logits-sized product
// (2 n d V flops), dx and dw two each, against ~99 MB of inputs. All
// three run on Hopper's own path: TMA loads into a ring of stages in
// shared memory, wgmma products, a producer thread and consumer
// warpgroups (see "B3", "B4: dw" and "B4: dx" below):
//   - B3 computes the logits of a 128-row tile 256 vocab columns at a
//     time and keeps an online (m, l, tl) per row in registers; the
//     vocab tiles are split across blocks where the row tiles are too
//     few to fill the card, and the last split of a row tile combines
//     the splits' partials in split order;
//   - the backward accumulators are larger than a block's registers
//     ([128, 1024] f32 is 512 KB), so dx and dw run over a thread-block
//     cluster over d. Each logits tile is computed once per (row tile,
//     vocab tile): recompute factor 1, so the backward pair runs four
//     logits-sized products beyond B3's one (the TPU kernels run the
//     same five);
//   - one owner per output element and a fixed order of sums: no
//     atomics on data, and reruns are bitwise identical;
//   - the TPU ran its grid cell after cell and carried (m, l, tl) or the
//     accumulator in scratch; here the sequential axis is a loop inside
//     the block and the cells run as concurrent blocks;
//   - ragged edges: rows >= n are zero-filled by TMA, carry zero
//     coefficients and are never stored; columns >= V are zero-filled,
//     masked to NEG_INF (exp gives 0) and never stored; the wrapper pads
//     w's row stride to a multiple of 8 elements so every row is 16-byte
//     aligned.
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch
// headers, so nvcc builds this file in seconds.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarpD = 128;    // d is a multiple of this ...
constexpr int kMaxD = 8 * kWarpD;  // ... up to this
constexpr float kNegInf = -1e30f;  // ops/fused_ce.py NEG_INF

struct Params {
  const bf16* x;        // [n, d]
  const bf16* w;        // [d, ldw]; columns >= v are ignored
  const int* tgt;       // [n]
  const float* logz_in; // [n]
  const float* coef_a;  // [n]
  const float* coef_b;  // [n]
  float* per_tok;       // [n]
  float* logz;          // [n]
  bf16* dx;             // [n, d]
  float* dw;            // [d, v]
  float* part;          // B3 with splits: [splits, n, 3] (m, l, tl)
  int* tickets;         // B3 with splits: [row tiles], zero between launches
  int n, d, v, ldw;
  int splits;           // B3: vocab splits a row tile
  float z_weight;
};

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// ---- B4: dw, a cluster over d, TMA + wgmma ----------------------------------
//
// dw[:, vt] = sum over row tiles of x^T g, computed as dw^T = g^T x: the
// vocabulary plays the keys of flash attention's dk/dv. dw^T [64 x d]
// f32 of one vocab tile does not fit in one block's registers, so a
// cluster of kC = d / (2 kDQ) blocks owns the tile: block (rank) r holds
// the d-slice [2 kDQ r, 2 kDQ (r + 1)), and its consumer warpgroup c the
// quarter kDQ c of that slice, with dw^T [64 x kDQ] in registers. Each
// step of 32 rows:
//   - one warpgroup of each block (they take turns: warpgroup j % 2 at
//     step j, its partial issued a step ahead) computes the S^T partial
//     [64 x 32] over the block's d-slice by wgmma (w's tile resident,
//     read MN-major; x's slice streamed by TMA, read K-major), keeps it
//     in slot 0 and has the copy engine push it into every peer's slot
//     for this block (cp.async.bulk between shared memories, completing
//     its bytes on the peer's `ready` barrier: no cluster-wide fence in a
//     warpgroup's path);
//   - every warpgroup sums the cluster's partials in rank order, the same
//     order in every block, so every block forms the identical g, and
//     tells every block it is done reading (`freed`);
//   - g^T = bf16(a exp(S^T - logz) - b [col == tgt]) in registers, with
//     the reference's rounding, is the register A operand of dw^T += g^T x
//     (its quarter of x's slice, read MN-major from the same stage).
// The logits are computed once per (row tile, vocab tile), as before.
// One owner per element of dw and a fixed order of sums: no atomics,
// and reruns are bitwise equal.
//
// Why 2 kDQ columns of d a block: the partials are f32 tiles that cross
// SMs; a first design with 4 blocks of 256 columns, every block reading
// the other three partials through distributed shared memory, spent
// most of its time in that exchange and ran slower than the mma.sync
// design it replaced. A block of 512 columns receives one 8 KB partial a
// step for 2 x 64 x 32 x 512 multiply-adds.
//
// 384 threads: two consumer warpgroups (setmaxnreg.inc kConsumerRegs)
// and a producer warp (of warpgroup 2, setmaxnreg.dec) that loads w's
// tile once and streams x's slice [32 rows x 2 kDQ] and the rows' (tgt,
// logz, a, b) through a ring of kStages. `ready` counts the computing
// warps' arrivals and the peers' bytes, `freed` every consumer warp of
// the cluster, over two partial buffers. The consumers' waits carry no
// trap (see B2 in flash_attention.cu) and give up after ~2^32 cycles;
// the producer's trap. Ragged edges: rows >= n are zero-filled by TMA
// and carry zero coefficients; vocab columns >= V are zero-filled,
// masked to NEG_INF and never stored.

constexpr int kDwThreads = 384;
constexpr int kDwVt = 64;          // vocab columns of a cluster
constexpr int kDwR = 32;           // rows of a step
constexpr int kWBox = 64 * 128;    // a [64 d x 64 v] box of w
constexpr int kXBox = kDwR * 128;  // a [32 rows x 64 d] box of x
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// A block of a cluster of kC holds the d-slice 2 kDQ; each consumer
// warpgroup the quarter kDQ of it.
template <int kDQ, int kC>
struct DwCfg {
  static constexpr int kBoxes = 2 * kDQ / 64;       // 64-column boxes a block
  static constexpr int kWBytes = kBoxes * kWBox;    // w[slice, vt]
  static constexpr int kXBytes = kBoxes * kXBox;    // x[32 rows, slice]
  static constexpr int kPartBytes = 64 * kDwR * 4;  // a [64 x 32] f32 tile
  static constexpr int kStatBytes = 4 * kDwR * 4;   // tgt, logz, a, b
  // The partials of the cluster's blocks, two buffers of kC slots.
  static constexpr int kPartsBytes = 2 * kC * kPartBytes;
  static constexpr int kStages =
      kWBytes + 3 * (kXBytes + kStatBytes) + kPartsBytes + 2048 <= 232448
          ? 3
          : 2;
  static constexpr int kX = kWBytes;
  static constexpr int kPart = kX + kStages * kXBytes;
  static constexpr int kStat = kPart + kPartsBytes;
  static constexpr int kBars = kStat + kStages * kStatBytes;
  // w_full, full and empty per stage, ready and freed per buffer.
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * kStages + 4);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
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

// Arrive on the barrier at the same offset in block `rank` of the
// cluster, relaxed: for a reader telling the writer that its loads,
// whose values it has already used, are done.
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

__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar,
                                                      int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The producer's wait: one that outlasts ~2^35 cycles traps, so a lost
// TMA completion or arrival ends the launch with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
}

// The consumers' waits: no trap. After ~2^32 cycles a wait gives up and
// clears `live`, and a thread that has given up waits no more, so a
// fault ends the launch with wrong sums instead of a hang.
template <bool kCluster>
__device__ __forceinline__ void mbar_spin(uint32_t bar, int parity,
                                          bool& live) {
  auto ready = [&]() {
    return kCluster ? mbar_try_wait_cluster(bar, parity)
                    : mbar_try_wait(bar, parity);
  };
  if (!live || ready()) return;
  const long long t0 = clock64();
  while (!ready())
    if (clock64() - t0 > (1ll << 32)) {
      live = false;
      return;
    }
}

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

// The copy engine copies `bytes` of this block's shared memory at src
// to offset dst in block `rank`, completing them on that block's
// barrier at offset bar.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, int rank,
                                                  uint32_t src, int bytes,
                                                  uint32_t bar) {
  asm volatile(
      "{\n.reg .b32 rd, rb;\n"
      "mapa.shared::cluster.u32 rd, %0, %1;\n"
      "mapa.shared::cluster.u32 rb, %3, %1;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [rd], [%2], %4, [rb];\n}\n" ::"r"(dst),
      "r"(rank), "r"(src), "r"(bar), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over one consumer warpgroup.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// One [64 rows x 64 columns] box of a 2-D (columns, rows) tensor map at
// (col, row); rows and columns past the tensor are zero-filled.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), and
// the swizzle mode in bits 62-63.
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

template <int NT>
__device__ __forceinline__ void fence_operands(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(a[i][e])::"memory");
}

template <int NT>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d[64 x 32] (+)= A[64 x 16] . B[16 x 32], A MN-major and B K-major in
// shared memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tn_n32(float (&d)[4][4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (the
// accumulator layout of a 16-bit product), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (the
// accumulator layout of a 16-bit product), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// dw^T [64 x kDQ] += A . x[32 rows, quarter]: A the g^T fragments in
// registers (K = 32 rows, two steps of 16), x MN-major, 16 rows (2048
// bytes) a step, 128 columns (two boxes) an instruction.
template <int kDQ>
__device__ __forceinline__ void issue_dw(float (&acc)[kDQ / 128 + (kDQ < 128)]
                                                   [kDQ < 128 ? 8 : 16][4],
                                         const uint32_t (&ga)[2][4],
                                         uint32_t x) {
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    if constexpr (kDQ < 128) {
      wgmma_rs_n64(acc[0], ga[kc], smem_desc(x + kc * 2048, kXBox, 1024));
    } else {
#pragma unroll
      for (int h = 0; h < kDQ / 128; ++h)
        wgmma_rs_n128(acc[h], ga[kc],
                      smem_desc(x + 2 * h * kXBox + kc * 2048, kXBox, 1024));
    }
  }
}

template <int kDQ, int kC>
__global__ void __launch_bounds__(kDwThreads, 1)
    ce_dw_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const Params p) {
  using Cfg = DwCfg<kDQ, kC>;
  constexpr int kStages = Cfg::kStages, kBoxes = Cfg::kBoxes;
  constexpr int kQBoxes = kDQ / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t w_s = base;
  auto x_s = [&](int st) { return base + Cfg::kX + st * Cfg::kXBytes; };
  const int rank = cluster_rank();
  // Block `at`'s slot for the partial of block `from` in buffer b
  // (offset from base): its own in slot 0, a peer's in 1 + the peer's
  // index among the others.
  auto slot = [&](int b, int at, int from) {
    const int i = from == at ? 0 : 1 + from - (from > at);
    return Cfg::kPart + (b * kC + i) * Cfg::kPartBytes;
  };
  auto stats = [&](int st) {
    return reinterpret_cast<float*>(gbase + Cfg::kStat + st * Cfg::kStatBytes);
  };
  const uint32_t bars = base + Cfg::kBars;
  const uint32_t w_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto ready = [&](int b) { return bars + 8 * (1 + 2 * kStages + b); };
  auto freed = [&](int b) { return bars + 8 * (3 + 2 * kStages + b); };

  const int vt0 = (blockIdx.x / kC) * kDwVt;
  const int d0 = rank * 2 * kDQ;
  const int n_rt = (p.n + kDwR - 1) / kDwR;

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 32);  // the producer warp's lanes
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      // The warps that computed this block's partial; the peers' come as
      // bytes.
      mbar_init(ready(b), 4);
      mbar_init(freed(b), 8 * kC);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block's barriers exist before any block arrives on them.
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(w_full, Cfg::kWBytes);
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_2d(w_s + bx * kWBox, &map_w, w_full, vt0, d0 + 64 * bx);
      }
      for (int j = 0; j < n_rt; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty(st), (j / kStages - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx_only(full(st), Cfg::kXBytes);
          for (int bx = 0; bx < kBoxes; ++bx)
            tma_load_2d(x_s(st) + bx * kXBox, &map_x, full(st), d0 + 64 * bx,
                        j * kDwR);
        }
        // The rows' inputs load while the TMA runs.
        float* slot = stats(st);
        const int row = j * kDwR + lane;
        const bool ok = row < p.n;
        reinterpret_cast<int*>(slot)[lane] = ok ? p.tgt[row] : -1;
        slot[kDwR + lane] = ok ? p.logz_in[row] : 0.f;
        slot[2 * kDwR + lane] = ok ? p.coef_a[row] : 0.f;
        slot[3 * kDwR + lane] = ok ? p.coef_b[row] : 0.f;
        mbar_arrive(full(st));
      }
      if (lane == 0)  // the watch
        for (int j = max(0, n_rt - kStages); j < n_rt; ++j)
          mbar_wait(empty(j % kStages), (j / kStages) & 1);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int v_base = vt0 + 16 * warp + g;  // vocab rows + 0, + 8
    constexpr int kH = kDQ / 128 + (kDQ < 128), kNT = kDQ < 128 ? 8 : 16;
    float acc[kH][kNT][4];
    // Zeroed here, not moved past the first product by the compiler
    // (a non-wgmma write to an accumulator while products are in flight
    // serialises them).
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      zero(acc[h]);
      fence_operands(acc[h]);
    }
    bool live = true;
    int pend = -1;  // the stage of a dw product not yet known done
    // Waits for this warpgroup's products (all, or all but the last
    // group) and releases pend's stage.
    auto settle = [&](bool keep_last) {
      if (keep_last)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < kH; ++h) fence_operands(acc[h]);
      if (pend >= 0 && lane == 0) mbar_arrive(empty(pend));
      pend = -1;
    };
    // Step j's partial S^T over the block's d-slice, 16 d rows a step
    // (A = w MN-major, B = x K-major).
    float s[4][4];
    auto issue_s = [&](int j) {
      const int st = j % kStages;
      mbar_spin<false>(full(st), (j / kStages) & 1, live);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * kDQ / 16; ++kk)
        wgmma_tn_n32(s,
                     smem_desc(w_s + (kk / 4) * kWBox + (kk % 4) * 2048,
                               kWBox, 1024),
                     smem_desc(x_s(st) + (kk / 4) * kXBox + (kk % 4) * 32, 16,
                               1024),
                     kk > 0);
      wgmma_commit();
    };
    mbar_spin<false>(w_full, 0, live);
    // Warpgroup c computes the partials of the steps j = c mod 2, each
    // issued a step ahead, while the other warpgroup's turn runs.
    if (c == 0) issue_s(0);
    for (int j = 0; j < n_rt; ++j) {
      const int st = j % kStages, b = j & 1;
      mbar_spin<false>(full(st), (j / kStages) & 1, live);
      bool ahead = false;  // the next partial's products are in flight
      if ((j & 1) == c) {
        // This warpgroup's partial of step j: kept in slot 0 and pushed
        // into every peer's slot for this block.
        settle(false);
        fence_operands(s);
        if (j >= 2) mbar_spin<true>(freed(b), ((j >> 1) - 1) & 1, live);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          reinterpret_cast<float4*>(gbase + slot(b, rank, rank))[nt * 128 +
                                                                 tid] =
              make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
        if constexpr (kC > 1) {
          // The copy engine carries the partial to the peers and
          // completes its bytes on their `ready`: no cluster-wide fence
          // in this warpgroup's path.
          fence_proxy_async();
          wg_sync(1 + c);
          if (tid == 0)
            for (int r = 0; r < kC; ++r)
              if (r != rank)
                bulk_copy_cluster(base + slot(b, r, rank), r,
                                  base + slot(b, rank, rank),
                                  Cfg::kPartBytes, ready(b));
        }
        __syncwarp();
        if (lane == 0) {
          if (kC > 1 && warp == 0)
            mbar_expect_tx(ready(b), (kC - 1) * Cfg::kPartBytes);
          else
            mbar_arrive(ready(b));
        }
      } else if (j + 1 < n_rt) {
        issue_s(j + 1);
        ahead = true;
      }
      // Step j's logits: the blocks' partials summed in rank order, the
      // same order in every block.
      mbar_spin<false>(ready(b), (j >> 1) & 1, live);
      float lg[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int at = (nt * 128 + tid) * 16;
        float4 v = *reinterpret_cast<const float4*>(gbase + slot(b, rank, 0) + at);
        for (int r = 1; r < kC; ++r) {
          const float4 q =
              *reinterpret_cast<const float4*>(gbase + slot(b, rank, r) + at);
          v.x += q.x;
          v.y += q.y;
          v.z += q.z;
          v.w += q.w;
        }
        lg[nt][0] = v.x;
        lg[nt][1] = v.y;
        lg[nt][2] = v.z;
        lg[nt][3] = v.w;
      }
      __syncwarp();
      if (lane == 0)
        for (int r = 0; r < kC; ++r) mbar_arrive_cluster_relaxed(freed(b), r);
      // The previous dw product reads ga from registers: it must be done
      // before ga takes this step's g.
      settle(ahead);
      // g^T in registers, rounded as the reference rounds g.
      const float* sl = stats(st);
      const int* tg = reinterpret_cast<const int*>(sl);
      uint32_t ga[2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = v_base + 8 * (e >> 1);
          const int r = nt * 8 + 2 * t + (e & 1);  // the step's row
          const float logit = v < p.v ? lg[nt][e] : kNegInf;
          const float pe = expf(logit - sl[kDwR + r]);
          gv[e] = __fsub_rn(__fmul_rn(sl[2 * kDwR + r], pe),
                            v == tg[r] ? sl[3 * kDwR + r] : 0.f);
        }
        ga[nt / 2][2 * (nt % 2)] = pack_bf16(gv[0], gv[1]);
        ga[nt / 2][2 * (nt % 2) + 1] = pack_bf16(gv[2], gv[3]);
      }
      wgmma_fence();
      issue_dw<kDQ>(acc, ga, x_s(st) + c * kQBoxes * kXBox);
      wgmma_commit();
      pend = st;
    }
    settle(false);
    // dw[d, v] from dw^T[v, d]; columns >= V are not stored.
    const int dq0 = d0 + c * kDQ;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = v_base + 8 * (e >> 1);
          const long long col = dq0 + 128 * h + 8 * nt + 2 * t + (e & 1);
          if (v < p.v) p.dw[col * p.v + v] = acc[h][nt][e];
        }
  }
  // No block leaves while a peer may still write into it or arrive on
  // its barriers.
  cluster_sync();
}

// ---- B4: dx, a cluster over d, TMA + wgmma ----------------------------------
//
// dx[rows, :] = sum over vocab tiles of g w_vt^T, with g = bf16(a exp(S -
// logz) - b [col == tgt]) and S = x w_vt. dx over 128 rows x d = 1024 is
// 512 KB of f32, four blocks' registers, so a cluster of kC = d / kDS
// blocks owns a 128-row tile: block (rank) r holds dx's d-slice [kDS r,
// kDS (r + 1)), its consumer warpgroup c the rows 64 c .. 64 c + 63 of
// it, with dx [64 x kDS] in registers. The two warpgroups own different
// rows, so their chains are independent and interleave on the SM. Each
// vocab tile of 64 columns:
//   - each warpgroup computes the S partial [64 x 64] over its block's
//     d-slice by wgmma (x's slice resident, K-major; w's [kDS x 64]
//     stage streamed by TMA, read MN-major);
//   - reduce-scatter: the tile's four 32-row blocks q (warps 2 (q % 2)
//     and 2 (q % 2) + 1 of warpgroup q / 2) are owned by the blocks q %
//     kC. A pair of warps whose rows another block owns pushes its f32
//     fragments there (st.async, completing their bytes on the owner's
//     `pready`: no fence, no remote load); an owner keeps its own in its
//     slot. The next tile's partial is issued before any of this is
//     waited for, so the exchange hides behind that product;
//   - the owner sums the kC partials of its rows in rank order, forms g
//     in registers, rounded as the reference rounds it (a p - b, no
//     fused fma, then bf16), frees the senders' slots (`pfreed`) and
//     all-gathers g: it pushes its bf16 fragments to the other blocks
//     (st.async onto their `gready`), which load them into registers and
//     free the owner's slot (`gfreed`). Every block thus uses the one g
//     its owner formed;
//   - g is the register A operand of dx += g w^T: w's stage read K-major
//     (w[d, v] is contiguous along v, this product's K).
// A block receives 3 x 8 KB of partials and 3 x 4 KB of g a step at kC
// = 4, against 3 x 32 KB when every block summed all the partials
// itself (PERF.md: pulling those through ld.shared::cluster, with
// release arrivals, cost more than the products). The logits are
// computed once per (row tile, vocab tile); one owner per element of dx
// and of S and a fixed order of sums: no atomics, and reruns are
// bitwise equal.
//
// 384 threads: two consumer warpgroups (setmaxnreg.inc kConsumerRegs)
// and a producer thread (of warpgroup 2, setmaxnreg.dec) that loads x's
// slice [128 rows x kDS] once and streams w's [kDS x 64] tiles through
// a ring of kStages; a stage is freed when both warpgroups' dx products
// on it are done, one tile later. The exchange's slots are single: a
// sender waits for `pfreed`, an owner for `gfreed`, of the previous
// tile. The consumers' waits carry no trap (see B2 in
// flash_attention.cu); the producer's trap. Ragged edges: rows >= n are
// zero-filled by TMA, carry zero coefficients and are never stored;
// vocab columns >= V are zero-filled and masked to NEG_INF. At kC = 1
// every block owns its rows: the partial makes the same round trip
// through its slot, with nothing pushed.

constexpr int kDxVt = 64;                // vocab columns of a step
constexpr int kDxRows = 128;             // rows of a cluster's tile
constexpr int kXRowBox = kDxRows * 128;  // a [128 rows x 64 d] box of x
constexpr int kDxPart = 32 * kDxVt * 4;  // f32 partial of a 32-row block
constexpr int kDxG = 32 * kDxVt * 2;     // bf16 g of a 32-row block

template <int kDS, int kC>
struct DxCfg {
  static constexpr int kXBytes = kDS / 64 * kXRowBox;  // x[128 rows, slice]
  static constexpr int kWBytes = kDS / 64 * kWBox;     // w[slice, 64 cols]
  // Partials of the owned 32-row blocks (at most ceil(4 / kC)), one
  // slot a source block; g of the other blocks' rows.
  static constexpr int kOwned = (4 + kC - 1) / kC;
  static constexpr int kSlotBytes = kOwned * kC * kDxPart;
  static constexpr int kFixed = kXBytes + kSlotBytes + 4 * kDxG;
  static constexpr int kStages =
      1024 + kFixed + 4 * kWBytes + 256 <= 232448 ? 4 : 3;
  static constexpr int kW = kXBytes;
  static constexpr int kPart = kW + kStages * kWBytes;
  static constexpr int kG = kPart + kSlotBytes;
  static constexpr int kBars = kG + 4 * kDxG;
  // x_full, full and empty per stage, pready[2], pfreed[4], gready[4],
  // gfreed[2].
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * kStages + 12);
};

// A partial's 16 bytes to the same shared-memory offset in block
// `owner`: a plain store if this block is the owner (local), else
// st.async, completing them on the owner's barrier at offset bar (no
// fence). One instruction under a predicate, not a branch: a branch
// around the accumulator reads makes ptxas serialise the products.
__device__ __forceinline__ void put_partial(uint32_t addr, int owner,
                                            bool local, const float (&v)[4],
                                            uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 ra, rb;\n"
      "setp.ne.u32 p, %7, 0;\n"
      "@p st.shared.v4.f32 [%0], {%2, %3, %4, %5};\n"
      "@!p mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@!p mapa.shared::cluster.u32 rb, %6, %1;\n"
      "@!p st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[ra], {%2, %3, %4, %5}, [rb];\n}\n" ::"r"(addr),
      "r"(owner), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar),
      "r"(static_cast<uint32_t>(local))
      : "memory");
}

// 16 bytes to the same shared-memory offset in block `rank`, completing
// them on that block's barrier at offset bar (st.async: no fence).
__device__ __forceinline__ void st_async_u4(uint32_t addr, int rank,
                                            const uint32_t (&v)[4],
                                            uint32_t bar) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mapa.shared::cluster.u32 rb, %6, %1;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[ra], {%2, %3, %4, %5}, [rb];\n}\n" ::"r"(addr),
      "r"(rank), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(bar)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A K-major and B MN-major in
// shared memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_kn_n64(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (the
// accumulator layout of a 16-bit product), B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_kmaj_n128(float (&d)[16][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kDS, int kC>
__global__ void __launch_bounds__(kDwThreads, 1)
    ce_dx_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const Params p) {
  using Cfg = DxCfg<kDS, kC>;
  constexpr int kStages = Cfg::kStages, kBoxes = kDS / 64;
  constexpr int kH = kDS / 128;  // m64n128 products of the dx step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t x_s = base;
  auto w_s = [&](int st) { return base + Cfg::kW + st * Cfg::kWBytes; };
  const uint32_t bars = base + Cfg::kBars;
  const uint32_t x_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  const uint32_t xbars = bars + 8 * (1 + 2 * kStages);
  auto pready = [&](int o) { return xbars + 8 * o; };
  auto pfreed = [&](int q) { return xbars + 8 * (2 + q); };
  auto gready = [&](int q) { return xbars + 8 * (6 + q); };
  auto gfreed = [&](int o) { return xbars + 8 * (10 + o); };
  const int rank = kC > 1 ? cluster_rank() : 0;
  const int row0 = (blockIdx.x / kC) * kDxRows;
  const int d0 = rank * kDS;
  const int n_vt = (p.v + kDxVt - 1) / kDxVt;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 4; ++i) {
      if (i < 2) {
        // The owner's expect_tx; then the senders' bytes.
        mbar_init(pready(i), 1);
        // The receivers' two warps in each other block.
        mbar_init(gfreed(i), 2 * max(kC - 1, 1));
      }
      mbar_init(pfreed(i), 2);  // the owner's two warps
      mbar_init(gready(i), 1);  // the receivers' expect_tx; then bytes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block's barriers exist before any block arrives on them.
  if constexpr (kC > 1)
    cluster_sync();
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(x_full, Cfg::kXBytes);
      for (int bx = 0; bx < kBoxes; ++bx)
        tma_load_2d(x_s + bx * kXRowBox, &map_x, x_full, d0 + 64 * bx, row0);
      for (int j = 0; j < n_vt; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty(st), (j / kStages - 1) & 1);
        mbar_expect_tx(full(st), Cfg::kWBytes);
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_2d(w_s(st) + bx * kWBox, &map_w, full(st), j * kDxVt,
                      d0 + 64 * bx);
      }
      // The watch: every stage released before the block leaves.
      for (int j = max(0, n_vt - kStages); j < n_vt; ++j)
        mbar_wait(empty(j % kStages), (j / kStages) & 1);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g8 = lane / 4, t = lane % 4;
    // This warp's 32-row block, its owner, and the slots' offsets: a
    // slot is [8 x 16 bytes] a thread, laid out [i][warp pair][lane].
    const int q = 2 * c + warp / 2, owner = q % kC, oi = q / kC;
    const bool owned = owner == rank;
    const uint32_t frag = ((warp % 2) * 32 + lane) * 16;
    auto pslot = [&](int r) {
      return base + Cfg::kPart + (oi * kC + r) * kDxPart + frag;
    };
    const uint32_t gslot = base + Cfg::kG + q * kDxG + frag;
    // This thread's rows: + 0 and + 8.
    const int r_base = row0 + 64 * c + 16 * warp + g8;
    float acc[kH][16][4];
    // Zeroed here, not moved past the first product by the compiler.
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      zero(acc[h]);
      fence_operands(acc[h]);
    }
    float s[8][4];
    uint32_t ga[4][4];
    bool live = true;
    // Tile j's partial S over the block's d-slice: 16 d rows a step (A =
    // x K-major, B = w MN-major). Past the last tile the group is empty:
    // every step commits two groups (S(j + 1), dx(j)), so every wait
    // below leaves exactly the newest one in flight. (Issuing the products
    // past the last tile too, with no branch around them, lets ptxas keep
    // them unserialised but makes it spill: slower, PERF.md.)
    auto issue_s = [&](int j) {
      if (j < n_vt) {
        const int st = j % kStages;
        mbar_spin<false>(full(st), (j / kStages) & 1, live);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDS / 16; ++kk)
          wgmma_kn_n64(
              s,
              smem_desc(x_s + (kk / 4) * kXRowBox + 64 * c * 128 +
                            (kk % 4) * 32,
                        16, 1024),
              smem_desc(w_s(st) + (kk / 4) * kWBox + (kk % 4) * 2048, kWBox,
                        1024),
              kk > 0);
      }
      wgmma_commit();
    };
    mbar_spin<false>(x_full, 0, live);
    issue_s(0);
    wgmma_commit();  // stands for dx(-1)
    for (int j = 0; j < n_vt; ++j) {
      const int st = j % kStages;
      // S(j) is done; dx(j - 1), issued after it, may still run.
      wgmma_wait<1>();
      fence_operands(s);
      // Reduce-scatter: this warp pair's partial to its rows' owner.
      if constexpr (kC > 1)
        if (!owned && j >= 1) mbar_spin<true>(pfreed(q), (j - 1) & 1, live);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        put_partial(pslot(rank) + nt * 1024, owner, owned, s[nt], pready(oi));
      // The next tile's partial, and dx(j - 1), run while the exchange
      // goes on.
      issue_s(j + 1);
      // dx(j - 1) reads ga from registers: done before ga takes g(j), and
      // w's stage j - 1 is free. With peers this waits after the exchange
      // (ga kept live through it, so nothing else takes those registers):
      // the exchange, not the ring, sets the pace there.
      auto settle = [&]() {
        wgmma_wait<1>();
        fence_operands(ga);
        if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % kStages));
      };
      if constexpr (kC == 1) settle();
      if (owned) {
        if constexpr (kC > 1) {
          if (warp % 2 == 0 && lane == 0)
            mbar_expect_tx(pready(oi), (kC - 1) * kDxPart);
          mbar_spin<true>(pready(oi), j & 1, live);
        }
        // The rows' inputs (cached; not held across the loop).
        int tg[2];
        float lz[2], ca[2], cb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_base + 8 * h;
          const bool ok = r < p.n;
          tg[h] = ok ? p.tgt[r] : -1;
          lz[h] = ok ? p.logz_in[r] : 0.f;
          ca[h] = ok ? p.coef_a[r] : 0.f;
          cb[h] = ok ? p.coef_b[r] : 0.f;
        }
        // S(j) of these rows: the blocks' partials in rank order; g into
        // this block's slot and every other block's.
        const int v_base = j * kDxVt + 2 * t;
        if constexpr (kC > 1)
          if (j >= 1) mbar_spin<true>(gfreed(oi), (j - 1) & 1, live);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t gp[4];
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            const int nt = 2 * i + n2;
            float4 v = *reinterpret_cast<const float4*>(
                gbase + (pslot(0) - base) + nt * 1024);
#pragma unroll
            for (int r = 1; r < kC; ++r) {
              const float4 u = *reinterpret_cast<const float4*>(
                  gbase + (pslot(r) - base) + nt * 1024);
              v.x += u.x;
              v.y += u.y;
              v.z += u.z;
              v.w += u.w;
            }
            const float lg[4] = {v.x, v.y, v.z, v.w};
            float gv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1, col = v_base + 8 * nt + (e & 1);
              const float logit = col < p.v ? lg[e] : kNegInf;
              // a p - b, rounded as the reference rounds it (no fused
              // fma).
              gv[e] = __fsub_rn(__fmul_rn(ca[h], expf(logit - lz[h])),
                                col == tg[h] ? cb[h] : 0.f);
            }
            gp[2 * n2] = pack_bf16(gv[0], gv[1]);
            gp[2 * n2 + 1] = pack_bf16(gv[2], gv[3]);
          }
          *reinterpret_cast<uint4*>(gbase + (gslot - base) + i * 1024) =
              make_uint4(gp[0], gp[1], gp[2], gp[3]);
          if constexpr (kC > 1)
            for (int r = 0; r < kC; ++r)
              if (r != rank) st_async_u4(gslot + i * 1024, r, gp, gready(q));
        }
        if constexpr (kC > 1) {
          // The senders may refill their slots.
          __syncwarp();
          if (lane == 0)
            for (int r = 0; r < kC; ++r)
              if (r != rank) mbar_arrive_cluster_relaxed(pfreed(q), r);
        }
      } else if constexpr (kC > 1) {
        if (warp % 2 == 0 && lane == 0) mbar_expect_tx(gready(q), kDxG);
        mbar_spin<true>(gready(q), j & 1, live);
      }
      if constexpr (kC > 1) settle();
      // g(j) of this warp's rows, from the slot its owner filled: the
      // same loads on every warp (writes to an A operand inside a branch
      // make ptxas serialise the products).
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(gbase + (gslot - base) + i * 1024);
        ga[i][0] = u.x;
        ga[i][1] = u.y;
        ga[i][2] = u.z;
        ga[i][3] = u.w;
      }
      if constexpr (kC > 1) {
        __syncwarp();
        if (!owned && lane == 0)
          mbar_arrive_cluster_relaxed(gfreed(oi), owner);
      }
      // dx += g w^T: w's stage K-major, 16 vocab columns (32 bytes) a
      // step, the second 128 rows of d 16 KB on.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          wgmma_rs_kmaj_n128(
              acc[h], ga[kk],
              smem_desc(w_s(st) + h * 128 * 128 + kk * 32, 16, 1024));
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kH; ++h) fence_operands(acc[h]);
    if (lane == 0) mbar_arrive(empty((n_vt - 1) % kStages));
    // dx in x's dtype; rows >= n are not stored.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_base + 8 * r;
      if (row >= p.n) continue;
      bf16* out = p.dx + static_cast<long long>(row) * p.d + d0 + 2 * t;
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
          *reinterpret_cast<uint32_t*>(out + 128 * h + 8 * nt) =
              pack_bf16(acc[h][nt][2 * r], acc[h][nt][2 * r + 1]);
    }
  }
  // No block leaves while a peer may still push into it or arrive on
  // its barriers.
  if constexpr (kC > 1) cluster_sync();
}

// ---- B3: forward, TMA + wgmma, warp-specialised ---------------------------
//
// per_tok and logz of a 128-row tile over a range of vocab tiles (its
// split): the logits tile S = x w_vt [128 x 256] by wgmma, then an
// online logsumexp (m, l) and the target logit tl per row in registers.
//   - 384 threads: two consumer warpgroups (setmaxnreg.inc) of 64 rows
//     each hold S [64 x 256] f32 as two m64n128 accumulators; a producer
//     thread (warpgroup 2, setmaxnreg.dec) streams, per 64-deep slice of
//     d, x's [128 rows x 64] box (K-major) and w's [64 x 256] as four
//     [64 x 64] boxes (MN-major), 48 KB a stage, through a ring of 4:
//     B7's gate|up operand layout (moe_dispatch.cu).
//   - a tile's epilogue runs once its products are done, branch-free
//     (a branch around accumulator reads makes ptxas serialise the
//     products): columns >= V at NEG_INF, the row max over the quad, l =
//     l exp(m - m_new) + sum exp(S - m_new) with expf (B4 recomputes g
//     from this logz with expf), l and tl kept per thread and summed over
//     the quad once at the end.
//   - L2: a block reads x's rows (256 KB) and w's [1024 x 256] (512 KB)
//     per tile, so w is most of the traffic. In clusters of two blocks on
//     neighbouring row tiles (kC = 2) each block loads two of the four
//     w boxes and multicasts them to both, which halves w's share. A
//     stage is refilled once the consumers of both blocks have released
//     it: its `empty` counts the cluster's consumer warps.
//   - the grid is (row tiles, rounded up to the cluster) x splits of the
//     vocab tiles, the splits and the cluster chosen by the wrapper
//     (ops/fused_ce.py forward_plan) to fill the card in as few waves as
//     the tiles allow. With one split a block writes its rows' logz and
//     per_tok; with more, each writes its (m, l, tl) partials and takes a
//     ticket, and the last split of a row tile to arrive combines the
//     partials in split order (B5's scheme, decode_attention.cu) and
//     resets the ticket to 0.
// One owner per output element and a fixed order of sums: the only
// atomic elects the combining block, and reruns are bitwise equal. The
// consumers' waits carry no trap (see B2 in flash_attention.cu); the
// producer's trap. Ragged edges: rows >= n are zero-filled by TMA and
// never stored; columns >= V are zero-filled and masked.

constexpr int kFwdRows = 128;  // rows of a block's tile
constexpr int kFwdVt = 256;    // vocab columns of a tile
constexpr int kFwdStages = 4;
constexpr int kFwdX = kFwdRows * 128;         // x [128 rows x 64 d]
constexpr int kFwdStage = kFwdX + 4 * kWBox;  // and w [64 d x 256 v]
// full and empty per stage, then the combining flag.
constexpr int kFwdSmem = 1024 + kFwdStages * kFwdStage + 16 * kFwdStages + 16;

// One box at (col, row), multicast to the cluster's blocks in `mask`:
// the same shared-memory offset in each, completing its bytes on each
// one's barrier at offset bar.
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int col, int row,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "h"(mask)
      : "memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A K-major and B MN-major in
// shared memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_kn_n128(float (&d)[16][4], uint64_t da,
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
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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

// The two consumer warpgroups' barrier (id 1, 256 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// logz = m + log(max(l, 1e-30)) and per_tok = logz - tl + z logz^2 of one
// row.
__device__ __forceinline__ void store_row(const Params& p, int row, float m,
                                          float l, float tl) {
  const float lz = m + logf(fmaxf(l, 1e-30f));
  p.logz[row] = lz;
  p.per_tok[row] = lz - tl + p.z_weight * (lz * lz);
}

template <int kC>
__global__ void __launch_bounds__(kDwThreads, 1)
    ce_fwd_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  auto x_s = [&](int st) { return base + st * kFwdStage; };
  auto w_s = [&](int st) { return x_s(st) + kFwdX; };
  const uint32_t bars = base + kFwdStages * kFwdStage;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kFwdStages + st); };
  volatile int* combine =
      reinterpret_cast<int*>(gbase + kFwdStages * kFwdStage + 16 * kFwdStages);

  // Block (split, row tile); a cluster's blocks share the split.
  const int n_rt = (p.n + kFwdRows - 1) / kFwdRows;
  const int n_rt_pad = (n_rt + kC - 1) / kC * kC;
  const int split = blockIdx.x / n_rt_pad, rt = blockIdx.x % n_rt_pad;
  const int row0 = rt * kFwdRows;
  const int n_vt = (p.v + kFwdVt - 1) / kFwdVt;
  const int vt0 = static_cast<int>(1LL * split * n_vt / p.splits);
  const int vt1 = static_cast<int>(1LL * (split + 1) * n_vt / p.splits);
  const int n_ks = p.d / 64;
  const int steps = (vt1 - vt0) * n_ks;
  const int rank = kC > 1 ? cluster_rank() : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(full(st), 1);        // the producer's expect_tx; then bytes
      mbar_init(empty(st), 8 * kC);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block's barriers exist before any block arrives on them.
  if constexpr (kC > 1)
    cluster_sync();
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      for (int g = 0; g < steps; ++g) {
        const int st = g % kFwdStages;
        if (g >= kFwdStages) mbar_wait(empty(st), (g / kFwdStages - 1) & 1);
        const int col = (vt0 + g / n_ks) * kFwdVt, k0 = (g % n_ks) * 64;
        // The whole stage: this block's x and all four w boxes (the
        // peer's two arrive by its multicast).
        mbar_expect_tx(full(st), kFwdStage);
        tma_load_2d(x_s(st), &map_x, full(st), k0, row0);
        for (int bx = rank * (4 / kC); bx < (rank + 1) * (4 / kC); ++bx) {
          if constexpr (kC > 1)
            tma_load_2d_mc(w_s(st) + bx * kWBox, &map_w, full(st),
                           col + 64 * bx, k0, (1 << kC) - 1);
          else
            tma_load_2d(w_s(st) + bx * kWBox, &map_w, full(st),
                        col + 64 * bx, k0);
        }
      }
      // The watch: every stage released before the block leaves.
      for (int g = max(0, steps - kFwdStages); g < steps; ++g)
        mbar_wait(empty(g % kFwdStages), (g / kFwdStages) & 1);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g8 = lane / 4, t = lane % 4;
    // This thread's rows (+ 0, + 8) and their targets.
    const int r_base = row0 + 64 * c + 16 * warp + g8;
    int tg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      tg[r] = r_base + 8 * r < p.n ? p.tgt[r_base + 8 * r] : -1;
    // Online (m, l, tl); l and tl per thread, summed over the quad at
    // the end (m is the quad's).
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tl[2] = {0.f, 0.f};
    float acc[2][16][4];
    bool live = true;
    auto release = [&](int st) {
      if (lane == 0) {
        mbar_arrive(empty(st));
        if constexpr (kC > 1)
          for (int r = 0; r < kC; ++r)
            if (r != rank) mbar_arrive_cluster_relaxed(empty(st), r);
      }
    };
    int g = 0;
    for (int vt = vt0; vt < vt1; ++vt) {
      for (int k = 0; k < n_ks; ++k, ++g) {
        const int st = g % kFwdStages;
        mbar_spin<false>(full(st), (g / kFwdStages) & 1, live);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da =
              smem_desc(x_s(st) + c * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_kn_n128(acc[h], da,
                          smem_desc(w_s(st) + 2 * h * kWBox + kk * 2048,
                                    kWBox, 1024),
                          k > 0 || kk > 0);
        }
        wgmma_commit();
        // The previous slice's products are done: release its stage.
        wgmma_wait<1>();
        if (k > 0) release((g - 1) % kFwdStages);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) fence_operands(acc[h]);
      release((g - 1) % kFwdStages);

      // The tile's epilogue. Column 128 h + 8 nt + (e & 1) of the thread
      // is vocab column col0 + that; it is real below lim.
      const int col0 = vt * kFwdVt + 2 * t;
      const int lim = p.v - col0;
      const int rel[2] = {tg[0] - col0, tg[1] - col0};
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = 128 * h + 8 * nt + (e & 1);
            const float s = o < lim ? acc[h][nt][e] : kNegInf;
            acc[h][nt][e] = s;
            mx[e >> 1] = fmaxf(mx[e >> 1], s);
            if (o == rel[e >> 1]) tl[e >> 1] += s;
          }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rs[e >> 1] += expf(acc[h][nt][e] - m[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      tl[r] = quad_sum(tl[r]);
    }
    if (p.splits == 1) {
      if (t == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (r_base + 8 * r < p.n) store_row(p, r_base + 8 * r, m[r], l[r], tl[r]);
    } else {
      // This split's partials, then a ticket: the last split of the row
      // tile to arrive combines them in split order.
      if (t == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r_base + 8 * r;
          if (row >= p.n) continue;
          float* part = p.part + (1LL * split * p.n + row) * 3;
          part[0] = m[r];
          part[1] = l[r];
          part[2] = tl[r];
        }
      __threadfence();
      consumers_sync();
      if (threadIdx.x == 0)
        *combine = rt < n_rt && atomicAdd(p.tickets + rt, 1) == p.splits - 1;
      consumers_sync();
      if (*combine) {
        if (threadIdx.x == 0) p.tickets[rt] = 0;
        __threadfence();
        if (t == 0)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r_base + 8 * r;
            if (row >= p.n) continue;
            const float* part = p.part + 3LL * row;
            const long long step = 3LL * p.n;
            float mm = kNegInf;
            for (int s = 0; s < p.splits; ++s)
              mm = fmaxf(mm, __ldcg(part + s * step));
            float ll = 0.f, tt = 0.f;
            for (int s = 0; s < p.splits; ++s) {
              ll += __ldcg(part + s * step + 1) *
                    expf(__ldcg(part + s * step) - mm);
              tt += __ldcg(part + s * step + 2);
            }
            store_row(p, row, mm, ll, tt);
          }
      }
    }
  }
  // No block leaves while its peer may still multicast into it or arrive
  // on its barriers.
  if constexpr (kC > 1) cluster_sync();
}

// ---- launch ---------------------------------------------------------------

// dims: n, d, v, ldw.
int fill(Params* p, const long long* dims) {
  p->n = static_cast<int>(dims[0]);
  p->d = static_cast<int>(dims[1]);
  p->v = static_cast<int>(dims[2]);
  p->ldw = static_cast<int>(dims[3]);
  if (p->n < 1 || p->v < 1 || p->ldw < p->v || p->ldw % 8 != 0 ||
      p->d < kWarpD || p->d % kWarpD != 0 || p->d > kMaxD ||
      dims[0] > (1LL << 30) || dims[3] > (1LL << 30))
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

// A 2-D (cols, rows) map of a row-major bf16 tensor with row stride ld
// elements (a multiple of 8), boxes of [box_rows x 64 columns] in the
// 128-byte swizzle; rows and columns past the tensor are zero-filled.
int tensor_map_2d(CUtensorMap* map, const void* ptr, long long cols,
                  long long rows, long long ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(ld) * 2};
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

// Calls f.run<kDQ, kC>() for the widest quarter kDQ with d = 2 kDQ kC
// (at most 8 blocks a cluster).
template <typename F>
int with_dw_config(int d, const F& f) {
  switch (d) {
    case 128: return f.template run<64, 1>();
    case 256: return f.template run<128, 1>();
    case 384: return f.template run<64, 3>();
    case 512: return f.template run<256, 1>();
    case 640: return f.template run<64, 5>();
    case 768: return f.template run<128, 3>();
    case 896: return f.template run<64, 7>();
    default: return f.template run<256, 2>();  // 1024
  }
}

// B4 dw: x's and w's maps, then clusters of kC blocks, one cluster a
// vocab tile of 64.
template <int kDQ, int kC>
int launch_dw(const Params& p, cudaStream_t stream) {
  CUtensorMap maps[2];
  int rc = tensor_map_2d(&maps[0], p.x, p.d, p.n, p.d, kDwR);
  if (!rc) rc = tensor_map_2d(&maps[1], p.w, p.v, p.d, p.ldw, 64);
  if (rc) return rc;
  auto kernel = ce_dw_kernel<kDQ, kC>;
  const int smem = DwCfg<kDQ, kC>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.v + kDwVt - 1) / kDwVt) * kC);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

struct Launch {
  const Params& p;
  cudaStream_t stream;
  template <int kDQ, int kC>
  int run() const {
    return launch_dw<kDQ, kC>(p, stream);
  }
};

struct SmemBytes {
  template <int kDQ, int kC>
  int run() const {
    return DwCfg<kDQ, kC>::kSmem;
  }
};

struct ClusterSize {
  template <int kDQ, int kC>
  int run() const {
    return kC;
  }
};

// Calls f.run<kDS, kC>() for B4 dx's d-slice kDS (256 where it divides
// d, else 128) with d = kDS kC (at most 8 blocks a cluster).
template <typename F>
int with_dx_config(int d, const F& f) {
  switch (d) {
    case 128: return f.template run<128, 1>();
    case 256: return f.template run<256, 1>();
    case 384: return f.template run<128, 3>();
    case 512: return f.template run<256, 2>();
    case 640: return f.template run<128, 5>();
    case 768: return f.template run<256, 3>();
    case 896: return f.template run<128, 7>();
    default: return f.template run<256, 4>();  // 1024
  }
}

// B4 dx: x's map in [128 rows x 64] boxes, w's in [64 x 64]; clusters of
// kC blocks, one cluster a 128-row tile.
template <int kDS, int kC>
int launch_dx(const Params& p, cudaStream_t stream) {
  CUtensorMap maps[2];
  int rc = tensor_map_2d(&maps[0], p.x, p.d, p.n, p.d, kDxRows);
  if (!rc) rc = tensor_map_2d(&maps[1], p.w, p.v, p.d, p.ldw, 64);
  if (rc) return rc;
  auto kernel = ce_dx_kernel<kDS, kC>;
  const int smem = DxCfg<kDS, kC>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.n + kDxRows - 1) / kDxRows) * kC);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

struct LaunchDx {
  const Params& p;
  cudaStream_t stream;
  template <int kDS, int kC>
  int run() const {
    return launch_dx<kDS, kC>(p, stream);
  }
};

struct DxSmemBytes {
  template <int kDS, int kC>
  int run() const {
    return DxCfg<kDS, kC>::kSmem;
  }
};

struct DxClusterSize {
  template <int kDS, int kC>
  int run() const {
    return kC;
  }
};

// B3: x's map in [128 rows x 64] boxes, w's in [64 x 64]; clusters of
// kC blocks on neighbouring row tiles, (row tiles rounded up to kC) x
// splits blocks.
template <int kC>
int launch_fwd(const Params& p, cudaStream_t stream) {
  CUtensorMap maps[2];
  int rc = tensor_map_2d(&maps[0], p.x, p.d, p.n, p.d, kFwdRows);
  if (!rc) rc = tensor_map_2d(&maps[1], p.w, p.v, p.d, p.ldw, 64);
  if (rc) return rc;
  auto kernel = ce_fwd_kernel<kC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rt = (p.n + kFwdRows - 1) / kFwdRows;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rt + kC - 1) / kC * kC * p.splits);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = kFwdSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code; 0 on a clean launch.

// dims: n, d, v, ldw, then B3's launch plan (ops/fused_ce.py
// forward_plan): splits, cluster (1 or 2), and the device addresses of
// the split partials (f32 [splits, n, 3]) and of the tickets (int32,
// one a row tile, zero, and left zero by the launch); both 0 with one
// split.
int dlr_ce_forward(const void* x, const void* w, const void* tgt,
                   void* per_tok, void* logz, const long long* dims,
                   float z_weight, void* stream) {
  Params p = {};
  int rc = fill(&p, dims);
  if (rc) return rc;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.tgt = static_cast<const int*>(tgt);
  p.per_tok = static_cast<float*>(per_tok);
  p.logz = static_cast<float*>(logz);
  p.z_weight = z_weight;
  p.splits = static_cast<int>(dims[4]);
  const long long cluster = dims[5];
  p.part = reinterpret_cast<float*>(static_cast<uintptr_t>(dims[6]));
  p.tickets = reinterpret_cast<int*>(static_cast<uintptr_t>(dims[7]));
  const int n_vt = (p.v + kFwdVt - 1) / kFwdVt;
  // TMA reads x and w: 16-byte aligned rows.
  if (p.splits < 1 || p.splits > n_vt || (cluster != 1 && cluster != 2) ||
      (p.splits > 1 && (p.part == nullptr || p.tickets == nullptr)) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cluster == 2 ? launch_fwd<2>(p, s) : launch_fwd<1>(p, s);
}

int dlr_ce_backward_dx(const void* x, const void* w, const void* tgt,
                       const void* logz, const void* coef_a,
                       const void* coef_b, void* dx, const long long* dims,
                       void* stream) {
  Params p = {};
  int rc = fill(&p, dims);
  if (rc) return rc;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.tgt = static_cast<const int*>(tgt);
  p.logz_in = static_cast<const float*>(logz);
  p.coef_a = static_cast<const float*>(coef_a);
  p.coef_b = static_cast<const float*>(coef_b);
  p.dx = static_cast<bf16*>(dx);
  // TMA reads x and w: 16-byte aligned rows.
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dx_config(p.d, LaunchDx{p, s});
}

int dlr_ce_backward_dw(const void* x, const void* w, const void* tgt,
                       const void* logz, const void* coef_a,
                       const void* coef_b, void* dw, const long long* dims,
                       void* stream) {
  Params p = {};
  int rc = fill(&p, dims);
  if (rc) return rc;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.tgt = static_cast<const int*>(tgt);
  p.logz_in = static_cast<const float*>(logz);
  p.coef_a = static_cast<const float*>(coef_a);
  p.coef_b = static_cast<const float*>(coef_b);
  p.dw = static_cast<float*>(dw);
  // TMA reads x and w: 16-byte aligned rows.
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dw_config(p.d, Launch{p, s});
}

// Dynamic shared memory and cluster size of a dx launch at d.
int dlr_ce_dx_config(int d, int* smem, int* cluster) {
  if (d < 128 || d > 1024 || d % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = with_dx_config(d, DxSmemBytes{});
  *cluster = with_dx_config(d, DxClusterSize{});
  return 0;
}

// Dynamic shared memory and cluster size of a dw launch at d.
int dlr_ce_dw_config(int d, int* smem, int* cluster) {
  if (d < 128 || d > 1024 || d % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = with_dw_config(d, SmemBytes{});
  *cluster = with_dw_config(d, ClusterSize{});
  return 0;
}

// B3's dynamic shared memory, and its row and vocab tiles.
int dlr_ce_fwd_config(int* smem, int* rows, int* cols) {
  *smem = kFwdSmem;
  *rows = kFwdRows;
  *cols = kFwdVt;
  return 0;
}

const char* dlr_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
