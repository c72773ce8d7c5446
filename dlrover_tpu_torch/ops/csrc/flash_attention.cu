// Flash attention, forward (B1) and backward (B2), written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/pallas_attention.py:
//   - flash_fwd_kernel  <- _flash_forward / _flash_kernel (B1);
//   - flash_dq_kernel   <- flash_backward_T / _bwd_dq_kernel (B2);
//   - flash_dkv_kernel  <- flash_backward_T / _bwd_dkv_kernel (B2).
// Same math: logits from bf16 products with f32 accumulation, scaled
// after the product; causal mask (row >= column, both counted from 0)
// with the finite
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
// leave the chip).
//
// B1 is built for Hopper's own tensor-core path:
//   - TMA: one producer thread loads the Q tile once and streams K and
//     V tiles of 64 kv rows through a four-stage ring in shared memory,
//     in the 128-byte swizzle, with full and empty mbarriers per stage
//     (no __syncthreads in the kv loop). Rank-4 (d, heads, seq, b)
//     tensor maps over the strided [b, s, h, d] inputs zero-fill the
//     ragged tail and the columns past d (a d of 16-64 computes at 64);
//   - wgmma: two consumer warpgroups of 64 query rows each run
//     S = Q K^T as m64n64k16 from shared memory, keep the online
//     softmax in registers (row max and sum across the 4 threads of a
//     row), round P to bf16 in registers and feed it as the register A
//     operand of O += P V (the m64nNk16 accumulator layout of a 16-bit
//     product is the A-fragment layout); V is read MN-major, so no
//     transposed copy is written;
//   - overlap: a warpgroup issues tile i's S right before tile i-1's
//     P V, so its softmax of tile i runs while P V holds the tensor
//     cores, and the two warpgroups take turns issuing (named barriers),
//     so one's softmax overlaps the other's products;
//   - registers: 168 a thread, what ptxas gives a block of 288
//     threads (it counts them as three warpgroups, as for 384), so the
//     S tile is [64 x 64]: [64 x 128] beside O [64 x 128] and P spilled
//     and serialised every wgmma. With mbar_wait's trap in the
//     consumers' path ptxas ignores setmaxnreg (as found for B2);
//   - the softmax keeps the first design's arithmetic (x = s scale,
//     p = expf(x - m) over 64-column tiles), and B1 gives its bits
//     exactly. Cheaper exponents run faster but move every downstream
//     bit (tools/torch_flash_exp_ab.py; PERF.md section 6);
//   - causal: only the tiles that cross the diagonal or the ragged edge
//     apply the mask; the blocks with the most kv tiles start first.
// B2 (dq and dk/dv, two launches) is built from the same parts:
//   - 384 threads: two consumer warpgroups of 64 rows each and a
//     producer warpgroup; the producer gives its registers up
//     (setmaxnreg.dec 40) and the consumers take 232 (setmaxnreg.inc),
//     which dk and dv (128 f32 a thread) beside S^T and dP^T (64) need.
//     The consumers' barrier waits carry no trap (a trap in their path
//     makes ptxas ignore setmaxnreg); the producer keeps watch, trapping,
//     until every stage is released;
//   - dq: a block owns 128 q rows (Q and dO loaded once by TMA) and
//     streams K and V in 64-row tiles through a 4-stage ring; S = Q K^T
//     and dP = dO V^T as m64n64k16 from shared memory, dS in registers
//     as the A operand of dq += dS K (K read MN-major from the same
//     stage), tile i's S and dP issued ahead of tile i - 1's dS K,
//     the two warpgroups taking turns as in B1;
//   - dk/dv: a block owns 128 kv rows (K and V loaded once) and streams
//     Q, dO and the tile's lse and delta (copied by the producer warp:
//     compact [b, h, seq_q] f32 rows are not 16-byte aligned in general)
//     over the group's query heads and the q tiles at or past the
//     diagonal; S^T = K Q^T and dP^T = V dO^T, then dv += P^T dO and
//     dk += dS^T Q with P^T and dS^T as register A operands;
//   - the first design's arithmetic and order of sums (mma.sync over
//     64-row tiles), so B2 gives its bits exactly: x = s scale,
//     NEG_INF for masked entries, expf(x - lse), dS = p (dp - delta)
//     scale rounded to bf16; dq over kv tiles ascending, dk and dv over
//     (query head, q tile) ascending, 16-row k steps ascending;
//   - the GQA sum of dk/dv stays inside one block, so there are no
//     atomics and the result is deterministic; ragged edges are
//     zero-filled by TMA, masked with NEG_INF, and never stored.
// ptxas -v (sm_90a, nvcc 12.9; chip_smoke.py's ptxas line, PERF.md
// section 6): flash_fwd_kernel<128> 168 registers, 0 bytes of spills,
// 164,968 bytes of dynamic shared memory; <64> 155 registers, 0 spills,
// 83,048 bytes. flash_dq_kernel and flash_dkv_kernel, <128> and <64>:
// 168 registers (the launch's; the consumers run at 232), 0 spills, no
// wgmma serialisation note; 199,752 bytes of dynamic shared memory at
// <128>, 101,448 at <64>.
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch
// headers, so nvcc builds this file in seconds.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1073741824.f;  // -2^30, ops/attention.py NEG_INF

struct Strides {
  long long b, s, h;  // element strides of a [b, s, h, d] tensor (d: 1)
};

// The inputs q, k, v and dO reach the kernels through tensor maps.
struct Params {
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout of an m64nN f32 accumulator (the wgmma layout, as an
// m16n8 one per warp and 8 columns; lane = 4 g + t): d[nt][0], d[nt][1]
// at row g, columns 8 nt + 2t, + 1; d[nt][2], d[nt][3] at row g + 8.

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

// ---- B1: forward, TMA + wgmma, warp-specialised -----------------------------
//
// Grid (q tiles of 128 rows, h, b), 288 threads: warpgroups 0 and 1
// are consumers of 64 query rows each, warp 8 the producer (one thread
// issues every TMA load). Shared memory (each box 1024-byte
// aligned, in the 128-byte swizzle TMA writes and wgmma reads): the Q
// tile (kD / 64 boxes of [128 rows x 64 columns]), and a ring of
// FwdCfg::kStages K and V tiles of kN kv rows (kD / 64 boxes of
// [kN rows x 64 columns] each); then the barriers.

constexpr int kFwdRows = 128;     // q rows of a block
// Two consumer warpgroups and one producer warp (whose lane 0 issues
// every TMA load).
constexpr int kFwdThreads = 288;

// kv rows a tile (kN) and ring depth. ptxas holds a thread of this
// kernel to 168 registers: S [64 x 128] beside O [64 x 128] in f32 and
// the bf16 P spills and serialises the wgmma, S [64 x 64] does not. 64
// kv rows is also the first design's tile, so the running max, and with
// it every rounding of P, follows the same sequence.
template <int kD>
struct FwdCfg {
  static constexpr int kN = 64;
  static constexpr int kStages = 4;
  static constexpr int kBoxes = kD / 64;
  static constexpr int kQBytes = kBoxes * kFwdRows * 128;
  static constexpr int kKVBytes = kBoxes * kN * 128;  // one K or V tile
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + 1024 + 8 * (1 + 3 * kStages);
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

// Spin until the barrier's phase of this parity has completed. A wait
// that outlasts ~2^35 cycles (a lost TMA completion or arrival) traps,
// so a fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
}

// The same wait without the trap, for B2's consumers: a trap in their
// path makes ptxas hold them to the launch's 168 registers a thread
// whatever setmaxnreg gives them (B2's dk/dv then spilled 284 bytes and
// serialised its wgmma; tools/setmaxnreg_probe.py and PERF.md section
// 7). B2's producer keeps watch for them instead: it waits, trapping,
// until they have released every stage, so a lost completion still
// ends the launch with an error.
__device__ __forceinline__ void mbar_spin(uint32_t bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One [128 x 64] box of a rank-4 (d, heads, seq, b) tensor map at
// (col, head, row, batch) into shared memory; rows and columns outside
// the tensor are zero-filled.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int col, int head,
                                             int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
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

// Named barrier `id` over the 256 consumer threads: sync waits for the
// barrier, arrive counts this thread and moves on.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers after a wait: the compiler may not move
// their uses above it (it sees the asynchronous writes as done when the
// wgmma was issued).
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

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared
// memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
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

template <int kD>
__device__ __forceinline__ void wgmma_rs(float (&d)[kD / 8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kD == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const Params p) {
  using Cfg = FwdCfg<kD>;
  constexpr int kN = Cfg::kN, kStages = Cfg::kStages, kBoxes = Cfg::kBoxes;
  static_assert(kN == 64, "S = Q K^T runs as m64n64k16");
  constexpr int kQBox = kFwdRows * 128, kKVBox = kN * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  auto k_s = [&](int st) { return base + Cfg::kQBytes + st * Cfg::kKVBytes; };
  auto v_s = [&](int st) {
    return base + Cfg::kQBytes + (kStages + st) * Cfg::kKVBytes;
  };
  const uint32_t bars = base + Cfg::kQBytes + 2 * kStages * Cfg::kKVBytes;
  const uint32_t q_full = bars;
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int n_qt = (p.seq_q + kFwdRows - 1) / kFwdRows;
  const int qt = n_qt - 1 - blockIdx.x;  // the longest causal rows first
  const int head = blockIdx.y, bi = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  const int q0 = qt * kFwdRows;
  // Causal: the tile's last row sees kv tiles up to its own index. Tile
  // 0 comes first, so every row has a finite max before any tile that
  // masks all of its columns.
  int n_kt = (p.seq_k + kN - 1) / kN;
  if (p.causal) {
    const int last_row = min(q0 + kFwdRows - 1, p.seq_q - 1);
    n_kt = min(n_kt, last_row / kN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer warp
  if (wg == 2) {
    // Producer: one thread issues every load.
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Cfg::kQBytes);
      for (int bx = 0; bx < kBoxes; ++bx)
        tma_load_box(q_s + bx * kQBox, &map_q, q_full, bx * 64, head, q0, bi);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), (it / kStages - 1) & 1);
        mbar_expect_tx(full_k(st), Cfg::kKVBytes);
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_box(k_s(st) + bx * kKVBox, &map_k, full_k(st), bx * 64,
                       kvh, it * kN, bi);
        mbar_expect_tx(full_v(st), Cfg::kKVBytes);
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_box(v_s(st) + bx * kKVBox, &map_v, full_v(st), bx * 64,
                       kvh, it * kN, bi);
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows q0 + 64 c .. + 63; warp w of it
    // rows + 16 w + g and + 8 (lane = 4 g + t), as the wgmma accumulator
    // lays them out. Tile it's S = Q K^T runs on the tensor cores while
    // tile it - 1's O += P V is issued right behind it, so the softmax
    // of tile it overlaps that product.
    const int c = wg;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_base = q0 + 64 * c + 16 * warp + g;

    float o[kD / 8][4];
    zero(o);
    float m[2] = {kNegInf, kNegInf};  // running max of the scaled logits
    float l[2] = {0.f, 0.f};          // this thread's share of the row sum
    float s[kN / 8][4];
    uint32_t pa[kN / 16][4];

    // S = Q K^T [64 x kN] of ring stage st: 16 columns of the reduction
    // a step; a step inside a 64-column box moves the start by 32 bytes.
    auto issue_s = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(
            s, smem_desc(q_s + (kk / 4) * kQBox + c * 64 * 128 + col, 16, 1024),
            smem_desc(k_s(st) + (kk / 4) * kKVBox + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: V [kN kv rows x kD] is MN-major; a step of 16 kv rows
    // moves 2048 bytes, the second 64-column box sits kKVBox on.
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<kD>(o, pa[kk], smem_desc(v_s(st) + kk * 2048, kKVBox, 1024));
      wgmma_commit();
    };
    // The online softmax of tile it in s, in the first design's
    // arithmetic (so B1 gives its bits): x = s scale, masked to NEG_INF
    // on tiles that cross the diagonal or the ragged edge, p = exp(x - m).
    // Returns the rescale of the rows' earlier sums in corr.
    auto softmax = [&](int it, float (&corr)[2]) {
      const int k0 = it * kN;
      const bool masked = (p.causal && k0 + kN - 1 > q0 + 64 * c) ||
                          k0 + kN > p.seq_k;
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
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
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = quad_max(mt[r]);  // the new running max of the row
        corr[r] = expf(m[r] - mt[r]);
        m[r] = mt[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(s[nt][e] - m[e >> 1]);
          s[nt][e] = pe;
          rs[e >> 1] += pe;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
    };

    // The two warpgroups take turns issuing their products (named
    // barriers 1 and 2, 256 threads each): one's softmax runs while the
    // other's products hold the tensor cores. Warpgroup 1 opens the turn
    // of warpgroup 0; each issues n_kt + 1 times, and the last turn of
    // warpgroup 1 hands nothing on, so every arrival is consumed.
    auto my_turn = [&]() { named_sync(1 + c); };
    auto pass_turn = [&]() { named_arrive(2 - c); };
    if (c == 1) named_arrive(1);
    mbar_wait(q_full, 0);
    mbar_wait(full_k(0), 0);
    my_turn();
    wgmma_fence();
    issue_s(0);
    pass_turn();
    wgmma_wait<0>();
    fence_operands(s);
    float corr[2];
    softmax(0, corr);
    to_a<kN / 8>(pa, s);  // P in bf16, in the accumulator layout: A of P V
    for (int it = 1; it < n_kt; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      mbar_wait(full_k(st), (it / kStages) & 1);
      mbar_wait(full_v(prev), ((it - 1) / kStages) & 1);
      my_turn();
      wgmma_fence();
      issue_s(st);
      issue_pv(prev);
      pass_turn();
      wgmma_wait<1>();  // S done; P V of tile it - 1 still running
      fence_operands(s);
      softmax(it, corr);
      wgmma_wait<0>();
      // P V has read pa and written o: only now may pa's registers take
      // other values, and o and the next P be touched.
      fence_operands(o);
      fence_operands(pa);
      fence_operands(s);
      if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        o[dt][0] *= corr[0];
        o[dt][1] *= corr[0];
        o[dt][2] *= corr[1];
        o[dt][3] *= corr[1];
      }
      to_a<kN / 8>(pa, s);
    }
    const int last = (n_kt - 1) % kStages;
    mbar_wait(full_v(last), ((n_kt - 1) / kStages) & 1);
    my_turn();
    wgmma_fence();
    issue_pv(last);
    if (c == 0) pass_turn();
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(pa);

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
    store_rows<kD>(
        p.out + (static_cast<long long>(bi) * p.seq_q * p.h + head) * p.d,
        row_stride, q0 + 64 * c + 16 * warp, p.seq_q, p.d, o, o_div, lane);
    if (t == 0) {
      float* lse = p.lse + (static_cast<long long>(bi) * p.h + head) * p.seq_q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + r * 8;
        if (row < p.seq_q) lse[row] = m[r] + logf(div[r]);
      }
    }
  }
}

// ---- B2: backward, TMA + wgmma, warp-specialised ----------------------------
//
// Both kernels run 384 threads: warpgroups 0 and 1 are consumers of 64
// rows each of the tile the block owns (128 q rows for dq, 128 kv rows
// for dk/dv), warpgroup 2 the producer. ptxas gives a block of 288
// threads the registers of a block of 384 (168 a thread), and dk and dv
// alone take 128 a thread, so the producer warpgroup gives its
// registers up with setmaxnreg.dec (kProducerRegs) and the consumers
// take kConsumerRegs (tools/setmaxnreg_probe.py: 0 spills). The owned
// tile's two tensors (Q and dO; K and V) are loaded once; the other two
// stream through a ring of 64-row tiles in the 128-byte swizzle, with
// full and empty mbarriers per stage. Products and order of sums are the
// first design's (mma.sync over 64-row tiles), so B2 keeps its bits:
// S and dP over the head dim in 16-wide steps ascending, dq over kv
// tiles ascending, dk and dv over (query head, q tile) ascending, each
// in 16-row steps ascending.

constexpr int kBwdThreads = 384;
constexpr int kBwdRows = 128;  // rows of the owned tile
constexpr int kBwdN = 64;      // rows of a streamed tile
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int kD>
struct BwdCfg {
  static constexpr int kStages = 4;
  static constexpr int kBoxes = kD / 64;
  static constexpr int kOwnBox = kBwdRows * 128;  // one box of an owned tensor
  static constexpr int kRingBox = kBwdN * 128;    // one box of a streamed one
  static constexpr int kOwnBytes = kBoxes * kOwnBox;
  static constexpr int kRingBytes = kBoxes * kRingBox;
  static constexpr int kStatBytes = 2 * kBwdN * 4;  // lse and delta (dk/dv)
  static constexpr int kBars = 2 * kOwnBytes + 2 * kStages * kRingBytes +
                               kStages * kStatBytes;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The shared-memory layout both kernels share (offsets from a
// 1024-byte-aligned base): the owned tile's tensors a and b, the ring's
// tensors a and b per stage, the stats slots, then the barriers: the
// owned tile's, then full and empty per stage.
template <int kD>
struct BwdSmem {
  using Cfg = BwdCfg<kD>;
  uint32_t base;
  unsigned char* ptr;  // generic address of base
  __device__ explicit BwdSmem(unsigned char* raw) {
    const uint32_t r = smem_addr(raw);
    base = (r + 1023) & ~1023u;
    ptr = raw + (base - r);
  }
  __device__ uint32_t own(int i) const { return base + i * Cfg::kOwnBytes; }
  __device__ uint32_t ring(int i, int st) const {
    return base + 2 * Cfg::kOwnBytes + (i * Cfg::kStages + st) * Cfg::kRingBytes;
  }
  __device__ float* stats(int st) const {
    return reinterpret_cast<float*>(
        ptr + 2 * Cfg::kOwnBytes + 2 * Cfg::kStages * Cfg::kRingBytes +
        st * Cfg::kStatBytes);
  }
  __device__ uint32_t own_full() const { return base + Cfg::kBars; }
  __device__ uint32_t full(int st) const { return base + Cfg::kBars + 8 * (1 + st); }
  __device__ uint32_t empty(int st) const {
    return base + Cfg::kBars + 8 * (1 + Cfg::kStages + st);
  }
  __device__ void init(int full_count) const {
    mbar_init(own_full(), 1);
    for (int st = 0; st < Cfg::kStages; ++st) {
      mbar_init(full(st), full_count);
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// Both tensors of a tile (kD / 64 boxes each) onto one barrier.
template <int kD>
__device__ __forceinline__ void tma_load_pair(uint32_t dst_a, uint32_t dst_b,
                                              const CUtensorMap* map_a,
                                              const CUtensorMap* map_b,
                                              uint32_t bar, int box_bytes,
                                              int head, int row, int batch) {
  mbar_expect_tx(bar, 2 * (kD / 64) * box_bytes);
  for (int bx = 0; bx < kD / 64; ++bx) {
    tma_load_box(dst_a + bx * box_bytes, map_a, bar, bx * 64, head, row, batch);
    tma_load_box(dst_b + bx * box_bytes, map_b, bar, bx * 64, head, row, batch);
  }
}

// d[64 x 64] = A[64 x kD] . B[64 x kD]^T, A (64 rows from a_row of an
// owned box of a_box bytes) and B (a streamed tile) K-major in the
// 128-byte swizzle: 16 columns of the reduction a step, a step inside a
// 64-column box moves the start by 32 bytes.
template <int kD>
__device__ __forceinline__ void issue_nt(float (&d)[8][4], uint32_t a,
                                         int a_box, uint32_t b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64(d, smem_desc(a + (kk / 4) * a_box + col, 16, 1024),
                 smem_desc(b + (kk / 4) * b_box + col, 16, 1024), kk > 0);
  }
}

// acc[64 x kD] += A[64 x 64] . B[64 x kD], A as bf16 fragments in
// registers, B a streamed tile read MN-major: a step of 16 rows moves
// 2048 bytes, the second 64-column box sits kRingBox on.
template <int kD>
__device__ __forceinline__ void issue_nn(float (&acc)[kD / 8][4],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBwdN / 16; ++kk)
    wgmma_rs<kD>(acc, a[kk],
                 smem_desc(b + kk * 2048, BwdCfg<kD>::kRingBox, 1024));
}

// dq. Grid (q tiles of 128 rows, h, b), the longest causal rows first.
// Q and dO are loaded once; K and V stream in 64-row tiles. Each tile:
// S = Q K^T and dP = dO V^T (SS), dS = exp(S scale - lse) (dP - delta)
// scale in registers, rounded to bf16 as the A operand of dq += dS K (K
// MN-major from the same stage). Tile it's S and dP are issued ahead of
// tile it - 1's dS K, so dS of tile it is computed while that product
// runs, and the two warpgroups take turns issuing (named barriers 1 and
// 2, as in B1), so one's dS overlaps the other's products.
template <int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const Params p) {
  using Cfg = BwdCfg<kD>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<kD> sm(smem_raw);
  const uint32_t q_s = sm.own(0), do_s = sm.own(1);

  const int n_qt = (p.seq_q + kBwdRows - 1) / kBwdRows;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBwdRows;
  const int head = blockIdx.y, bi = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  // kv tiles the block's rows see: under a causal mask, up to the one
  // that holds its last row. Both warpgroups run them all (they take
  // turns). Warpgroup 0's 64 rows may end before the last tile starts:
  // there its dS is all zeros, which leaves dq as it is, bit for bit.
  int n_kt = (p.seq_k + kBwdN - 1) / kBwdN;
  if (p.causal)
    n_kt = min(n_kt, min(q0 + kBwdRows - 1, p.seq_q - 1) / kBwdN + 1);

  if (threadIdx.x == 0) sm.init(1);
  __syncthreads();

  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      tma_load_pair<kD>(q_s, do_s, &map_q, &map_do, sm.own_full(),
                        Cfg::kOwnBox, head, q0, bi);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(sm.empty(st), (it / kStages - 1) & 1);
        tma_load_pair<kD>(sm.ring(0, st), sm.ring(1, st), &map_k, &map_v,
                          sm.full(st), Cfg::kRingBox, kvh, it * kBwdN, bi);
      }
      for (int it = max(0, n_kt - kStages); it < n_kt; ++it)  // the watch
        mbar_wait(sm.empty(it % kStages), (it / kStages) & 1);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_base = q0 + 64 * c + 16 * warp + g;  // rows + 0, + 8
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
    float s[8][4], dp[8][4];
    uint32_t dsa[4][4];
    const uint32_t q_c = q_s + c * 64 * 128, do_c = do_s + c * 64 * 128;
    auto issue_s_dp = [&](int st) {
      issue_nt<kD>(s, q_c, Cfg::kOwnBox, sm.ring(0, st), Cfg::kRingBox);
      issue_nt<kD>(dp, do_c, Cfg::kOwnBox, sm.ring(1, st), Cfg::kRingBox);
      wgmma_commit();
    };
    auto issue_dq = [&](int st) {
      issue_nn<kD>(dq, dsa, sm.ring(0, st));
      wgmma_commit();
    };
    // dS of tile it in s, from S in s and dP in dp.
    auto grad_s = [&](int it) {
      const int k0 = it * kBwdN;
      const bool masked =
          (p.causal && k0 + kBwdN - 1 > q0 + 64 * c) || k0 + kBwdN > p.seq_k;
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
          s[nt][e] = pe * (dp[nt][e] - dl[e >> 1]) * p.scale;
        }
      }
    };
    auto my_turn = [&]() { named_sync(1 + c); };
    auto pass_turn = [&]() { named_arrive(2 - c); };
    if (c == 1) named_arrive(1);
    mbar_spin(sm.own_full(), 0);
    mbar_spin(sm.full(0), 0);
    my_turn();
    wgmma_fence();
    issue_s_dp(0);
    pass_turn();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    grad_s(0);
    to_a<8>(dsa, s);  // dS in bf16, in the accumulator layout: A of dS K
    for (int it = 1; it < n_kt; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      mbar_spin(sm.full(st), (it / kStages) & 1);
      my_turn();
      wgmma_fence();
      issue_s_dp(st);
      issue_dq(prev);
      pass_turn();
      wgmma_wait<1>();  // S and dP done; dS K of tile it - 1 running
      fence_operands(s);
      fence_operands(dp);
      grad_s(it);
      wgmma_wait<0>();
      // dS K of tile it - 1 has read dsa and written dq: only now may
      // dsa take tile it's dS, and its K/V stage be refilled.
      fence_operands(dq);
      fence_operands(dsa);
      fence_operands(s);
      if (lane == 0) mbar_arrive(sm.empty(prev));
      to_a<8>(dsa, s);
    }
    my_turn();
    wgmma_fence();
    issue_dq((n_kt - 1) % kStages);
    if (c == 0) pass_turn();
    wgmma_wait<0>();
    fence_operands(dq);
    fence_operands(dsa);
    if (lane == 0) mbar_arrive(sm.empty((n_kt - 1) % kStages));  // the watch
    const float one[2] = {1.f, 1.f};
    store_rows<kD>(
        p.dq + (static_cast<long long>(bi) * p.seq_q * p.h + head) * p.d,
        static_cast<long long>(p.h) * p.d, q0 + 64 * c + 16 * warp, p.seq_q,
        p.d, dq, one, lane);
  }
}

// dk / dv. Grid (kv tiles of 128 rows, kh, b), kv tile 0 (the most q
// tiles under a causal mask) first. K and V are loaded once; Q and dO
// stream in 64-row tiles over the group's query heads and, for each,
// the q tiles at or past the diagonal (head-major, q tiles ascending,
// the first design's walk); the producer warp copies each tile's lse
// and delta (compact [b, h, seq_q] f32 rows, not 16-byte aligned in
// general) into the stage's slot before it arrives on the stage's full
// barrier. Each step: S^T = K Q^T and dP^T = V dO^T (SS), P^T =
// exp(S^T scale - lse[col]) rounded to bf16 for dv += P^T dO, dS^T =
// P^T (dP^T - delta[col]) scale from the f32 P^T rounded to bf16 for
// dk += dS^T Q (dO and Q MN-major from the same stage). No product sits
// behind a branch: warpgroup 1 also runs the q tile of each head that
// its kv rows cannot see under a causal mask (all masked: P^T and dS^T
// are zeros, which leave dk and dv as they are, bit for bit), and a
// warpgroup past seq_k runs on zero-filled rows it never stores.
template <int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const Params p) {
  using Cfg = BwdCfg<kD>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<kD> sm(smem_raw);
  const uint32_t k_s = sm.own(0), v_s = sm.own(1);

  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int group = p.h / p.kh;
  const int k0 = blockIdx.x * kBwdRows;
  const int n_qt = (p.seq_q + kBwdN - 1) / kBwdN;
  const int first_qt = p.causal ? min(k0 / kBwdN, n_qt) : 0;
  const int per_head = n_qt - first_qt;
  const int n_it = group * per_head;

  // Full barriers: the producer warp's 32 lanes (lane 0 with the bytes).
  if (threadIdx.x == 0) sm.init(32);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 288 && n_it > 0) {
      const int lane = threadIdx.x % 32;
      if (lane == 0)
        tma_load_pair<kD>(k_s, v_s, &map_k, &map_v, sm.own_full(),
                          Cfg::kOwnBox, kvh, k0, bi);
      for (int j = 0; j < n_it; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(sm.empty(st), (j / kStages - 1) & 1);
        const int head = kvh * group + j / per_head;
        const int q0 = (first_qt + j % per_head) * kBwdN;
        const long long stat0 =
            (static_cast<long long>(bi) * p.h + head) * p.seq_q;
        float* slot = sm.stats(st);
        for (int r = lane; r < kBwdN; r += 32) {
          const int row = q0 + r;
          slot[r] = row < p.seq_q ? p.lse_in[stat0 + row] : 0.f;
          slot[kBwdN + r] = row < p.seq_q ? p.delta[stat0 + row] : 0.f;
        }
        if (lane == 0)
          tma_load_pair<kD>(sm.ring(0, st), sm.ring(1, st), &map_q, &map_do,
                            sm.full(st), Cfg::kRingBox, head, q0, bi);
        else
          mbar_arrive(sm.full(st));
      }
      for (int j = max(0, n_it - kStages); j < n_it; ++j)  // the watch
        mbar_wait(sm.empty(j % kStages), (j / kStages) & 1);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int kc0 = k0 + 64 * c;  // this warpgroup's first kv row
    const int n_base = kc0 + 16 * warp + lane / 4;  // kv rows + 0, + 8
    const uint32_t k_c = k_s + c * 64 * 128, v_c = v_s + c * 64 * 128;
    float dk[kD / 8][4], dv[kD / 8][4];
    zero(dk);
    zero(dv);
    if (n_it > 0) mbar_spin(sm.own_full(), 0);
    for (int j = 0; j < n_it; ++j) {
      const int st = j % kStages;
      const int q0 = (first_qt + j % per_head) * kBwdN;
      mbar_spin(sm.full(st), (j / kStages) & 1);
      {
        float s[8][4], dp[8][4];
        wgmma_fence();
        issue_nt<kD>(s, k_c, Cfg::kOwnBox, sm.ring(0, st), Cfg::kRingBox);
        issue_nt<kD>(dp, v_c, Cfg::kOwnBox, sm.ring(1, st), Cfg::kRingBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
        fence_operands(dp);
        const float* lse_t = sm.stats(st);
        const float* dl_t = lse_t + kBwdN;
        const bool masked =
            (p.causal && kc0 + 63 > q0) || q0 + kBwdN > p.seq_q;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int mi = nt * 8 + 2 * t + (e & 1);  // q row in the tile
            float x = s[nt][e] * p.scale;
            if (masked) {
              const int n = n_base + (e >> 1) * 8;
              const int row = q0 + mi;
              if (row >= p.seq_q || (p.causal && n > row)) x = kNegInf;
            }
            const float pe = expf(x - lse_t[mi]);
            s[nt][e] = pe;
            dp[nt][e] = pe * (dp[nt][e] - dl_t[mi]) * p.scale;  // dS^T
          }
        }
        uint32_t pa[4][4], dsa[4][4];
        to_a<8>(pa, s);
        to_a<8>(dsa, dp);
        wgmma_fence();
        issue_nn<kD>(dv, pa, sm.ring(1, st));
        issue_nn<kD>(dk, dsa, sm.ring(0, st));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dk);
        fence_operands(dv);
        fence_operands(pa);
        fence_operands(dsa);
      }
      if (lane == 0) mbar_arrive(sm.empty(st));
    }
    const float one[2] = {1.f, 1.f};
    const long long row_stride = static_cast<long long>(p.kh) * p.d;
    const long long base =
        (static_cast<long long>(bi) * p.seq_k * p.kh + kvh) * p.d;
    store_rows<kD>(p.dk + base, row_stride, kc0 + 16 * warp, p.seq_k, p.d,
                   dk, one, lane);
    store_rows<kD>(p.dv + base, row_stride, kc0 + 16 * warp, p.seq_k, p.d,
                   dv, one, lane);
  }
}

// ---- launch ---------------------------------------------------------------

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

// A rank-4 (d, heads, seq, b) map of a [b, seq, heads, d] bf16 tensor
// read through its strides, boxes of [rows x 64 columns] in the
// 128-byte swizzle: rows past seq of one (b, head) slice and columns
// past d are zero-filled, never the next slice's.
int tensor_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
               int b, const Strides& st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(b)};
  // A dimension of size 1 may carry any stride: give it the packed one.
  const long long sh = heads == 1 ? d : st.h;
  const long long ss = seq == 1 ? heads * sh : st.s;
  const long long sb = b == 1 ? seq * ss : st.b;
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(sh) * 2,
                               static_cast<cuuint64_t>(ss) * 2,
                               static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int kD>
int launch_fwd(const void* q, const void* k, const void* v, const Params& p,
               cudaStream_t stream) {
  constexpr int kN = FwdCfg<kD>::kN;
  CUtensorMap maps[3];
  int rc = tensor_map(&maps[0], q, p.d, p.h, p.seq_q, p.b, p.sq, kFwdRows);
  if (!rc) rc = tensor_map(&maps[1], k, p.d, p.kh, p.seq_k, p.b, p.sk, kN);
  if (!rc) rc = tensor_map(&maps[2], v, p.d, p.kh, p.seq_k, p.b, p.sv, kN);
  if (rc) return rc;
  const size_t smem = FwdCfg<kD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq_q + kFwdRows - 1) / kFwdRows, p.h, p.b);
  flash_fwd_kernel<kD><<<grid, kFwdThreads, smem, stream>>>(maps[0], maps[1],
                                                            maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

// B2: the four rank-4 maps (Q and dO over seq_q and the query heads, K
// and V over seq_k and the kv heads), the owned tensors in boxes of 128
// rows and the streamed ones in boxes of 64, then one launch.
template <int kD, bool kDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const Params& p, cudaStream_t stream) {
  const int q_rows = kDq ? kBwdRows : kBwdN, kv_rows = kDq ? kBwdN : kBwdRows;
  CUtensorMap maps[4];
  int rc = tensor_map(&maps[0], q, p.d, p.h, p.seq_q, p.b, p.sq, q_rows);
  if (!rc)
    rc = tensor_map(&maps[1], dout, p.d, p.h, p.seq_q, p.b, p.sdo, q_rows);
  if (!rc) rc = tensor_map(&maps[2], k, p.d, p.kh, p.seq_k, p.b, p.sk, kv_rows);
  if (!rc) rc = tensor_map(&maps[3], v, p.d, p.kh, p.seq_k, p.b, p.sv, kv_rows);
  if (rc) return rc;
  auto kernel = kDq ? flash_dq_kernel<kD> : flash_dkv_kernel<kD>;
  const size_t smem = BwdCfg<kD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kDq ? p.seq_q : p.seq_k;
  const dim3 grid((rows + kBwdRows - 1) / kBwdRows, kDq ? p.h : p.kh, p.b);
  kernel<<<grid, kBwdThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                              maps[3], p);
  return static_cast<int>(cudaGetLastError());
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
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.d <= 64) return launch_fwd<64>(q, k, v, p, s);
  return launch_fwd<128>(q, k, v, p, s);
}

int dlr_flash_backward_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, const long long* dims,
                          const long long* strides, float scale,
                          void* stream) {
  Params p = {};
  int rc = fill(&p, dims, strides, 4, scale);
  if (rc) return rc;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.d <= 64) return launch_bwd<64, true>(q, k, v, dout, p, s);
  return launch_bwd<128, true>(q, k, v, dout, p, s);
}

int dlr_flash_backward_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv,
                           const long long* dims, const long long* strides,
                           float scale, void* stream) {
  Params p = {};
  int rc = fill(&p, dims, strides, 4, scale);
  if (rc) return rc;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.d <= 64) return launch_bwd<64, false>(q, k, v, dout, p, s);
  return launch_bwd<128, false>(q, k, v, dout, p, s);
}

// Dynamic shared memory a launch takes: B1 (backward = 0) or either B2
// kernel (backward = 1; dq and dk/dv share one layout), at head dim d.
int dlr_flash_smem_bytes(int backward, int d) {
  if (backward) return d <= 64 ? BwdCfg<64>::kSmem : BwdCfg<128>::kSmem;
  return d <= 64 ? FwdCfg<64>::kSmem : FwdCfg<128>::kSmem;
}

const char* dlr_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
