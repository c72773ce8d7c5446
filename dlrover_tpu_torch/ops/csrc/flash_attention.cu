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
//   - registers: ptxas holds this kernel to 168 a thread (as for 384
//     threads, also with one producer warp and with setmaxnreg), so the
//     S tile is [64 x 64]: [64 x 128] beside O [64 x 128] and P spilled
//     and serialised every wgmma;
//   - the softmax keeps the first design's arithmetic (x = s scale,
//     p = expf(x - m) over 64-column tiles), and B1 gives its bits
//     exactly. Cheaper exponents run faster but move every downstream
//     bit (tools/torch_flash_exp_ab.py; PERF.md section 6);
//   - causal: only the tiles that cross the diagonal or the ragged edge
//     apply the mask; the blocks with the most kv tiles start first.
// The backward (B2), still the first design: mma.sync.m16n8k16 bf16 ->
// f32 in 4 warps over 64-row tiles staged through a two-buffer cp.async
// ring; the GQA sum of dk/dv stays inside one block (it loops over the
// group's query heads), so there are no atomics and the result is
// deterministic; a ragged tail is zero-filled by cp.async, masked with
// NEG_INF, and never stored.
// ptxas -v (sm_90a, CUDA 12.8): flash_fwd_kernel<128> 168 registers,
// 0 bytes of spills, 164,968 bytes of dynamic shared memory; <64> 155
// registers, 0 spills, 83,048 bytes; flash_dq_kernel<128> 170 and
// flash_dkv_kernel<128> 254 registers, 0 spills (chip_smoke.py's ptxas
// line; PERF.md section 6).
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch
// headers, so nvcc builds this file in seconds.

#include <cuda.h>
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
