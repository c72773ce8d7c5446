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
// (2 n d V flops), dx and dw two each, against ~99 MB of inputs. B3
// and dx (the first design):
//   - mma.sync.m16n8k16 bf16 -> f32 with ldmatrix (.trans for the
//     operands that are contiguous along the product's output), 8 warps;
//     tiles staged through shared memory with cp.async, rows padded by 16
//     bytes (or swizzled) so ldmatrix reads are free of bank conflicts;
//   - B3: a block owns 64 rows and keeps their x tile in shared memory;
//     w streams through a 5-stage ring of [64 d x 128 V] slices (the
//     contraction over d = 1024 is a K loop over them). Each warp owns 16
//     rows x 64 columns of a vocab tile and keeps its own online
//     (m, l, tl); the two column halves merge once at the end;
//   - the backward accumulators are larger than a block's registers at
//     64 rows ([64, 1024] f32 is 256 KB). dx: a block owns 32 rows, each
//     warp keeping 32 rows x 128 columns of d in registers (128 f32 a
//     thread), and loops over 32-column vocab tiles. The second product
//     needs the whole [d, 32] operand at once, so dx keeps two w tiles
//     [d x 32] (swizzled, 64 KB each): the next tile loads while this
//     one computes. The 32 x 32 logits tile splits its K = d across warp
//     quarters, summed in a fixed order through shared memory. Each
//     logits tile is computed once per (row tile, vocab tile): recompute
//     factor 1, so the backward pair runs four logits-sized products
//     beyond B3's one (the TPU kernels run the same five);
//   - dw runs on Hopper's own path (TMA, wgmma, a thread-block cluster
//     over d; see "B4: dw" below);
//   - one owner per output element and a fixed order of sums: no
//     atomics, and reruns are bitwise identical;
//   - the TPU ran its grid cell after cell and carried (m, l, tl) or the
//     accumulator in scratch; here the sequential axis is a loop inside
//     the block and the cells run as concurrent blocks;
//   - ragged edges: rows >= n are zero-filled by cp.async, carry zero
//     coefficients and are never stored; columns >= V are masked to
//     NEG_INF (exp gives 0) and never stored; the wrapper pads w's row
//     stride to a multiple of 8 elements so every row is 16-byte aligned.
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch
// headers, so nvcc builds this file in seconds.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarpD = 128;    // columns of d per warp in the backward
constexpr int kMaxD = 8 * kWarpD;
constexpr int kBK = 64;        // d-slice of one staged load
constexpr float kNegInf = -1e30f;  // ops/fused_ce.py NEG_INF

constexpr int kFwdRows = 64, kFwdCols = 128, kFwdStages = 5;
constexpr int kDxRows = 32, kDxCols = 32;
constexpr int kPartFloats = 6 * 512;  // K-split partial logits

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
  int n, d, v, ldw;
  float z_weight;
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

// ---- staging and warp-level products -------------------------------------
//
// Fragment layout of an m16n8 f32 accumulator c[4] (lane = 4 g + t):
// c[0], c[1] at row g, columns 2t, 2t + 1; c[2], c[3] at row g + 8.

// dst[r][c] = src[row0 + r][col0 + c] for r < kRows, c < cols (a multiple
// of 8); rows >= n_rows and columns >= n_cols are zero-filled.
template <int kRows>
__device__ __forceinline__ void load_rows(bf16* dst, int lds, const bf16* src,
                                          long long ld, int row0, int n_rows,
                                          int col0, int cols, int n_cols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool valid = row0 + r < n_rows && col0 + c < n_cols;
    const bf16* p =
        valid ? src + static_cast<long long>(row0 + r) * ld + col0 + c : src;
    cp_async16(dst + r * lds + c, p, valid);
  }
}

// Addresses of 8-element chunks of a bf16 tile in shared memory.
// Padded: row-major with row stride ld (ld = width + 8 keeps ldmatrix
// free of bank conflicts).
struct Padded {
  const bf16* base;
  int ld;
  __device__ __forceinline__ const bf16* operator()(int row, int col) const {
    return base + row * ld + col;
  }
};

// Swizzled: a [rows x 32] tile with unpadded 64-byte rows; chunk c of row
// r sits at chunk c ^ ((r / 2) % 4), so the 8 rows an ldmatrix reads at
// one logical chunk fall in 8 distinct bank groups. Saves the padding's
// 16 KB on a [1024 x 32] tile.
struct Swizzled32 {
  const bf16* base;
  __device__ __forceinline__ const bf16* operator()(int row, int col) const {
    return base + row * 32 + ((((col >> 3) ^ (row >> 1)) & 3) << 3);
  }
};

// acc[16 x 8 NT] += A[16 x 16 KC] . B[k0 .., n0 ..]; A row-major (lda) in
// shared memory, B a row-major [K x N] tile addressed by `b`.
template <int KC, int NT, typename BTile>
__device__ __forceinline__ void mma_rr(float (&acc)[NT][4], const bf16* a,
                                       int lda, const BTile& b, int k0,
                                       int n0, int lane) {
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane % 16) * lda + kc * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b(k0 + kc * 16 + r + (i % 2) * 8,
                              n0 + nt * 8 + (i / 2) * 8));
      mma_bf16(acc[nt], af, bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 MT x 8 NT] += A[16 MT x 16 KC] . B^T; A row-major (lda), B a tile
// whose rows are the output columns (row n0 + j, columns k = 0 ..),
// addressed by `b`.
template <int MT, int KC, int NT, typename BTile>
__device__ __forceinline__ void mma_rn(float (&acc)[MT][NT][4], const bf16* a,
                                       int lda, const BTile& b, int n0,
                                       int lane) {
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(af[mt],
                  a + (mt * 16 + lane % 16) * lda + kc * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b(n0 + nt * 8 + r + (i / 2) * 8, kc * 16 + (i % 2) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][nt], af[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// Per-row inputs of the backward for rows row and row + 8.
struct RowStats {
  int tgt[2];
  float logz[2], a[2], b[2];
};

__device__ __forceinline__ RowStats row_stats(const Params& p, int row) {
  RowStats s;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const bool ok = r < p.n;
    s.tgt[h] = ok ? p.tgt[r] : -1;
    s.logz[h] = ok ? p.logz_in[r] : 0.f;
    s.a[h] = ok ? p.coef_a[r] : 0.f;
    s.b[h] = ok ? p.coef_b[r] : 0.f;
  }
  return s;
}

// A warp's [16 x 8 NT] logits fragment (columns col0 ..) as g = a
// exp(logit - logz) - b [col == tgt], rounded to bf16, into dst (row
// stride ldd).
template <int NT>
__device__ __forceinline__ void store_g(bf16* dst, int ldd,
                                        const float (&s)[NT][4],
                                        const RowStats& st, int col0, int v,
                                        int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float gv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + nt * 8 + 2 * t + j;
        const float logit = col < v ? s[nt][2 * h + j] : kNegInf;
        const float pe = expf(logit - st.logz[h]);
        // a * p - b, rounded as the reference rounds it (no fused fma).
        gv[j] = __fsub_rn(__fmul_rn(st.a[h], pe),
                          col == st.tgt[h] ? st.b[h] : 0.f);
      }
      *reinterpret_cast<uint32_t*>(dst + (g + 8 * h) * ldd + nt * 8 + 2 * t) =
          pack_bf16(gv[0], gv[1]);
    }
  }
}

// Columns col0 .. col0 + 31 of all d rows of w into a swizzled [d x 32]
// tile; columns >= ldw are zero-filled.
__device__ __forceinline__ void load_w_tile(bf16* dst, const Params& p,
                                            int col0) {
  const Swizzled32 tile{dst};
  for (int i = threadIdx.x; i < p.d * 4; i += kThreads) {
    const int r = i / 4, c = (i % 4) * 8;
    const bool valid = col0 + c < p.ldw;
    const bf16* src =
        valid ? p.w + static_cast<long long>(r) * p.ldw + col0 + c : p.w;
    cp_async16(const_cast<bf16*>(tile(r, c)), src, valid);
  }
}

// The f32 logits of a 32-row x 32-column tile, x_s rows against w's
// columns, over K = d, split across the block's 8 warps: warp w computes
// rows (w % 2) * 16 .. + 16 over the K quarter w / 2. Quarters 1-3 go
// through `part` (6 x 512 floats) and are added to quarter 0 in a fixed
// order, so warps 0 and 1 return the tile's rows 0-15 and 16-31 in s.
template <typename BTile>
__device__ __forceinline__ void logits_32x32(float (&s)[4][4], const bf16* x_s,
                                             int ldx, const BTile& w, int d,
                                             float* part, int warp,
                                             int lane) {
  const int lr = warp % 2, kq = warp / 2, kd = d / 4;
  zero(s);
  for (int k0 = kq * kd; k0 < (kq + 1) * kd; k0 += 32)
    mma_rr<2, 4>(s, x_s + lr * 16 * ldx + k0, ldx, w, k0, 0, lane);
  if (kq > 0) {
    float* slot = part + ((kq - 1) * 2 + lr) * 512;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) slot[(nt * 4 + e) * 32 + lane] = s[nt][e];
  }
  __syncthreads();
  if (kq == 0) {
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const float* slot = part + ((q - 1) * 2 + lr) * 512;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += slot[(nt * 4 + e) * 32 + lane];
    }
  }
}

// ---- B3: forward --------------------------------------------------------
//
// Grid: 64-row tiles. Shared: the x tile [64][d + 8], a 5-stage ring of w
// slices [64][128 + 8], and [64][3] floats to merge the column halves.

__global__ void __launch_bounds__(kThreads, 1) ce_fwd_kernel(Params p) {
  constexpr int ldw = kFwdCols + 8;
  constexpr int kStage = kBK * ldw;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = p.d + 8;
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = x_s + kFwdRows * ldx;
  float* merge = reinterpret_cast<float*>(w_s + kFwdStages * kStage);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp % 4, wc = warp / 4;  // 16-row group, 64-column half
  const int row0 = blockIdx.x * kFwdRows;
  const int n_ks = p.d / kBK;
  const int n_vt = (p.v + kFwdCols - 1) / kFwdCols;
  const int total = n_vt * n_ks;

  // Iteration `it` is d-slice it % n_ks of vocab tile it / n_ks; one
  // commit group per iteration (empty past the end).
  auto load_w = [&](int it) {
    if (it < total) {
      const int vt = it / n_ks, ks = it % n_ks;
      load_rows<kBK>(w_s + (it % kFwdStages) * kStage, ldw, p.w, p.ldw,
                     ks * kBK, p.d, vt * kFwdCols, kFwdCols, p.ldw);
    }
    cp_async_commit();
  };
  load_rows<kFwdRows>(x_s, ldx, p.x, p.d, row0, p.n, 0, p.d, p.d);
  for (int it = 0; it < kFwdStages - 1; ++it) load_w(it);  // group 0: x too

  const int row = row0 + wr * 16 + g;  // rows row, row + 8
  int tg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    tg[h] = row + 8 * h < p.n ? p.tgt[row + 8 * h] : -1;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tl[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kFwdStages - 2>();  // iteration it's group has landed
    __syncthreads();  // and every warp is done with the stage refilled next
    load_w(it + kFwdStages - 1);
    const int ks = it % n_ks;
    mma_rr<kBK / 16, 8>(acc, x_s + wr * 16 * ldx + ks * kBK, ldx,
                        Padded{w_s + (it % kFwdStages) * kStage, ldw}, 0,
                        wc * 64, lane);
    if (ks != n_ks - 1) continue;

    // The vocab tile is complete: online logsumexp over its 64 columns.
    const int col0 = (it / n_ks) * kFwdCols + wc * 64;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < p.v ? acc[nt][e] : kNegInf;
        acc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
        if (col == tg[e >> 1]) tl[e >> 1] += x;
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += expf(acc[nt][e] - m[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rs[h]);
    zero(acc);
  }
  cp_async_wait<0>();

  // Merge the two column halves of each row (m, l, tl), then write.
#pragma unroll
  for (int h = 0; h < 2; ++h) tl[h] = quad_sum(tl[h]);
  if (wc == 1 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* slot = merge + (wr * 16 + g + 8 * h) * 3;
      slot[0] = m[h];
      slot[1] = l[h];
      slot[2] = tl[h];
    }
  }
  __syncthreads();
  if (wc == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= p.n) continue;
      const float* slot = merge + (wr * 16 + g + 8 * h) * 3;
      const float mm = fmaxf(m[h], slot[0]);
      const float ll = l[h] * expf(m[h] - mm) + slot[1] * expf(slot[0] - mm);
      const float lz = mm + logf(fmaxf(ll, 1e-30f));
      p.logz[r] = lz;
      p.per_tok[r] = lz - (tl[h] + slot[2]) + p.z_weight * (lz * lz);
    }
  }
}

// ---- B4: dx ---------------------------------------------------------------
//
// Grid: 32-row tiles. Shared: the x tile [32][d + 8] (resident), two
// swizzled w tiles [d][32] (the next vocab tile loads while this one
// computes), the g tile [32][32 + 8] and the K-split partial logits. Warp
// w owns dx columns [128 w, 128 w + 128) of all 32 rows.

__global__ void __launch_bounds__(kThreads, 1) ce_dx_kernel(Params p) {
  constexpr int ldg = kDxCols + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = p.d + 8;
  const int w_tile = p.d * kDxCols;
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = x_s + kDxRows * ldx;
  bf16* g_s = w_s + 2 * w_tile;
  float* part = reinterpret_cast<float*>(g_s + kDxRows * ldg);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kDxRows;
  const int n_vt = (p.v + kDxCols - 1) / kDxCols;
  const bool owns_d = warp * kWarpD < p.d;

  load_rows<kDxRows>(x_s, ldx, p.x, p.d, row0, p.n, 0, p.d, p.d);
  load_w_tile(w_s, p, 0);
  cp_async_commit();
  const RowStats st = row_stats(p, row0 + (warp % 2) * 16 + lane / 4);

  float acc[2][kWarpD / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) zero(acc[mt]);

  for (int vt = 0; vt < n_vt; ++vt) {
    cp_async_wait<0>();  // tile vt has landed
    __syncthreads();     // and tile vt - 1's buffer, g_s and part are free
    if (vt + 1 < n_vt) {
      load_w_tile(w_s + ((vt + 1) % 2) * w_tile, p, (vt + 1) * kDxCols);
      cp_async_commit();
    }
    const Swizzled32 w{w_s + (vt % 2) * w_tile};
    float s[4][4];
    logits_32x32(s, x_s, ldx, w, p.d, part, warp, lane);
    if (warp < 2)
      store_g(g_s + warp * 16 * ldg, ldg, s, st, vt * kDxCols, p.v, lane);
    __syncthreads();
    if (owns_d)
      mma_rn<2, kDxCols / 16, kWarpD / 8>(acc, g_s, ldg, w, warp * kWarpD,
                                          lane);
  }

  if (!owns_d) return;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + g + 8 * h;
      if (r >= p.n) continue;
      bf16* out = p.dx + static_cast<long long>(r) * p.d + warp * kWarpD;
#pragma unroll
      for (int nt = 0; nt < kWarpD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + nt * 8 + 2 * t) =
            pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
  }
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
//     store_g's rounding, is the register A operand of dw^T += g^T x
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
      // g^T in registers, rounded as store_g rounds g.
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

// ---- launch ---------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int blocks, size_t smem, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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

size_t bf16_bytes(long long elems) {
  return static_cast<size_t>(elems) * sizeof(bf16);
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

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code; 0 on a clean launch.

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
  const size_t smem = bf16_bytes(kFwdRows * (p.d + 8)) +
                      bf16_bytes(kFwdStages * kBK * (kFwdCols + 8)) +
                      kFwdRows * 3 * sizeof(float);
  return launch(ce_fwd_kernel, (p.n + kFwdRows - 1) / kFwdRows, smem, p,
                static_cast<cudaStream_t>(stream));
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
  const size_t smem = bf16_bytes(kDxRows * (p.d + 8)) +
                      bf16_bytes(2LL * p.d * kDxCols) +
                      bf16_bytes(kDxRows * (kDxCols + 8)) +
                      kPartFloats * sizeof(float);
  return launch(ce_dx_kernel, (p.n + kDxRows - 1) / kDxRows, smem, p,
                static_cast<cudaStream_t>(stream));
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

// Dynamic shared memory and cluster size of a dw launch at d.
int dlr_ce_dw_config(int d, int* smem, int* cluster) {
  if (d < 128 || d > 1024 || d % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = with_dw_config(d, SmemBytes{});
  *cluster = with_dw_config(d, ClusterSize{});
  return 0;
}

const char* dlr_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
