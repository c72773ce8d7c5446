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
// (2 n d V flops), dx and dw two each, against ~99 MB of inputs. Design,
// simple and right first:
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
//     thread), and loops over 32-column vocab tiles; dw: a block owns 32
//     vocab columns, each warp keeping 128 d rows x 32 columns, and loops
//     over 32-row tiles. The second product needs the whole [d, 32]
//     operand at once, so dx keeps two w tiles [d x 32] (swizzled, 64 KB
//     each) and dw two x tiles [32 x d]: the next tile loads while this
//     one computes. The 32 x 32 logits tile splits its K = d across warp
//     quarters, summed in a fixed order through shared memory. Each
//     logits tile is computed once per (row tile, vocab tile): recompute
//     factor 1, so the backward pair runs four logits-sized products
//     beyond B3's one (the TPU kernels run the same five);
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
constexpr int kDwRows = 32, kDwCols = 32;
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

// acc[16 MT x 8 NT] += At^T . B; At stored as [16 KC rows][16 MT columns]
// (lda), i.e. A's rows are At's columns; B row-major (ldb).
template <int MT, int KC, int NT>
__device__ __forceinline__ void mma_tr(float (&acc)[MT][NT][4], const bf16* at,
                                       int lda, const bf16* b, int ldb,
                                       int lane) {
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t bf[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t q[4];
      ldmatrix_x4_trans(q, b + (kc * 16 + r + (i % 2) * 8) * ldb + nt * 8 +
                               (i / 2) * 8);
      bf[nt][0] = q[0];
      bf[nt][1] = q[1];
      bf[nt + 1][0] = q[2];
      bf[nt + 1][1] = q[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, at + (kc * 16 + (lane / 16) * 8 + r) * lda +
                                mt * 16 + (i % 2) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
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

// ---- B4: dw ---------------------------------------------------------------
//
// Grid: 32-column vocab tiles. Shared: the swizzled w tile [d][32]
// (resident), two x tiles [32][d + 8] (the next row tile loads while this
// one computes), the g tile [32][32 + 8] and the K-split partial logits.
// Warp w owns dw rows [128 w, 128 w + 128) of all 32 columns.

__global__ void __launch_bounds__(kThreads, 1) ce_dw_kernel(Params p) {
  constexpr int ldg = kDwCols + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = p.d + 8;
  const int x_tile = kDwRows * ldx;
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* x_s = w_s + p.d * kDwCols;
  bf16* g_s = x_s + 2 * x_tile;
  float* part = reinterpret_cast<float*>(g_s + kDwRows * ldg);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kDwCols;
  const int n_rt = (p.n + kDwRows - 1) / kDwRows;
  const bool owns_d = warp * kWarpD < p.d;
  const Swizzled32 w{w_s};

  load_w_tile(w_s, p, col0);
  load_rows<kDwRows>(x_s, ldx, p.x, p.d, 0, p.n, 0, p.d, p.d);
  cp_async_commit();

  float acc[kWarpD / 16][kDwCols / 8][4];
#pragma unroll
  for (int mt = 0; mt < kWarpD / 16; ++mt) zero(acc[mt]);

  for (int rt = 0; rt < n_rt; ++rt) {
    cp_async_wait<0>();  // row tile rt has landed
    __syncthreads();     // and row tile rt - 1's buffer, g_s and part are free
    if (rt + 1 < n_rt) {
      load_rows<kDwRows>(x_s + ((rt + 1) % 2) * x_tile, ldx, p.x, p.d,
                         (rt + 1) * kDwRows, p.n, 0, p.d, p.d);
      cp_async_commit();
    }
    const bf16* xt = x_s + (rt % 2) * x_tile;
    const RowStats st =
        row_stats(p, rt * kDwRows + (warp % 2) * 16 + lane / 4);
    float s[4][4];
    logits_32x32(s, xt, ldx, w, p.d, part, warp, lane);
    if (warp < 2)
      store_g(g_s + warp * 16 * ldg, ldg, s, st, col0, p.v, lane);
    __syncthreads();
    if (owns_d)
      mma_tr<kWarpD / 16, kDwRows / 16, kDwCols / 8>(
          acc, xt + warp * kWarpD, ldx, g_s, ldg, lane);
  }

  if (!owns_d) return;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kWarpD / 16; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* out =
          p.dw + static_cast<long long>(warp * kWarpD + mt * 16 + g + 8 * h) *
                     p.v;
#pragma unroll
      for (int nt = 0; nt < kDwCols / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + nt * 8 + 2 * t + j;
          if (col < p.v) out[col] = acc[mt][nt][2 * h + j];
        }
      }
    }
  }
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
  const size_t smem = bf16_bytes(static_cast<long long>(p.d) * kDwCols) +
                      bf16_bytes(2 * kDwRows * (p.d + 8)) +
                      bf16_bytes(kDwRows * (kDwCols + 8)) +
                      kPartFloats * sizeof(float);
  return launch(ce_dw_kernel, (p.v + kDwCols - 1) / kDwCols, smem, p,
                static_cast<cudaStream_t>(stream));
}

const char* dlr_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
