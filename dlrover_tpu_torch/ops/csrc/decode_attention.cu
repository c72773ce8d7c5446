// Single-query (decode-step) attention over a per-row-filled KV cache,
// flat or paged, written by hand for Hopper (sm_90a) as split-K flash
// decoding.
//
// Replaces the TPU kernels dlrover_tpu/ops/decode_attention.py::
// decode_attention (Pallas bodies _kernel and _kernel_q8) and
// ::paged_decode_attention (_paged_kernel and _paged_kernel_q8), all
// over _decode_body. The two share this file's body and differ only in
// how a logical cache row becomes an address: the flat cache is
// [b, max_len, kh, d]; the paged one is a pool [num_blocks, block_size,
// kh, d] shared by all sequences, and logical row r of sequence b lives
// at pool row block_tables[b, r / block_size] * block_size +
// r % block_size. Same math: for every (row b, query head), a softmax
// over the cache rows < min(length[b], max_len), f32 accumulation, GQA
// by giving one block all query heads of a kv head (at most 8;
// blockIdx.z splits larger groups), and for int8 caches the
// per-(row, head) K scale multiplying the logits and the V scale
// multiplying p before p.v (the softmax denominator keeps the unscaled
// p). A row of length 0 writes zeros.
//
// Bound on the H100: device-memory bytes. Each step reads every filled
// K/V row once (2 * fill * kh * d * itemsize bytes per row of the
// batch, plus 8 bytes of scales per row and head for int8), at a few
// flops per byte, far below the card's ~295 bf16 flops per byte. At the
// serving shapes (b = 8-16, kh = 8) one block per (row, kv head) gives
// 64-128 blocks for 132 SMs, and the longest row walks its cache alone.
// Design against that bound:
//   - split-K: the grid is (split x kv head, row, group chunk). A split
//     owns split_rows (64-256, chosen by the wrapper from max_len so
//     that b * kh * splits fills the SMs several times over) contiguous
//     cache rows; a split at or past its row's fill exits at once, so a
//     ragged batch costs nothing for padding;
//   - inside a split, lanes are split over d: a lane owns 8 elements of
//     a row (one 16-byte load of bf16, two of f32, one 8-byte load of
//     int8), a row takes pow2(d / 8) lanes, a warp 32 / that rows at
//     once. Each lane holds its 8 columns of the group's (<= 8) query
//     heads in registers, so every K/V byte is read once and serves the
//     whole group; a row's dot products finish with log2(lanes) xor
//     shuffles that run for all the warp's rows at once (no serial
//     per-row reduction). K loads are issued 8 (f32: 4) row passes
//     ahead; the first V loads are issued before the softmax phase;
//   - two passes over the split's rows: logits to shared memory, the
//     split's max and sum per head (one warp a head), then P.V into
//     per-lane f32 accumulators, summed across the warp's row groups by
//     shuffles and across the 4 warps through shared memory in a fixed
//     order;
//   - a row whose fill fits one split writes its output directly. Else
//     each split writes its partial (m, l, acc[g, d] in f32) to scratch
//     the wrapper allocates, and the last split of a (row, kv head,
//     group chunk) to finish, found through a ticket counter that it
//     resets to 0, combines the partials in split order. One launch per
//     call; results are bitwise the same from run to run;
//   - the paged kernel follows the table itself, per row; it reads a
//     table entry only for rows below the fill (entries past it are
//     stale and may name another sequence's block). Pool offsets are
//     size_t (a pool of a few GiB passes 2^31 elements). The paged int8
//     path keeps each row's pool row in shared memory (row_s) for the
//     V-scale reads of the softmax phase.
// ptxas -v (sm_90a, CUDA 12.8): the 8 instantiations use 128-154
// registers, 0 bytes of spills, 24,644-25,668 bytes of static shared
// memory (chip_smoke.py's ptxas line; PERF.md section 6).
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch
// headers, so nvcc builds this file in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGroup = 8;        // query heads per block
constexpr int kMaxSplitRows = 256;  // cache rows per split
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Eight consecutive cache elements of one row, as loaded by one lane.
template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  uint4 a;
};
template <>
struct Vec8<float> {
  uint4 a, b;
};
template <>
struct Vec8<int8_t> {
  uint2 a;
};

__device__ __forceinline__ void load8(Vec8<__nv_bfloat16>& v,
                                      const __nv_bfloat16* p) {
  v.a = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load8(Vec8<float>& v, const float* p) {
  v.a = __ldg(reinterpret_cast<const uint4*>(p));
  v.b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
}
__device__ __forceinline__ void load8(Vec8<int8_t>& v, const int8_t* p) {
  v.a = __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void zero8(Vec8<__nv_bfloat16>& v) {
  v.a = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero8(Vec8<float>& v) {
  v.a = v.b = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero8(Vec8<int8_t>& v) {
  v.a = make_uint2(0u, 0u);
}

__device__ __forceinline__ void unpack8(float (&x)[8],
                                        const Vec8<__nv_bfloat16>& v) {
  const uint32_t w[4] = {v.a.x, v.a.y, v.a.z, v.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(float (&x)[8], const Vec8<float>& v) {
  x[0] = __uint_as_float(v.a.x);
  x[1] = __uint_as_float(v.a.y);
  x[2] = __uint_as_float(v.a.z);
  x[3] = __uint_as_float(v.a.w);
  x[4] = __uint_as_float(v.b.x);
  x[5] = __uint_as_float(v.b.y);
  x[6] = __uint_as_float(v.b.z);
  x[7] = __uint_as_float(v.b.w);
}
__device__ __forceinline__ void unpack8(float (&x)[8], const Vec8<int8_t>& v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = i < 4 ? v.a.x : v.a.y;
    x[i] = static_cast<float>(static_cast<int8_t>((w >> (8 * (i & 3))) & 0xffu));
  }
}

// Where logical row r (below the fill) of this sequence lives, in rows
// from the head base: r itself in a flat cache, the pool row named by
// the sequence's table row in a paged one.
template <bool kPaged>
__device__ __forceinline__ size_t cache_row(int r, const int* table_row,
                                            int block_size) {
  if constexpr (kPaged) {
    const int blk = r / block_size;
    return static_cast<size_t>(__ldg(table_row + blk)) * block_size +
           (r - blk * block_size);
  } else {
    return static_cast<size_t>(r);
  }
}

// What one launch reads. `tables` is null for a flat cache; for a paged
// one max_len is max_blocks * block_size. part_acc [b * h, n_splits, d]
// and part_ml [b * h, n_splits, 2] (f32) and tickets [b * kh * gz]
// (int32, zero between calls) are used only when n_splits > 1.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* length;
  void* out;
  const int* tables;
  float* part_acc;
  float* part_ml;
  int* tickets;
  int b, h, kh, max_len, d, block_size, max_blocks, split_rows, n_splits;
  float scale;
};

// QT: type of q and out (f32 or bf16). KVT: cache type (QT, or int8
// with kQuant). kPaged: k/v (and the scales) are pools read through
// `tables` [b, max_blocks].
// Grid (n_splits * kh, b, ceil(g / kMaxGroup)), kThreads threads.
template <typename QT, typename KVT, bool kQuant, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  constexpr int kU = sizeof(KVT) == 4 ? 4 : 8;  // row passes in flight

  __shared__ float s_s[kMaxGroup][kMaxSplitRows];  // logits, then p
  __shared__ float red_s[kWarps][kMaxGroup * kMaxHeadDim];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ int last_s;
  // Paged int8: the pool row of each split row, for the V-scale reads.
  __shared__ int row_s[(kQuant && kPaged) ? kMaxSplitRows : 1];

  const int split = blockIdx.x % p.n_splits;
  const int ih = blockIdx.x / p.n_splits;
  const int ib = blockIdx.y;
  const int kh = p.kh, d = p.d;
  const int g = p.h / kh;
  const int g0 = blockIdx.z * kMaxGroup;
  const int ng = min(kMaxGroup, g - g0);
  const int n = max(0, min(p.length[ib], p.max_len));
  const int S = p.split_rows;
  // Splits holding rows below the fill; split 0 always runs (a row of
  // fill 0 writes zeros from it).
  const int n_active = max(1, (n + S - 1) / S);
  if (split >= n_active) return;
  const int r0 = split * S;
  const int rows = max(0, min(n, r0 + S) - r0);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // A row takes L lanes (a power of two >= d / 8), each 8 columns; a
  // warp covers R rows at once, the block kPass.
  const int chunks = d / 8;
  const int L = chunks <= 2 ? 2 : chunks <= 4 ? 4 : chunks <= 8 ? 8 : 16;
  const int R = 32 / L;
  const int kPass = kWarps * R;
  const int c = lane % L;
  const int rg = lane / L;
  const bool col_ok = c < chunks;
  const int my_row0 = warp * R + rg;  // the lane's row within a pass

  const QT* q = static_cast<const QT*>(p.q);
  const size_t head0 = static_cast<size_t>(ib) * p.h + ih * g + g0;
  float qr[kMaxGroup][8];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[j][e] = (j < ng && col_ok) ? to_f32(q[(head0 + j) * d + c * 8 + e])
                                    : 0.f;

  const size_t row_stride = static_cast<size_t>(kh) * d;  // elements
  const size_t head_off =
      kPaged ? static_cast<size_t>(ih)
             : static_cast<size_t>(ib) * p.max_len * kh + ih;
  const int* table_row =
      kPaged ? p.tables + static_cast<size_t>(ib) * p.max_blocks : nullptr;
  const KVT* k_head = static_cast<const KVT*>(p.k) + head_off * d + c * 8;
  const KVT* v_head = static_cast<const KVT*>(p.v) + head_off * d + c * 8;
  const float* ks_head = kQuant ? p.k_scale + head_off : nullptr;  // stride kh
  const float* vs_head = kQuant ? p.v_scale + head_off : nullptr;

  // Rows base + u * kPass + my_row0 of the split, u < kU, into buf; rows
  // past the split's fill are zero and never read (nor is their table
  // entry).
  Vec8<KVT> buf[kU];
  auto load_pass = [&](const KVT* head, int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = base + u * kPass + my_row0;
      if (r < rows && col_ok)
        load8(buf[u], head + cache_row<kPaged>(r0 + r, table_row,
                                               p.block_size) * row_stride);
      else
        zero8(buf[u]);
    }
  };

  // Pass 1: logits.
  const int chunk_rows = kU * kPass;
  for (int base = 0; base < rows; base += chunk_rows) {
    load_pass(k_head, base);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (base + u * kPass >= rows) break;  // uniform across the block
      const int r = base + u * kPass + my_row0;
      float x[8];
      unpack8(x, buf[u]);
      float s[kMaxGroup];
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a += qr[j][e] * x[e];
        s[j] = a;
      }
      for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      if (c == 0 && r < rows) {
        float ksc = 1.f;
        if constexpr (kQuant) {
          const size_t row = cache_row<kPaged>(r0 + r, table_row,
                                               p.block_size);
          ksc = ks_head[row * kh];
          if constexpr (kPaged) row_s[r] = static_cast<int>(row);
        }
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j) {
          if (j < ng) {
            float xs = s[j] * p.scale;
            if (kQuant) xs *= ksc;
            s_s[j][r] = xs;
          }
        }
      }
    }
  }
  // The first V rows fly while the softmax phase runs.
  if (rows > 0) load_pass(v_head, 0);
  __syncthreads();

  // The split's softmax: warp w owns query heads w, w + kWarps.
  for (int j = warp; j < ng; j += kWarps) {
    float mt = kNegInf;
    for (int r = lane; r < rows; r += 32) mt = fmaxf(mt, s_s[j][r]);
    mt = warp_max(mt);
    float sum = 0.f;
    for (int r = lane; r < rows; r += 32) {
      float pe = expf(s_s[j][r] - mt);
      sum += pe;
      // V dequant folds into p; l keeps the unscaled p.
      if constexpr (kQuant) {
        const size_t row = kPaged ? static_cast<size_t>(row_s[r])
                                  : static_cast<size_t>(r0 + r);
        pe *= vs_head[row * kh];
      }
      s_s[j][r] = pe;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[j] = mt;
      l_s[j] = sum;
    }
  }
  __syncthreads();

  // Pass 2: acc[j][e] = sum_r p[j, r] V[r, c * 8 + e].
  float acc[kMaxGroup][8];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  for (int base = 0; base < rows; base += chunk_rows) {
    if (base > 0) load_pass(v_head, base);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = base + u * kPass + my_row0;
      if (r >= rows) continue;
      float x[8];
      unpack8(x, buf[u]);
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) {
        const float pj = j < ng ? s_s[j][r] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] += pj * x[e];
      }
    }
  }
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
  if (rg == 0 && col_ok) {
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j)
      if (j < ng)
#pragma unroll
        for (int e = 0; e < 8; ++e) red_s[warp][j * d + c * 8 + e] = acc[j][e];
  }
  __syncthreads();

  const int items = ng * d;
  if (n_active == 1) {
    QT* o = static_cast<QT*>(p.out) + head0 * d;
    for (int i = tid; i < items; i += kThreads) {
      const float a = red_s[0][i] + red_s[1][i] + red_s[2][i] + red_s[3][i];
      o[i] = from_f32<QT>(a / fmaxf(l_s[i / d], 1e-30f));
    }
    return;
  }

  // A partial of this split, then a ticket: the last split to arrive
  // combines.
  const int ns = p.n_splits;
  for (int i = tid; i < items; i += kThreads) {
    const int j = i / d, e = i - j * d;
    p.part_acc[((head0 + j) * ns + split) * d + e] =
        red_s[0][i] + red_s[1][i] + red_s[2][i] + red_s[3][i];
  }
  if (tid < ng) {
    p.part_ml[((head0 + tid) * ns + split) * 2] = m_s[tid];
    p.part_ml[((head0 + tid) * ns + split) * 2 + 1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  int* ticket =
      p.tickets + (static_cast<size_t>(ib) * gridDim.z + blockIdx.z) * kh + ih;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == n_active - 1;
  __syncthreads();
  if (!last_s) return;
  if (tid == 0) *ticket = 0;
  __threadfence();

  QT* o = static_cast<QT*>(p.out) + head0 * d;
  for (int i = tid; i < items; i += kThreads) {
    const int j = i / d, e = i - j * d;
    const float* ml = p.part_ml + (head0 + j) * ns * 2;
    const float* pa = p.part_acc + (head0 + j) * ns * d + e;
    float m = kNegInf;
    for (int s = 0; s < n_active; ++s) m = fmaxf(m, __ldcg(ml + 2 * s));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const float w = expf(__ldcg(ml + 2 * s) - m);
      l += __ldcg(ml + 2 * s + 1) * w;
      a += __ldcg(pa + static_cast<size_t>(s) * d) * w;
    }
    o[i] = from_f32<QT>(a / fmaxf(l, 1e-30f));
  }
}

template <typename QT, typename KVT, bool kQuant, bool kPaged>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.n_splits * p.kh, p.b,
                  (p.h / p.kh + kMaxGroup - 1) / kMaxGroup);
  decode_attention_kernel<QT, KVT, kQuant, kPaged>
      <<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPaged>
int dispatch(int dtype, int quantized, const Params& p, cudaStream_t stream) {
  if (p.b < 1 || p.b > 65535 || p.kh < 1 || p.h % p.kh != 0 ||
      p.d % 16 != 0 || p.d < 16 || p.d > kMaxHeadDim || p.max_len < 1 ||
      (dtype != 0 && dtype != 1) || p.split_rows < 1 ||
      p.split_rows > kMaxSplitRows || p.n_splits < 1 ||
      static_cast<long long>(p.n_splits) * p.split_rows <
          static_cast<long long>(p.max_len) ||
      static_cast<long long>(p.n_splits) * p.kh > 2147483647LL ||
      (p.n_splits > 1 &&
       (p.part_acc == nullptr || p.part_ml == nullptr ||
        p.tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    return quantized
               ? launch<__nv_bfloat16, int8_t, true, kPaged>(p, stream)
               : launch<__nv_bfloat16, __nv_bfloat16, false, kPaged>(p, stream);
  }
  return quantized ? launch<float, int8_t, true, kPaged>(p, stream)
                   : launch<float, float, false, kPaged>(p, stream);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* length,
                   void* out, void* part_acc, void* part_ml, void* tickets,
                   int b, int h, int kh, int max_len, int d, int split_rows,
                   int n_splits, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(ks);
  p.v_scale = static_cast<const float*>(vs);
  p.length = static_cast<const int*>(length);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.tickets = static_cast<int*>(tickets);
  p.b = b;
  p.h = h;
  p.kh = kh;
  p.max_len = max_len;
  p.d = d;
  p.split_rows = split_rows;
  p.n_splits = n_splits;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, out, and an fp cache).
// quantized: 1 = int8 cache with f32 scales [b, max_len, kh].
// split_rows, n_splits: the split-K partition of max_len (n_splits *
// split_rows >= max_len, split_rows <= 256). With n_splits > 1,
// part_acc (f32 [b * h, n_splits, d]), part_ml (f32 [b * h, n_splits,
// 2]) and tickets (int32 [b * ceil(h / kh / 8) * kh], zero, and left
// zero) are scratch the caller owns; one launch per call.
// Returns a cudaError_t code; 0 on a clean launch.
int dlr_decode_attention(int dtype, int quantized, const void* q,
                         const void* k, const void* v, const void* k_scale,
                         const void* v_scale, const void* length, void* out,
                         void* part_acc, void* part_ml, void* tickets, int b,
                         int h, int kh, int max_len, int d, int split_rows,
                         int n_splits, float scale, void* stream) {
  const Params p =
      make_params(q, k, v, k_scale, v_scale, length, out, part_acc, part_ml,
                  tickets, b, h, kh, max_len, d, split_rows, n_splits, scale);
  return dispatch<false>(dtype, quantized, p,
                         static_cast<cudaStream_t>(stream));
}

// The paged variant: k, v are pools [num_blocks, block_size, kh, d]
// (k_scale, v_scale [num_blocks, block_size, kh]) and block_tables is
// int32 [b, max_blocks]; max_len is max_blocks * block_size. Entries at
// or past a row's fill are never read.
int dlr_paged_decode_attention(int dtype, int quantized, const void* q,
                               const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* block_tables, const void* length,
                               void* out, void* part_acc, void* part_ml,
                               void* tickets, int b, int h, int kh,
                               int block_size, int max_blocks, int d,
                               int split_rows, int n_splits, float scale,
                               void* stream) {
  if (block_tables == nullptr || block_size < 1 || max_blocks < 1 ||
      max_blocks > INT32_MAX / block_size)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, k_scale, v_scale, length, out, part_acc,
                         part_ml, tickets, b, h, kh, max_blocks * block_size,
                         d, split_rows, n_splits, scale);
  p.tables = static_cast<const int*>(block_tables);
  p.block_size = block_size;
  p.max_blocks = max_blocks;
  return dispatch<true>(dtype, quantized, p,
                        static_cast<cudaStream_t>(stream));
}

const char* dlr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
