// Single-query (decode-step) attention over a per-row-filled KV cache,
// flat or paged, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels dlrover_tpu/ops/decode_attention.py::
// decode_attention (Pallas bodies _kernel and _kernel_q8) and
// ::paged_decode_attention (_paged_kernel and _paged_kernel_q8), all
// over _decode_body. The two share this file's body and differ only in
// how a logical cache row becomes an address: the flat cache is
// [b, max_len, kh, d]; the paged one is a pool [num_blocks, block_size,
// kh, d] shared by all sequences, and logical row r of sequence b lives
// at pool row block_tables[b, r / block_size] * block_size +
// r % block_size. Same math: for every (row b, query head), an online
// softmax over the cache rows < min(length[b], max_len), f32
// accumulation, GQA by giving one block all query heads of a kv head,
// and for int8 caches the per-(row, head) K scale multiplying the
// logits and the V scale multiplying p before p.v (the softmax
// denominator keeps the unscaled p). A row of length 0 writes zeros.
//
// Bound on the H100: device-memory bytes. Each step reads every filled
// K/V row once (2 * fill * kh * d * itemsize bytes per row of the
// batch, plus 8 bytes of scales per row and head for int8), at a few
// flops per byte, far below the card's ~295 bf16 flops per byte.
// Design against that bound:
//   - one thread block per (b, kv head), all running at once (the TPU
//     ran this grid cell after cell); query heads of the group share
//     every K/V byte the block reads;
//   - the loop covers only the filled rows, so a ragged batch reads
//     no padding;
//   - the paged kernel follows the table itself, per 16-byte vector of
//     a row (a tile of 32 to 128 rows spans several pool blocks that
//     need not be adjacent; the table entries sit in L1), so no
//     gathered copy of the cache is ever written. It reads a table
//     entry only for rows below the fill: entries past it are stale
//     and may name another sequence's block. Pool offsets are size_t
//     (a pool of a few GiB passes 2^31 elements);
//   - K/V tiles of 16 KB each are loaded with 16-byte vector loads into
//     registers while the previous tile is being computed from shared
//     memory (a two-stage software pipeline), so load latency overlaps
//     the math.
// Not done yet (later perf work): split-K across blocks for small
// b * kh, TMA and wgmma.
//
// Plain C interface, bound with ctypes (ops/_ext.py): no PyTorch
// headers, so nvcc builds this file in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGroup = 8;  // query heads per block; blockIdx.z splits more
constexpr float kNegInf = -1e30f;
static_assert(kMaxGroup == kWarps, "softmax phase: one warp per head");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

// Global -> registers for the K/V tile starting at row `base`; rows
// past the fill are zero and never read from the cache (nor is their
// table entry).
template <typename KVT, bool kPaged, int kMaxVecs, int kVecElems>
__device__ __forceinline__ void load_tile(uint4 (&k_reg)[kMaxVecs],
                                          uint4 (&v_reg)[kMaxVecs],
                                          const KVT* k_head,
                                          const KVT* v_head, int base, int n,
                                          size_t row_stride, int vecs_per_row,
                                          int tile_vecs, const int* table_row,
                                          int block_size) {
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / vecs_per_row;
    const int c = idx - r * vecs_per_row;
    uint4 kz = make_uint4(0u, 0u, 0u, 0u);
    uint4 vz = kz;
    if (idx < tile_vecs && base + r < n) {
      const size_t off =
          cache_row<kPaged>(base + r, table_row, block_size) * row_stride +
          c * kVecElems;
      kz = __ldg(reinterpret_cast<const uint4*>(k_head + off));
      vz = __ldg(reinterpret_cast<const uint4*>(v_head + off));
    }
    k_reg[i] = kz;
    v_reg[i] = vz;
  }
}

// QT: type of q and out (f32 or bf16). KVT: cache type (QT, or int8
// with kQuant). kPaged: k/v (and the scales) are pools read through
// `tables` [b, max_blocks], and max_len is max_blocks * block_size.
// Grid (kh, b, ceil(g / kMaxGroup)), kThreads threads.
template <typename QT, typename KVT, bool kQuant, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const KVT* __restrict__ k,
                            const KVT* __restrict__ v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ length,
                            QT* __restrict__ out, int h, int kh,
                            int max_len, int d, float scale,
                            const int* __restrict__ tables, int block_size,
                            int max_blocks) {
  // 16 KB of K and of V per tile at d = 128, whatever the cache type.
  constexpr int kTile = 128 / sizeof(KVT);
  constexpr int kVecElems = 16 / sizeof(KVT);
  constexpr int kMaxVecs =
      kTile * kMaxHeadDim / kVecElems / kThreads;  // per thread, per tensor
  constexpr int kItems = kMaxGroup * kMaxHeadDim / kThreads;

  __shared__ __align__(16) KVT k_s[kTile * kMaxHeadDim];
  __shared__ __align__(16) KVT v_s[kTile * kMaxHeadDim];
  __shared__ float q_s[kMaxGroup * kMaxHeadDim];
  __shared__ float p_s[kMaxGroup * kTile];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float corr_s[kMaxGroup];
  // Paged int8: the pool row of each tile row, for the scale reads.
  __shared__ int row_s[(kQuant && kPaged) ? kTile : 1];

  const int ih = blockIdx.x;
  const int ib = blockIdx.y;
  const int g = h / kh;
  const int g0 = blockIdx.z * kMaxGroup;
  const int ng = min(kMaxGroup, g - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = max(0, min(length[ib], max_len));

  // This block's query heads: ih * g + g0 .. + ng, contiguous in q.
  const size_t head0 = static_cast<size_t>(ib) * h + ih * g + g0;
  for (int i = tid; i < ng * d; i += kThreads)
    q_s[i] = to_f32(q[head0 * d + i]);
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }

  const size_t row_stride = static_cast<size_t>(kh) * d;  // elements
  const size_t head_off =
      kPaged ? static_cast<size_t>(ih)
             : static_cast<size_t>(ib) * max_len * kh + ih;
  const int* table_row =
      kPaged ? tables + static_cast<size_t>(ib) * max_blocks : nullptr;
  const KVT* k_head = k + head_off * d;
  const KVT* v_head = v + head_off * d;
  const float* ks_head = kQuant ? k_scale + head_off : nullptr;  // stride kh
  const float* vs_head = kQuant ? v_scale + head_off : nullptr;

  const int vecs_per_row = d / kVecElems;
  const int tile_vecs = kTile * vecs_per_row;
  uint4 k_reg[kMaxVecs];
  uint4 v_reg[kMaxVecs];
  float acc[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) acc[i] = 0.f;

  const int n_tiles = (n + kTile - 1) / kTile;

  if (n_tiles > 0)
    load_tile<KVT, kPaged, kMaxVecs, kVecElems>(
        k_reg, v_reg, k_head, v_head, 0, n, row_stride, vecs_per_row,
        tile_vecs, table_row, block_size);
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * kTile;
    const int rows = min(kTile, n - base);
    __syncthreads();  // the previous tile's readers are done with k_s/v_s
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < tile_vecs) {
        reinterpret_cast<uint4*>(k_s)[idx] = k_reg[i];
        reinterpret_cast<uint4*>(v_s)[idx] = v_reg[i];
      }
    }
    if constexpr (kQuant && kPaged) {
      if (tid < rows)
        row_s[tid] = static_cast<int>(
            cache_row<true>(base + tid, table_row, block_size));
    }
    __syncthreads();
    if (t + 1 < n_tiles)  // in flight while this tile computes
      load_tile<KVT, kPaged, kMaxVecs, kVecElems>(
          k_reg, v_reg, k_head, v_head, base + kTile, n, row_stride,
          vecs_per_row, tile_vecs, table_row, block_size);

    // Logits: warp w takes rows w, w + kWarps, ...; lanes split d.
    for (int r = warp; r < rows; r += kWarps) {
      float s[kMaxGroup];
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) s[j] = 0.f;
      for (int e = lane; e < d; e += 32) {
        const float kv = to_f32(k_s[r * d + e]);
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j)
          if (j < ng) s[j] += q_s[j * d + e] * kv;
      }
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j)
        if (j < ng) s[j] = warp_sum(s[j]);
      if (lane == 0) {
        float ksc = 1.f;
        if constexpr (kQuant) {
          const size_t row = kPaged ? static_cast<size_t>(row_s[r])
                                    : static_cast<size_t>(base + r);
          ksc = ks_head[row * kh];
        }
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j) {
          if (j < ng) {
            float x = s[j] * scale;
            if (kQuant) x *= ksc;
            p_s[j * kTile + r] = x;
          }
        }
      }
    }
    __syncthreads();

    // Online softmax: warp j owns query head j (kMaxGroup == kWarps).
    if (warp < ng) {
      float* pj = p_s + warp * kTile;
      float mt = kNegInf;
      for (int r = lane; r < rows; r += 32) mt = fmaxf(mt, pj[r]);
      mt = warp_max(mt);
      const float m_old = m_s[warp];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        float p = expf(pj[r] - m_new);
        sum += p;
        // V dequant folds into p; l keeps the unscaled p.
        if constexpr (kQuant) {
          const size_t row = kPaged ? static_cast<size_t>(row_s[r])
                                    : static_cast<size_t>(base + r);
          p *= vs_head[row * kh];
        }
        pj[r] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[warp] = l_s[warp] * corr + sum;
        m_s[warp] = m_new;
        corr_s[warp] = corr;
      }
    }
    __syncthreads();

    // acc[j, e] = acc * corr_j + sum_r p[j, r] * V[r, e].
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = tid + i * kThreads;
      const int j = idx / d;
      const int e = idx - j * d;
      if (j < ng) {
        const float* pj = p_s + j * kTile;
        float a = acc[i] * corr_s[j];
        for (int r = 0; r < rows; ++r) a += pj[r] * to_f32(v_s[r * d + e]);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  QT* o = out + head0 * d;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = tid + i * kThreads;
    const int j = idx / d;
    if (j < ng) o[idx] = from_f32<QT>(acc[i] / fmaxf(l_s[j], 1e-30f));
  }
}

// What one launch reads besides its data pointers. `tables` is null
// for a flat cache; for a paged one max_len is max_blocks * block_size.
struct Shape {
  int b, h, kh, max_len, d;
  float scale;
  const void* tables;
  int block_size, max_blocks;
};

template <typename QT, typename KVT, bool kQuant, bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* length, void* out, const Shape& s,
           cudaStream_t stream) {
  const dim3 grid(s.kh, s.b, (s.h / s.kh + kMaxGroup - 1) / kMaxGroup);
  decode_attention_kernel<QT, KVT, kQuant, kPaged>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const QT*>(q), static_cast<const KVT*>(k),
          static_cast<const KVT*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(length),
          static_cast<QT*>(out), s.h, s.kh, s.max_len, s.d, s.scale,
          static_cast<const int*>(s.tables), s.block_size, s.max_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPaged>
int dispatch(int dtype, int quantized, const void* q, const void* k,
             const void* v, const void* ks, const void* vs,
             const void* length, void* out, const Shape& s,
             cudaStream_t stream) {
  if (s.b < 1 || s.kh < 1 || s.h % s.kh != 0 || s.d % 16 != 0 ||
      s.d > kMaxHeadDim || s.max_len < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    return quantized ? launch<__nv_bfloat16, int8_t, true, kPaged>(
                           q, k, v, ks, vs, length, out, s, stream)
                     : launch<__nv_bfloat16, __nv_bfloat16, false, kPaged>(
                           q, k, v, ks, vs, length, out, s, stream);
  }
  return quantized ? launch<float, int8_t, true, kPaged>(q, k, v, ks, vs,
                                                         length, out, s, stream)
                   : launch<float, float, false, kPaged>(q, k, v, ks, vs,
                                                         length, out, s, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, out, and an fp cache).
// quantized: 1 = int8 cache with f32 scales [b, max_len, kh].
// Returns a cudaError_t code; 0 on a clean launch.
int dlr_decode_attention(int dtype, int quantized, const void* q,
                         const void* k, const void* v, const void* k_scale,
                         const void* v_scale, const void* length, void* out,
                         int b, int h, int kh, int max_len, int d,
                         float scale, void* stream) {
  const Shape s{b, h, kh, max_len, d, scale, nullptr, 0, 0};
  return dispatch<false>(dtype, quantized, q, k, v, k_scale, v_scale, length,
                         out, s, static_cast<cudaStream_t>(stream));
}

// The paged variant: k, v are pools [num_blocks, block_size, kh, d]
// (k_scale, v_scale [num_blocks, block_size, kh]) and block_tables is
// int32 [b, max_blocks]. Entries at or past a row's fill are never read.
int dlr_paged_decode_attention(int dtype, int quantized, const void* q,
                               const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* block_tables, const void* length,
                               void* out, int b, int h, int kh,
                               int block_size, int max_blocks, int d,
                               float scale, void* stream) {
  if (block_tables == nullptr || block_size < 1 || max_blocks < 1 ||
      max_blocks > INT32_MAX / block_size)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{b, h, kh, max_blocks * block_size, d, scale, block_tables,
                block_size, max_blocks};
  return dispatch<true>(dtype, quantized, q, k, v, k_scale, v_scale, length,
                        out, s, static_cast<cudaStream_t>(stream));
}

const char* dlr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
