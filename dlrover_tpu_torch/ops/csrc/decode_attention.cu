// Single-query (decode-step) attention over a per-row-filled KV cache,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrover_tpu/ops/decode_attention.py::
// decode_attention (Pallas bodies _kernel and _kernel_q8 over
// _decode_body). Same math: for every (row b, query head), an online
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

// Global -> registers for the K/V tile starting at row `base`; rows
// past the fill are zero and never read from the cache.
template <typename KVT, int kMaxVecs, int kVecElems>
__device__ __forceinline__ void load_tile(uint4 (&k_reg)[kMaxVecs],
                                          uint4 (&v_reg)[kMaxVecs],
                                          const KVT* k_head,
                                          const KVT* v_head, int base, int n,
                                          size_t row_stride, int vecs_per_row,
                                          int tile_vecs) {
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / vecs_per_row;
    const int c = idx - r * vecs_per_row;
    uint4 kz = make_uint4(0u, 0u, 0u, 0u);
    uint4 vz = kz;
    if (idx < tile_vecs && base + r < n) {
      const size_t off =
          static_cast<size_t>(base + r) * row_stride + c * kVecElems;
      kz = __ldg(reinterpret_cast<const uint4*>(k_head + off));
      vz = __ldg(reinterpret_cast<const uint4*>(v_head + off));
    }
    k_reg[i] = kz;
    v_reg[i] = vz;
  }
}

// QT: type of q and out (f32 or bf16). KVT: cache type (QT, or int8
// with kQuant). Grid (kh, b, ceil(g / kMaxGroup)), kThreads threads.
template <typename QT, typename KVT, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const KVT* __restrict__ k,
                            const KVT* __restrict__ v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ length,
                            QT* __restrict__ out, int h, int kh,
                            int max_len, int d, float scale) {
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
  const size_t head_off = static_cast<size_t>(ib) * max_len * kh + ih;
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
    load_tile<KVT, kMaxVecs, kVecElems>(k_reg, v_reg, k_head, v_head, 0, n,
                                        row_stride, vecs_per_row, tile_vecs);
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
    __syncthreads();
    if (t + 1 < n_tiles)  // in flight while this tile computes
      load_tile<KVT, kMaxVecs, kVecElems>(k_reg, v_reg, k_head, v_head,
                                          base + kTile, n, row_stride,
                                          vecs_per_row, tile_vecs);

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
        const float ksc =
            kQuant ? ks_head[static_cast<size_t>(base + r) * kh] : 1.f;
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
        if (kQuant) p *= vs_head[static_cast<size_t>(base + r) * kh];
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

template <typename QT, typename KVT, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* length, void* out, int b, int h,
           int kh, int max_len, int d, float scale, cudaStream_t stream) {
  const dim3 grid(kh, b, (h / kh + kMaxGroup - 1) / kMaxGroup);
  decode_attention_kernel<QT, KVT, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<QT*>(out), h, kh, max_len, d, scale);
  return static_cast<int>(cudaGetLastError());
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
  if (b < 1 || kh < 1 || h % kh != 0 || d % 16 != 0 || d > kMaxHeadDim ||
      max_len < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return quantized
               ? launch<__nv_bfloat16, int8_t, true>(q, k, v, k_scale, v_scale,
                                                     length, out, b, h, kh,
                                                     max_len, d, scale, s)
               : launch<__nv_bfloat16, __nv_bfloat16, false>(
                     q, k, v, k_scale, v_scale, length, out, b, h, kh,
                     max_len, d, scale, s);
  }
  return quantized ? launch<float, int8_t, true>(q, k, v, k_scale, v_scale,
                                                 length, out, b, h, kh,
                                                 max_len, d, scale, s)
                   : launch<float, float, false>(q, k, v, k_scale, v_scale,
                                                 length, out, b, h, kh,
                                                 max_len, d, scale, s);
}

const char* dlr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
