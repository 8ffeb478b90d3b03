// Flash attention for Hopper (sm_90a): online-softmax attention with causal
// and sliding-window masks and grouped KV heads (GQA), in the model layout
//     q, out (B, Sq, H, D)     k, v (B, Sk, Hkv, D)      row-major,
// all float32 (flash_attention_f32) or all bfloat16 (flash_attention_bf16),
// D = 64 or 128. Query head h reads KV head h / (H / Hkv). Scores, softmax
// and the output accumulator are float32; the output is rounded once.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (flash_attention_pallas). That kernel ran a grid (B, H, nq,
// nk) whose innermost KV axis was sequential, carrying the running max m,
// the denominator l and the accumulator acc across grid steps in VMEM, on
// inputs its wrapper had transposed to (B, H, S, D) and padded to 512-blocks.
// Blocks on this card run in parallel and in no order, so here one block
// owns a 64-query tile of one (batch, head) pair and walks the KV tiles
// itself, with m, l and acc in registers: 128 threads, thread (ty, tx) of
// the 8 x 16 layout owns query rows 8*ty .. 8*ty+7, score columns tx + 16*j
// of each 32-key tile and output columns tx + 16*j. Row maxima and sums go
// across the 16 threads of a row group by warp shuffles. The kernel indexes
// the (B, S, H, D) strides itself, so nothing is transposed or padded:
// query rows past Sq are neither loaded nor stored, and keys at or past
// seq_k score NEG_INF with zero values, exactly as the reference's padded
// keys do.
//
// Semantics kept from the reference: scores are (q * scale) . k in float32;
// masked scores are NEG_INF = -2^30, not -inf, so a tile in which a row has
// no valid key adds exp(0) = 1 per key to l and the row's m stays NEG_INF
// until a valid key wipes it with alpha = exp(NEG_INF - m) = 0 (no NaN ever
// appears); a KV tile is skipped when it lies wholly above the causal
// diagonal or wholly behind every query's window, with the reference's test
// (kernel.py:53-60) at this kernel's tile sizes; the output is acc / max(l,
// 1e-37). A row with no valid key at all therefore comes out as the mean of
// the values of the tiles it walked, which depends on the tile size, as in
// the reference; self-attention never has such a row.
//
// What bounds it: operations. Causal prefill at S = 2048, H = 28, D = 128 is
// 2 * S^2 * D * H = 30 GFLOP a layer, 30 us at the bf16 tensor-core rate.
// This first version computes Q K^T and P V in float32 on the CUDA cores from
// tiles widened to float32 in shared memory (73 KB a block), as the
// reference computes them, so it is far from that bound; bf16 mma/wgmma
// tiles (which round P to bf16 before P V) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;   // -2**30, as the reference
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per KV tile
constexpr int THREADS = 128;  // 8 row groups x 16 column threads
constexpr int RG = 16;        // threads per row group
constexpr int TR = BQ / (THREADS / RG);   // 8 query rows per thread
constexpr int TC = BK / RG;               // 2 score columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qt [D][BQ+1], Kt [D][BK+1], Vs [BK][D], Pt [BK][BQ+1] (float32); the +1
  // keeps the transposing stores off a single bank
  return sizeof(float) *
         (D * (BQ + 1) + D * (BK + 1) + BK * D + BK * (BQ + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
             int H, int Hkv, int seq_k, float scale, int causal,
             int has_window, int window) {
  constexpr int DT = D / RG;   // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                   // [D][BQ + 1], pre-scaled
  float* Kt = Qt + D * (BQ + 1);      // [D][BK + 1]
  float* Vs = Kt + D * (BK + 1);      // [BK][D]
  float* Pt = Vs + BK * D;            // [BK][BQ + 1]

  const int tid = threadIdx.x;
  const int ty = tid / RG;
  const int tx = tid % RG;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_row = (size_t)H * D;       // stride of one position
  const size_t kv_row = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * D;
  T* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int s = q_start + r;
    Qt[d * (BQ + 1) + r] =
        s < Sq ? to_f32(qb[(size_t)s * q_row + d]) * scale : 0.0f;
  }

  float m[TR], l[TR], acc[TR][DT];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (seq_k + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    // tile-level skip, the reference's test: wholly in the future (causal)
    // or wholly behind every query's window
    bool relevant = true;
    if (causal) relevant = k_start <= q_start + BQ - 1;
    if (has_window) relevant = relevant && (k_start + BK - 1 > q_start - window);
    if (!relevant) continue;   // uniform over the block

    __syncthreads();   // the previous tile's Kt, Vs and Pt are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int key = k_start + c;
      const bool in = key < seq_k;
      Kt[d * (BK + 1) + c] = in ? to_f32(kb[(size_t)key * kv_row + d]) : 0.0f;
      Vs[c * D + d] = in ? to_f32(vb[(size_t)key * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[TR], bk[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = Qt[d * (BQ + 1) + ty * TR + i];
#pragma unroll
      for (int j = 0; j < TC; ++j) bk[j] = Kt[d * (BK + 1) + tx + RG * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int q_pos = q_start + ty * TR + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int k_pos = k_start + tx + RG * j;
        bool ok = k_pos < seq_k;
        if (causal) ok = ok && q_pos >= k_pos;
        if (has_window) ok = ok && (q_pos - k_pos < window);
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = RG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Pt[(tx + RG * j) * (BQ + 1) + ty * TR + i] = p;
      }
#pragma unroll
      for (int off = RG / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[TR], vv[DT];
#pragma unroll
      for (int i = 0; i < TR; ++i) p[i] = Pt[c * (BQ + 1) + ty * TR + i];
#pragma unroll
      for (int j = 0; j < DT; ++j) vv[j] = Vs[c * D + tx + RG * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int s = q_start + ty * TR + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store(&ob[(size_t)s * q_row + tx + RG * j], acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
             int H, int Hkv, int seq_k, float scale, int causal,
             int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, Sq, Sk, H, Hkv, seq_k, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
           int H, int Hkv, int D, int seq_k, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  if (D == 64)
    return launch_d<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                           causal, has_window, window, stream);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                            causal, has_window, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a head
// size other than 64 or 128, which the wrapper refuses first).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int seq_k,
                                   float scale, int causal, int has_window,
                                   int window, cudaStream_t stream) {
  return launch<float>(q, k, v, o, B, Sq, Sk, H, Hkv, D, seq_k, scale,
                       causal, has_window, window, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int B, int Sq, int Sk, int H, int Hkv,
                                    int D, int seq_k, float scale, int causal,
                                    int has_window, int window,
                                    cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, D, seq_k, scale,
                               causal, has_window, window, stream);
}
