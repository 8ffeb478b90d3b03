// Column-masked GEMM for Hopper (sm_90a):
//     C[m, n] = mask[n] * sum_k A[m, k] * B[k, n]
// A (M, K), B (K, N), C (M, N) row-major, all float32 (masked_matmul_f32) or
// all bfloat16 (masked_matmul_bf16); mask (N,) float32. Products and sums are
// float32 in both; the bf16 entry rounds each output once, as it is stored.
//
// Replaces the TPU kernel src/repro/kernels/masked_matmul/kernel.py:_mm_kernel
// (masked_matmul_pallas). That kernel carried an fp32 VMEM accumulator across
// the sequential K steps of its grid and applied the mask when the last K step
// finished. Blocks on this card run in parallel and in no order, so each block
// here owns one 64x64 output tile and walks the whole K range itself, keeping
// the accumulator in registers; the mask multiply stays in the epilogue, so a
// pruned column is written as an exact 0 (acc * 0.0f).
//
// What bounds it: the edge's conv layers (im2col, M = output pixels up to
// 3025, K up to 3456, N up to 384) are operation-bound at fp32; the batch-1
// dense layers (M = 1, B up to 9216 x 4096) are bound by reading B once from
// device memory. This first version is a plain shared-memory tiled GEMM on
// the CUDA cores: 64x64 output tiles, 16-deep K slices staged in shared
// memory, 256 threads computing 4x4 outputs each from registers. Edges of M,
// N and K are bounds-checked (zero-filled in shared memory) instead of padded,
// so the wrapper makes no padded copies. It does not use the tensor cores
// (TF32 would change the numerics the reference fixes at fp32), and at M = 1
// it uses one row of each 64-row tile: wgmma/TMA tiles, fusing the int8
// dequant into the B-tile load, and a GEMV path for M = 1 are later work.
//
// The bf16 entry serves the pruned transformer's FFN up and gate products
// (M = B*S, K = d_model, N = d_ff; Qwen2-7B: K = 3584, N = 18944). It is the
// same tile loop with the operands widened to float32 as they are staged in
// shared memory, so it computes what the reference computes (bf16 operands,
// fp32 accumulation) but on the CUDA cores. At M = 2048 the work is bound
// by operations, and the CUDA cores' fp32 rate is about 15x below what bf16
// tensor cores (mma/wgmma) allow; at M = 1 (decode) it is bound by reading B
// once, which the 64-row tiles do poorly. Tensor-core tiles and a GEMV for
// M = 1 are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // K slice staged in shared memory per step
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     const float* __restrict__ mask, T* __restrict__ C,
                     int M, int N, int K) {
  // A slice stored transposed (k-major) so the inner loop reads a column of
  // the tile; +4 pads the row so the transposing stores spread over banks.
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);        // column group of this thread
  const int ty = tid / (BN / TN);        // row group of this thread
  const int m0 = blockIdx.x * BM;        // x: up to 2^31-1 row tiles
  const int n0 = blockIdx.y * BN;        // y: up to 65535 column tiles

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK): consecutive threads read consecutive k of one row.
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.0f;
    }
    // B tile (BK x BN): consecutive threads read consecutive n of one row.
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f32(B[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: the column mask, then the bounds-checked store.
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= N) continue;
    const float mv = mask[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < M) store(&C[(size_t)gm * N + gn], acc[i][j] * mv);
    }
  }
}

template <typename T>
int launch(const T* A, const T* B, const float* mask, T* C, int M, int N,
           int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  masked_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(A, B, mask, C, M, N,
                                                        K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success): a launch the card refuses never
// runs, so the caller must check this rather than rely on a later synchronize.
extern "C" int masked_matmul_f32(const float* A, const float* B,
                                 const float* mask, float* C, int M, int N,
                                 int K, cudaStream_t stream) {
  return launch<float>(A, B, mask, C, M, N, K, stream);
}

extern "C" int masked_matmul_bf16(const __nv_bfloat16* A,
                                  const __nv_bfloat16* B, const float* mask,
                                  __nv_bfloat16* C, int M, int N, int K,
                                  cudaStream_t stream) {
  return launch<__nv_bfloat16>(A, B, mask, C, M, N, K, stream);
}
