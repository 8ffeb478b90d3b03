// Column-masked fp32 GEMM for Hopper (sm_90a):
//     C[m, n] = mask[n] * sum_k A[m, k] * B[k, n]
// A (M, K), B (K, N), C (M, N) row-major float32, mask (N,) float32.
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
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // K slice staged in shared memory per step
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(THREADS)
masked_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ mask, float* __restrict__ C,
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
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
    }
    // B tile (BK x BN): consecutive threads read consecutive n of one row.
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.0f;
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
      if (gm < M) C[(size_t)gm * N + gn] = acc[i][j] * mv;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success): a launch the card refuses never runs,
// so the caller must check this rather than rely on a later synchronize.
extern "C" int masked_matmul_f32(const float* A, const float* B,
                                 const float* mask, float* C, int M, int N,
                                 int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  masked_matmul_kernel<<<grid, THREADS, 0, stream>>>(A, B, mask, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
