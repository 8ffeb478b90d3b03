// Column-masked GEMM for Hopper (sm_90a):
//     C[m, n] = mask[n] * sum_k A[m, k] * B[k, n]
// A (M, K), B (K, N), C (M, N) row-major, all float32 or all bfloat16, or A
// and C float32 with B as uint8 codes dequantized in the load; mask (N,)
// float32. Products and sums are float32 in every entry; a bf16 entry
// rounds each output once, as it is stored.
//
// Replaces the TPU kernel src/repro/kernels/masked_matmul/kernel.py:_mm_kernel
// (masked_matmul_pallas). That kernel carried an fp32 VMEM accumulator across
// the sequential K steps of its grid and applied the mask when the last K step
// finished. Blocks on this card run in parallel and in no order, so each block
// here walks the whole K range of its outputs itself (the bf16 entries), or a
// share of it whose partial sums the blocks of a thread-block cluster add in
// a fixed order (the float32 entries), keeping the accumulator in registers;
// the mask multiply stays in the epilogue, so a pruned column is written as
// an exact 0 (acc * 0.0f).
//
// Seven entries; the wrapper (kernels/masked_matmul/ops.py:_route) picks one by
// B's dtype and A's shape before the launch:
//
// masked_matmul_bf16_tiles — bf16, M above the GEMV's rows, K and N multiples
//   of 8 (TMA wants 16-byte row strides). The pruned transformer's FFN up and
//   gate products in prefill (M = B*S, K = d_model, N = d_ff; Qwen2-7B: K =
//   3584, N = 18944) are bound by operations: 2*M*K*N at the tensor cores' bf16
//   rate. 128x256 output tiles: a ring of 4 shared-memory stages, each one
//   128x64 A tile and one 64x256 B tile loaded by TMA with the 128-byte swizzle
//   and reported on an mbarrier; one producer warp keeps the loads in flight,
//   two consumer warpgroups (64 rows each) run wgmma m64n256k16 with fp32
//   accumulators in registers and hand each stage back on a second mbarrier.
//   A is K-major; B stays row-major (N-contiguous, MN-major for wgmma, read
//   through the transpose bit), so nothing is copied or transposed. Ragged M,
//   N and K tails are zero-filled by TMA and not stored. Blocks walk M fastest,
//   so the blocks resident at once share a few column tiles of B in L2.
//
// masked_matmul_bf16_gemv — bf16, M <= 2 (decode: M = B), K and N multiples
//   of 8. Bound by reading B once: with half the columns kept at random nearly
//   every 32-byte sector of a row of B holds a kept column, so the floor is all
//   of B (136 MB at Qwen2-7B's width, 0.041 ms at 3.35 TB/s). Each block owns
//   32 columns: 4 threads read a row's 64 bytes as 16-byte vectors, 64 rows at
//   a time, 8 such reads in flight a thread; the K range is split across the
//   block's warps, the rows of A sit in shared memory, and the fp32 sums are
//   reduced by shuffles and across warps in shared memory before the mask
//   epilogue. It takes any M, 8 rows a block row (reading B again for each),
//   so that its crossover with the tiles can be measured; from M = 3 on the
//   tiles are faster.
//
// masked_matmul_f32_gemv, masked_matmul_q8_gemv — float32 A, B float32 or
//   uint8 codes, M <= 24 rows (the edge's dense layers at batch 1; the split-K
//   tiles win from 32 rows at dense14's shape). Bound by reading B once (once
//   per 4 rows above 2). Blocks own 64 columns (16-byte reads of 4 floats or 16
//   codes, 4 in flight a thread) or 32 (one element a read, for N % 4 or
//   alignment: dense18 has N = 38); K is split across the block's warps and
//   across the up to 8 blocks of a thread-block cluster, whose partial sums
//   are added in a fixed rank order through distributed shared memory.
//
// masked_matmul_f32_splitk, masked_matmul_q8_splitk — the same operands, any
//   other shape: the edge's im2col convs (M = 169 .. 3025, 6 to 48 64x64 tiles for
//   132 SMs). 32x32 or 64x32 output tiles, 32-deep K slices through a 3-stage
//   cp.async ring, K split over the blocks of a cluster (the host picks tile
//   and split so that tiles x split >= 132), the partial tiles summed as in the
//   GEMV. One launch, no workspace and no atomics: the same inputs give the
//   same bits. fp32 FMAs on the CUDA cores: the reference fixes these layers at
//   fp32, and TF32 or bf16 tensor cores would change the numerics. A code is
//   dequantized as fadd_rn(fmul_rn(code, scale[n]), zero[n]), bit for bit the
//   dequantize_weights value, so B moves as 1 byte an element.
//
// masked_matmul_bf16 — the CUDA-core tile loop: bf16 shapes whose K or N is
//   not a multiple of 8. 64x64 output tiles, 16-deep K slices staged in
//   shared memory (widened to fp32 as they are staged), 256 threads computing
//   4x4 outputs each from registers; edges bounds-checked instead of padded.
//   It does not use the tensor cores.
#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // K slice staged in shared memory per step
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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


// ---------------------------------------------------------------------------
// Hopper primitives, as inline PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive once and add `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// TMA: copy the box at (c0 innermost, c1) of `map` into shared memory at
// `dst`; the bytes it writes complete transactions on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions that own the registers.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64x256, fp32) += A(64x16, K-major, bf16) * B(16x256, MN-major, bf16),
// both operands from shared memory through their descriptors; scale-d = 1
// (accumulate), trans-a = 0, trans-b = 1.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Prefill: wgmma tiles fed by TMA
// ---------------------------------------------------------------------------
namespace tiles {
constexpr int BM = 128;                 // output rows a block: two warpgroups
constexpr int BN = 256;                 // output columns a block
constexpr int BK = 64;                  // K depth of a stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;            // warpgroups issuing wgmma
constexpr int THREADS = CONSUMERS * 128 + 32;   // + the producer warp
constexpr int BOX_N = 64;               // B columns a TMA box: the swizzle span
constexpr int A_BYTES = BM * BK * 2;    // 16 KB
constexpr int B_BOX_BYTES = BK * BOX_N * 2;     // 8 KB
constexpr int STAGE_BYTES = A_BYTES + (BN / BOX_N) * B_BOX_BYTES;   // 48 KB
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;   // + slack to align to 1 KB
}  // namespace tiles

// Shared-memory layout of a stage, as TMA writes it with the 128-byte
// swizzle (16-byte chunk c of a 128-byte row r lands at chunk c ^ (r % 8),
// so tiles start on 1 KB boundaries):
//   A: 128 rows (m) of 64 k, 128 bytes a row — K-major. wgmma reads a
//      warpgroup's 64 rows from row 64*wg; a 16-deep k step starts 32 bytes
//      further along the row; 8-row groups are 1024 bytes apart (SBO).
//   B: four boxes of 64 rows (k) of 64 n, 8 KB each — MN-major. A 16-deep k
//      step starts 16 rows (2048 bytes) further; 8-row groups of k are 1024
//      bytes apart (SBO), 64-column groups of n 8192 bytes apart (LBO).
__global__ void __launch_bounds__(tiles::THREADS, 1)
masked_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                           const __grid_constant__ CUtensorMap tmB,
                           const float* __restrict__ mask,
                           __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  // block-scope names hide the CUDA-core kernel's BM, BN, BK
  using tiles::BM; using tiles::BN; using tiles::BK; using tiles::STAGES;
  using tiles::CONSUMERS; using tiles::BOX_N; using tiles::A_BYTES;
  using tiles::B_BOX_BYTES; using tiles::STAGE_BYTES;
  extern __shared__ uint8_t tiles_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];    // TMA landed a stage
  __shared__ __align__(8) uint64_t empty[STAGES];   // both warpgroups done
  const uint32_t base = (smem_u32(tiles_smem) + 1023u) & ~1023u;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one thread keeps up to STAGES k-tiles in flight
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        const uint32_t a = base + s * STAGE_BYTES;
        tma_load_2d(a, &tmA, kt * BK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / BOX_N; ++j)
          tma_load_2d(a + A_BYTES + j * B_BOX_BYTES, &tmB, n0 + j * BOX_N,
                      kt * BK, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows m0 + 64*wg .. +63
  const int wg = warp / 4;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + wg * 64 * (BK * 2);
    const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16(acc, sw128_desc(a + kk * 32, 16, 1024),
                       sw128_desc(b + kk * 16 * (BOX_N * 2), B_BOX_BYTES, 1024));
    wgmma_commit();
    // the products of k-tile kt stay in flight; those of kt - 1 are retired,
    // so its stage goes back to the producer
    wgmma_wait<1>();
    fence_acc(acc);
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue. Accumulator i of thread (warp w of the warpgroup, lane l) is
  // row 16*w + l/4 + 8*((i/2) % 2), column 8*(i/4) + 2*(l%4) + i%2.
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int n = n0 + c * 8 + (lane % 4) * 2;
    if (n >= N) continue;            // N % 8 == 0: n < N means n + 1 < N too
    const float m_lo = mask[n], m_hi = mask[n + 1];
    if (row < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + n) =
          __floats2bfloat162_rn(acc[4 * c] * m_lo, acc[4 * c + 1] * m_hi);
    if (row + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + n) =
          __floats2bfloat162_rn(acc[4 * c + 2] * m_lo, acc[4 * c + 3] * m_hi);
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time so that the
// library links against the runtime alone.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The map of a row-major bf16 matrix with `inner` columns and `outer` rows,
// cut into boxes of box_inner x box_outer with the 128-byte swizzle; out of
// bounds reads are zeros. Returns 0, or 1000 + the CUresult of the encoder.
int bf16_map(CUtensorMap* map, const void* ptr, int inner, int outer,
             int box_inner, int box_outer) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

int launch_tiles(const __nv_bfloat16* A, const __nv_bfloat16* B,
                 const float* mask, __nv_bfloat16* C, int M, int N, int K,
                 cudaStream_t stream) {
  using tiles::BM; using tiles::BN; using tiles::BK; using tiles::BOX_N;
  using tiles::SMEM;
  CUtensorMap tmA, tmB;
  int err = bf16_map(&tmA, A, K, M, BK, BM);
  if (err != 0) return err;
  err = bf16_map(&tmB, B, N, K, BOX_N, BK);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      masked_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  masked_matmul_wgmma_kernel<<<grid, tiles::THREADS, SMEM, stream>>>(
      tmA, tmB, mask, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Decode: a GEMV over at most 8 rows of A at a time
// ---------------------------------------------------------------------------
namespace gemv {
constexpr int VEC = 8;                      // bf16 columns a 16-byte read
constexpr int COLS = 32;                    // output columns a block
constexpr int LANES_N = COLS / VEC;         // threads across a row of B
constexpr int THREADS = 256;
constexpr int LANES_K = THREADS / LANES_N;  // rows of B read at once
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;                   // 16-byte reads in flight a thread
}  // namespace gemv

template <int MR>
__device__ __forceinline__ void fma_row(float (&acc)[MR][gemv::VEC], uint4 v,
                                        const __nv_bfloat16* a, int K) {
  float b[gemv::VEC];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < gemv::VEC / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    b[2 * j] = f.x;
    b[2 * j + 1] = f.y;
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float am = __bfloat162float(a[m * K]);
#pragma unroll
    for (int j = 0; j < gemv::VEC; ++j) acc[m][j] = fmaf(am, b[j], acc[m][j]);
  }
}

// Block (x, y) computes columns 32x .. 32x+31 of rows MR*y .. MR*y+MR-1.
template <int MR>
__global__ void __launch_bounds__(gemv::THREADS)
masked_matmul_gemv_kernel(const __nv_bfloat16* __restrict__ A,
                          const __nv_bfloat16* __restrict__ B,
                          const float* __restrict__ mask,
                          __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  using gemv::VEC; using gemv::COLS; using gemv::LANES_N; using gemv::THREADS;
  using gemv::LANES_K; using gemv::WARPS; using gemv::UNROLL;
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  float* red = reinterpret_cast<float*>(gemv_smem);   // [WARPS][MR][COLS]
  __nv_bfloat16* As =
      reinterpret_cast<__nv_bfloat16*>(red + WARPS * MR * COLS);   // [MR][K]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MR;
  // stage the rows of A as 16-byte vectors (K % 8 == 0), rows past M zeros
  const int kv = K / VEC;
  for (int i = tid; i < MR * kv; i += THREADS) {
    const int m = m0 + i / kv;
    reinterpret_cast<uint4*>(As)[i] =
        m < M ? __ldg(reinterpret_cast<const uint4*>(A + (size_t)m * K) + i % kv)
              : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int cl = tid % LANES_N;    // which 8 columns
  const int kl = tid / LANES_N;    // first row of B this thread reads
  const int n = blockIdx.x * COLS + cl * VEC;
  float acc[MR][VEC];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.0f;
  if (n < N) {                     // N % 8 == 0: all 8 columns are in range
    const __nv_bfloat16* col = B + n;
    int k = kl;
    for (; k + (UNROLL - 1) * LANES_K < K; k += UNROLL * LANES_K) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            col + (size_t)(k + u * LANES_K) * N));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        fma_row<MR>(acc, v[u], As + k + u * LANES_K, K);
    }
    for (; k < K; k += LANES_K)
      fma_row<MR>(acc, __ldg(reinterpret_cast<const uint4*>(col + (size_t)k * N)),
                  As + k, K);
  }

  // a warp holds 8 row lanes of the same 32 columns: sum them by shuffles,
  // then the 8 warps' sums in shared memory
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float x = acc[m][j];
#pragma unroll
      for (int off = LANES_N; off < 32; off *= 2)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      acc[m][j] = x;
    }
  if (lane < LANES_N)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        red[(warp * MR + m) * COLS + lane * VEC + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < MR * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    const int gm = m0 + m, gn = blockIdx.x * COLS + c;
    if (gm >= M || gn >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * MR + m) * COLS + c];
    C[(size_t)gm * N + gn] = __float2bfloat16_rn(s * mask[gn]);
  }
}

template <int MR>
int launch_gemv_rows(const __nv_bfloat16* A, const __nv_bfloat16* B,
                     const float* mask, __nv_bfloat16* C, int M, int N, int K,
                     cudaStream_t stream) {
  using gemv::COLS; using gemv::THREADS; using gemv::WARPS;
  const size_t smem = sizeof(float) * WARPS * MR * COLS + 2 * (size_t)MR * K;
  const cudaError_t attr = cudaFuncSetAttribute(
      masked_matmul_gemv_kernel<MR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + COLS - 1) / COLS, (M + MR - 1) / MR);
  masked_matmul_gemv_kernel<MR><<<grid, THREADS, smem, stream>>>(A, B, mask, C,
                                                                 M, N, K);
  return static_cast<int>(cudaGetLastError());
}

int launch_gemv(const __nv_bfloat16* A, const __nv_bfloat16* B,
                const float* mask, __nv_bfloat16* C, int M, int N, int K,
                cudaStream_t stream) {
  if (M == 1) return launch_gemv_rows<1>(A, B, mask, C, M, N, K, stream);
  if (M == 2) return launch_gemv_rows<2>(A, B, mask, C, M, N, K, stream);
  return launch_gemv_rows<8>(A, B, mask, C, M, N, K, stream);
}

// ---------------------------------------------------------------------------
// float32 A, and B as float32 or as uint8 codes: split-K over the blocks of a
// thread-block cluster, summed through distributed shared memory
// ---------------------------------------------------------------------------
// B's element as the kernels use it: a float, or a code dequantized as
// code * scale[n] + zero[n] with one rounding per operation, which is what
// dequantize_weights computes (a multiply, then an add). The intrinsics keep
// nvcc from contracting the pair into one fma, which would round once.
__device__ __forceinline__ float b_val(float v, float, float) { return v; }
__device__ __forceinline__ float b_val(uint8_t c, float s, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), s), z);
}

// 4 or 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Each rank of the cluster (at most 8) has left its partial sums in `part`
// (n floats); rank r sums the r-th of n / ranks consecutive elements, over
// ranks 0, 1, ... in that order, so the same inputs give the same bits on
// every run: the ranks' values are all loaded first (their distributed
// shared-memory reads in flight together), then added. `store(e, sum)`
// writes the output. The cluster syncs before (every part is complete) and
// after (no block leaves while another still reads its shared memory).
template <typename Store>
__device__ __forceinline__ void cluster_reduce(float* part, int n,
                                               int threads, Store store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  cluster.sync();
  const int hi = (rank + 1) * n / ranks;
  for (int e = rank * n / ranks + threadIdx.x; e < hi; e += threads) {
    float r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      r[q] = q < ranks ? cluster.map_shared_rank(part, q)[e] : 0.0f;
    float v = r[0];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      if (q < ranks) v += r[q];
    store(e, v);
  }
  cluster.sync();
}

// Launch `kernel` on a grid whose `axis` (1 = y, 2 = z) holds the `split`
// blocks of each cluster.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t smem, int axis, int split, cudaStream_t stream,
                   Args... args) {
  if (split < 1 || split > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = axis == 1 ? split : 1;
  attr[0].val.clusterDim.z = axis == 2 ? split : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The split-K tiles: the edge's im2col convs (M = 169 .. 3025 rows, K = 363 ..
// 3456, N = 32 .. 384). Block (x, y, z) computes the BM x 32 output tile
// (x, y) over its share z of the K slices: a 3-stage ring of 32-deep slices
// filled by cp.async (A and B, or its codes, as they lie), so two slices are
// in flight while the 128 threads run the FMAs
// of the third, each thread a TM x 4 register tile (B's 4 columns read from
// shared memory as one vector). Without a split the sums go straight out. The host picks BM (64 or 32) and the split (the cluster's
// size, up to 8) so that tiles x split reaches twice the card's 132 SMs
// where K allows at least 4 slices a block (and at least 132 at every
// AlexNet shape).
namespace splitk {
constexpr int BN = 32;                 // output columns a tile
constexpr int BK = 32;                 // K depth of a slice
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int TN = 4;                  // columns a thread
constexpr int TX = BN / TN;            // column groups: 8
constexpr int TY = THREADS / TX;       // row groups: 16
}  // namespace splitk

// VEC: B copied 4 elements to a cp.async (N % 4 == 0 and B aligned: 16 bytes
// of floats, 4 of codes); otherwise a float is copied alone (4 bytes) and a
// code is loaded and stored as it is.
// AVEC: A copied 4 floats to a cp.async (K % 4 == 0 and A 16-byte aligned;
// conv0's K = 363 is not), else one.
template <typename TB, int BM, bool VEC, bool AVEC>
__global__ void __launch_bounds__(splitk::THREADS)
masked_matmul_splitk_kernel(const float* __restrict__ A,
                            const TB* __restrict__ B,
                            const float* __restrict__ scale,
                            const float* __restrict__ zero,
                            const float* __restrict__ mask,
                            float* __restrict__ C, int M, int N, int K) {
  // block-scope names hide the CUDA-core kernel's BN, BK, THREADS, TN
  using splitk::BN; using splitk::BK; using splitk::STAGES;
  using splitk::THREADS; using splitk::TN; using splitk::TX; using splitk::TY;
  constexpr int TM = BM / TY;            // rows a thread: 4 or 2
  constexpr int AS = BK + 4;             // padded row of A's slice
  __shared__ __align__(16) float As[STAGES][BM][AS];
  __shared__ __align__(16) TB Bs[STAGES][BK][BN];
  __shared__ __align__(16) float Bf[sizeof(TB) == 1 ? BK : 1][BN];
  __shared__ __align__(16) float part[BM * BN];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this rank's slices, balanced: each gets floor or ceil of nk / ranks
  const int nk = (K + BK - 1) / BK;
  const int s_lo = static_cast<int>(static_cast<long long>(rank) * nk / ranks);
  const int ns = static_cast<int>(
      static_cast<long long>(rank + 1) * nk / ranks) - s_lo;

  auto fill = [&](int slice, int st) {
    const int k0 = (s_lo + slice) * BK;
    // A as it lies: consecutive threads copy consecutive k of a row
    if constexpr (AVEC) {
      for (int e = tid; e < BM * BK / 4; e += THREADS) {
        const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
        const int gm = m0 + r, gk = k0 + c;
        const bool in = gm < M && gk < K;   // K % 4 == 0: all 4 or none
        cp_async16(&As[st][r][c], in ? A + (size_t)gm * K + gk : A,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK, gm = m0 + r, gk = k0 + c;
        const bool in = gm < M && gk < K;
        cp_async4(&As[st][r][c], in ? A + (size_t)gm * K + gk : A,
                  in ? 4 : 0);
      }
    }
    if constexpr (VEC) {
      // 4 elements a copy: 16 bytes of floats, 4 bytes of codes
      for (int e = tid; e < BK * BN / 4; e += THREADS) {
        const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
        const int gk = k0 + r, gn = n0 + c;
        const bool in = gk < K && gn < N;   // N % 4 == 0: all 4 or none
        const TB* src = in ? B + (size_t)gk * N + gn : B;
        if constexpr (sizeof(TB) == 4)
          cp_async16(&Bs[st][r][c], src, in ? 16 : 0);
        else
          cp_async4(&Bs[st][r][c], src, in ? 4 : 0);
      }
    } else if constexpr (sizeof(TB) == 4) {
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, c = e % BN, gk = k0 + r, gn = n0 + c;
        const bool in = gk < K && gn < N;
        cp_async4(&Bs[st][r][c], in ? B + (size_t)gk * N + gn : B,
                  in ? 4 : 0);
      }
    } else {
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, c = e % BN, gk = k0 + r, gn = n0 + c;
        Bs[st][r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : TB(0);
      }
    }
  };

  // this thread's columns' scale and zero (codes only); a slice past K
  // holds A = 0, so whatever B dequantizes to there adds nothing
  // codes: each slice is dequantized once, as it lands, into Bf (a code is
  // read by 8 threads); this thread takes column n0 + tid % BN
  float qs = 1.0f, qz = 0.0f;
  if constexpr (sizeof(TB) == 1) {
    const int gn = min(n0 + tid % BN, N - 1);
    qs = scale[gn];
    qz = zero[gn];
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  auto fma_slice = [&](int st, const float* bt) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[st][ty * TM + i][kk];
      const float4 b4 = *reinterpret_cast<const float4*>(bt + kk * BN + tx * TN);
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) fill(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ns; ++t) {
    cp_async_wait<STAGES - 2>();   // slice t has landed
    __syncthreads();               // ... for every thread; slice t-1 is done
    if (t + STAGES - 1 < ns) fill(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = t % STAGES;
    if constexpr (sizeof(TB) == 1) {
      for (int r = tid / BN; r < BK; r += THREADS / BN)
        Bf[r][tid % BN] = b_val(Bs[st][r][tid % BN], qs, qz);
      __syncthreads();
      fma_slice(st, &Bf[0][0]);
    } else {
      fma_slice(st, &Bs[st][0][0]);
    }
  }
  cp_async_wait<0>();

  // the mask in the epilogue: a pruned column is written as sum * 0.0f
  if (ranks == 1) {   // no split: the sums are this thread's
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty * TM + i;
        if (gm < M) C[(size_t)gm * N + gn] = acc[i][j] * mask[gn];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      part[(ty * TM + i) * BN + tx * TN + j] = acc[i][j];
  cluster_reduce(part, BM * BN, THREADS, [&](int e, float v) {
    const int gm = m0 + e / BN, gn = n0 + e % BN;
    if (gm < M && gn < N) C[(size_t)gm * N + gn] = v * mask[gn];
  });
}

template <typename TB, int BM, bool VEC>
int launch_splitk_t(const float* A, const TB* B, const float* scale,
                    const float* zero, const float* mask, float* C, int M,
                    int N, int K, int split, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + splitk::BN - 1) / splitk::BN,
                  split);
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0)
    return launch_cluster(masked_matmul_splitk_kernel<TB, BM, VEC, true>,
                          grid, splitk::THREADS, 0, 2, split, stream, A, B,
                          scale, zero, mask, C, M, N, K);
  return launch_cluster(masked_matmul_splitk_kernel<TB, BM, VEC, false>, grid,
                        splitk::THREADS, 0, 2, split, stream, A, B, scale,
                        zero, mask, C, M, N, K);
}

// `bm` rows a tile (64 or 32); `vec` 4 for B copied 4 elements at a time,
// else 1.
template <typename TB>
int launch_splitk(const float* A, const TB* B, const float* scale,
                  const float* zero, const float* mask, float* C, int M,
                  int N, int K, int bm, int split, int vec,
                  cudaStream_t stream) {
  if ((bm != 64 && bm != 32) || (vec != 4 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4)
    return bm == 64 ? launch_splitk_t<TB, 64, true>(A, B, scale, zero, mask, C,
                                                    M, N, K, split, stream)
                    : launch_splitk_t<TB, 32, true>(A, B, scale, zero, mask, C,
                                                     M, N, K, split, stream);
  return bm == 64 ? launch_splitk_t<TB, 64, false>(A, B, scale, zero, mask, C,
                                                   M, N, K, split, stream)
                  : launch_splitk_t<TB, 32, false>(A, B, scale, zero, mask, C,
                                                   M, N, K, split, stream);
}

// The split-K GEMV: the edge's dense layers (M = 1, K up to 4608, N up to
// 2048), bound by reading B once (37.7 MB at dense14's compacted width in
// float32, 9.4 MB as codes). Block (x, y, z) owns a slab of columns x, the
// K share y of its cluster and rows MR z .. MR z + MR-1; its rows of A (its
// K share only) sit in shared memory. Threads read rows of B as 16-byte
// vectors (4 floats or 16 codes) with UNROLL reads in flight, or one element
// at a time when N or alignment forbids vectors (dense18: N = 38); the rows
// of the share are spread over the block's 8 warps. The sums are reduced by
// shuffles, across warps in shared memory and across the cluster by
// cluster_reduce, then masked.
namespace gemv32 {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
}  // namespace gemv32

template <typename TB, int VEC> struct BRow;
template <> struct BRow<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void get(Raw v, float (&b)[4],
                                             const float (&)[4],
                                             const float (&)[4]) {
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  }
};
template <> struct BRow<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void get(Raw v, float (&b)[1],
                                             const float (&)[1],
                                             const float (&)[1]) {
    b[0] = v;
  }
};
template <> struct BRow<uint8_t, 16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void get(Raw v, float (&b)[16],
                                             const float (&sc)[16],
                                             const float (&ze)[16]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      b[i] = b_val(static_cast<uint8_t>(w[i / 4] >> (8 * (i % 4))), sc[i],
                   ze[i]);
  }
};
template <> struct BRow<uint8_t, 1> {
  using Raw = uint8_t;
  static __device__ __forceinline__ Raw load(const uint8_t* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void get(Raw v, float (&b)[1],
                                             const float (&sc)[1],
                                             const float (&ze)[1]) {
    b[0] = b_val(v, sc[0], ze[0]);
  }
};

// columns a block: 64 with vector reads, 32 one element at a time
template <int VEC>
struct Gemv32Cols {
  static constexpr int value = VEC == 1 ? 32 : 64;
};

template <typename TB, int VEC, int MR>
__global__ void __launch_bounds__(gemv32::THREADS)
masked_matmul_gemv_f32_kernel(const float* __restrict__ A,
                              const TB* __restrict__ B,
                              const float* __restrict__ scale,
                              const float* __restrict__ zero,
                              const float* __restrict__ mask,
                              float* __restrict__ C, int M, int N, int K,
                              int kper) {
  using gemv32::THREADS; using gemv32::WARPS; using gemv32::UNROLL;
  constexpr int COLS = Gemv32Cols<VEC>::value;
  constexpr int LANES_N = COLS / VEC;          // 16, 4 or 32 across a row
  constexpr int LANES_K = THREADS / LANES_N;   // rows of B read at once
  using Row = BRow<TB, VEC>;
  extern __shared__ __align__(16) float gv_smem[];
  float* red = gv_smem;                        // [WARPS][MR][COLS]
  float* part = red + WARPS * MR * COLS;       // [MR][COLS]
  float* As = part + MR * COLS;                // [MR][kper]

  const int tid = threadIdx.x;
  const int k_lo = min(K, static_cast<int>(blockIdx.y) * kper);
  const int k_hi = min(K, k_lo + kper);
  const int m0 = blockIdx.z * MR;
  for (int i = tid; i < MR * kper; i += THREADS) {
    const int m = m0 + i / kper, k = k_lo + i % kper;
    As[i] = (m < M && k < k_hi) ? A[(size_t)m * K + k] : 0.0f;
  }
  __syncthreads();

  const int cl = tid % LANES_N, kl = tid / LANES_N;
  const int n = blockIdx.x * COLS + cl * VEC;
  float sc[VEC], ze[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sc[j] = 1.0f;
    ze[j] = 0.0f;
    if constexpr (sizeof(TB) == 1) {
      const int gn = min(n + j, N - 1);
      sc[j] = scale[gn];
      ze[j] = zero[gn];
    }
  }
  float acc[MR][VEC];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.0f;

  auto fma_row = [&](typename Row::Raw v, int k) {
    float b[VEC];
    Row::get(v, b, sc, ze);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const float am = As[m * kper + k - k_lo];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(am, b[j], acc[m][j]);
    }
  };
  if (n < N) {   // VEC > 1: N % VEC == 0, so all VEC columns are in range
    const TB* col = B + n;
    int k = k_lo + kl;
    for (; k + (UNROLL - 1) * LANES_K < k_hi; k += UNROLL * LANES_K) {
      typename Row::Raw v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = Row::load(col + (size_t)(k + u * LANES_K) * N);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fma_row(v[u], k + u * LANES_K);
    }
    for (; k < k_hi; k += LANES_K) fma_row(Row::load(col + (size_t)k * N), k);
  }

  // lanes LANES_N apart in a warp hold the same columns: sum them by
  // shuffles, then the warps' sums in a fixed order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float x = acc[m][j];
#pragma unroll
      for (int off = LANES_N; off < 32; off *= 2)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      acc[m][j] = x;
    }
  if (lane < LANES_N)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        red[(warp * MR + m) * COLS + lane * VEC + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < MR * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * MR + m) * COLS + c];
    part[i] = s;
  }
  cluster_reduce(part, MR * COLS, THREADS, [&](int e, float v) {
    const int gm = m0 + e / COLS, gn = blockIdx.x * COLS + e % COLS;
    if (gm < M && gn < N) C[(size_t)gm * N + gn] = v * mask[gn];
  });
}

template <typename TB, int VEC, int MR>
int launch_gemv_f32_t(const float* A, const TB* B, const float* scale,
                      const float* zero, const float* mask, float* C, int M,
                      int N, int K, int split, cudaStream_t stream) {
  constexpr int COLS = Gemv32Cols<VEC>::value;
  if (split < 1 || split > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int kper = (K + split - 1) / split;
  const size_t smem =
      sizeof(float) * ((gemv32::WARPS + 1) * MR * COLS + (size_t)MR * kper);
  const dim3 grid((N + COLS - 1) / COLS, split, (M + MR - 1) / MR);
  return launch_cluster(masked_matmul_gemv_f32_kernel<TB, VEC, MR>, grid,
                        gemv32::THREADS, smem, 1, split, stream, A, B, scale,
                        zero, mask, C, M, N, K, kper);
}

// `rows` (1, 2 or 4) of A a block; `vec` 4 (float) or 16 (codes) for
// 16-byte reads of B, else 1.
template <typename TB, int VEC>
int launch_gemv_f32_v(const float* A, const TB* B, const float* scale,
                      const float* zero, const float* mask, float* C, int M,
                      int N, int K, int rows, int split, cudaStream_t stream) {
  if (rows == 1)
    return launch_gemv_f32_t<TB, VEC, 1>(A, B, scale, zero, mask, C, M, N, K,
                                         split, stream);
  if (rows == 2)
    return launch_gemv_f32_t<TB, VEC, 2>(A, B, scale, zero, mask, C, M, N, K,
                                         split, stream);
  if (rows == 4)
    return launch_gemv_f32_t<TB, VEC, 4>(A, B, scale, zero, mask, C, M, N, K,
                                         split, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TB>
int launch_gemv_f32(const float* A, const TB* B, const float* scale,
                    const float* zero, const float* mask, float* C, int M,
                    int N, int K, int rows, int split, int vec,
                    cudaStream_t stream) {
  constexpr int WIDE = sizeof(TB) == 4 ? 4 : 16;   // a 16-byte read
  if (vec == WIDE)
    return launch_gemv_f32_v<TB, WIDE>(A, B, scale, zero, mask, C, M, N, K,
                                       rows, split, stream);
  if (vec == 1)
    return launch_gemv_f32_v<TB, 1>(A, B, scale, zero, mask, C, M, N, K, rows,
                                    split, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success): a launch the card refuses never
// runs, so the caller must check this rather than rely on a later synchronize.
extern "C" int masked_matmul_bf16(const __nv_bfloat16* A,
                                  const __nv_bfloat16* B, const float* mask,
                                  __nv_bfloat16* C, int M, int N, int K,
                                  cudaStream_t stream) {
  return launch<__nv_bfloat16>(A, B, mask, C, M, N, K, stream);
}

// The two Hopper routes take bf16 with K and N multiples of 8 and 16-byte
// aligned A, B and C (the wrapper routes other shapes to masked_matmul_bf16).
extern "C" int masked_matmul_bf16_tiles(const __nv_bfloat16* A,
                                        const __nv_bfloat16* B,
                                        const float* mask, __nv_bfloat16* C,
                                        int M, int N, int K,
                                        cudaStream_t stream) {
  return launch_tiles(A, B, mask, C, M, N, K, stream);
}

extern "C" int masked_matmul_bf16_gemv(const __nv_bfloat16* A,
                                       const __nv_bfloat16* B,
                                       const float* mask, __nv_bfloat16* C,
                                       int M, int N, int K,
                                       cudaStream_t stream) {
  return launch_gemv(A, B, mask, C, M, N, K, stream);
}

// The float32 routes take A, B and C float32, and the host's plan
// (kernels/masked_matmul/ops.py:_plan): `tile` (rows of an output tile for
// the split-K tiles, rows of A a block for the GEMV), `split` (blocks a
// cluster, 1 to 8, over K) and `vec` (B elements a read or copy).
extern "C" int masked_matmul_f32_splitk(const float* A, const float* B,
                                        const float* mask, float* C, int M,
                                        int N, int K, int tile, int split,
                                        int vec, cudaStream_t stream) {
  return launch_splitk<float>(A, B, nullptr, nullptr, mask, C, M, N, K, tile,
                              split, vec, stream);
}

extern "C" int masked_matmul_f32_gemv(const float* A, const float* B,
                                      const float* mask, float* C, int M,
                                      int N, int K, int tile, int split,
                                      int vec, cudaStream_t stream) {
  return launch_gemv_f32<float>(A, B, nullptr, nullptr, mask, C, M, N, K,
                                tile, split, vec, stream);
}

// The same two routes with B as uint8 codes (K, N), dequantized in the load
// as codes * scale[n] + zero[n] (scale and zero float32, (N,)).
extern "C" int masked_matmul_q8_splitk(const float* A, const uint8_t* codes,
                                       const float* scale, const float* zero,
                                       const float* mask, float* C, int M,
                                       int N, int K, int tile, int split,
                                       int vec, cudaStream_t stream) {
  return launch_splitk<uint8_t>(A, codes, scale, zero, mask, C, M, N, K, tile,
                                split, vec, stream);
}

extern "C" int masked_matmul_q8_gemv(const float* A, const uint8_t* codes,
                                     const float* scale, const float* zero,
                                     const float* mask, float* C, int M,
                                     int N, int K, int tile, int split,
                                     int vec, cudaStream_t stream) {
  return launch_gemv_f32<uint8_t>(A, codes, scale, zero, mask, C, M, N, K,
                                  tile, split, vec, stream);
}
