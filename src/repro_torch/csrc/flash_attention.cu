// Flash attention for Hopper (sm_90a): online-softmax attention with causal
// and sliding-window masks and grouped KV heads (GQA), in the model layout
//     q, out (B, Sq, H, D)     k, v (B, Sk, Hkv, D)      row-major,
// all float32 (flash_attention_f32) or all bfloat16 (flash_attention_bf16),
// D = 64, 80, 128, 192 or 256. Query head h reads KV head h / (H / Hkv).
// Query row i sits at key position q_offset + i: 0 for self-attention, a
// sequence block's first position where the block's queries attend the
// keys of every position before it (context parallelism); the causal and
// window masks and the tile skips compare positions, so q_offset = 0 is
// the kernel it was before the offset.
// Scores, softmax and the output accumulator are float32; the output is
// rounded once.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (flash_attention_pallas). That kernel ran a grid (B, H, nq,
// nk) whose innermost KV axis was sequential, carrying the running max m,
// the denominator l and the accumulator acc across grid steps in VMEM, on
// inputs its wrapper had transposed to (B, H, S, D) and padded to 512-blocks.
// Blocks on this card run in parallel and in no order, so here one block
// owns a tile of queries of one (batch, head) pair and walks the KV tiles
// itself, with m, l and acc in registers. The kernels index the (B, S, H, D)
// strides themselves, so nothing is transposed or padded: query rows past Sq
// are neither loaded nor stored, and keys at or past seq_k score NEG_INF with
// zero values, exactly as the reference's padded keys do.
//
// Semantics kept from the reference: masked scores are NEG_INF = -2^30, not
// -inf, so a tile in which a row has no valid key adds exp(0) = 1 per key to
// l and the row's m stays NEG_INF until a valid key wipes it with alpha =
// exp(NEG_INF - m) = 0 (no NaN ever appears); a KV tile is skipped when it
// lies wholly above the causal diagonal or wholly behind every query's
// window, with the reference's test (kernel.py:53-60) at each kernel's tile
// sizes; the output is acc / max(l, 1e-37). A row with no valid key at all
// therefore comes out as the mean of the values of the tiles it walked,
// which depends on the tile size, as in the reference; self-attention never
// has such a row.
//
// What bounds it: operations. Causal prefill at S = 2048, H = 28, D = 128 is
// 2 * S^2 * D * H = 30 GFLOP a layer, 30 us at the bf16 tensor-core rate.
//
// flash_attention_bf16 (flash_kernel_mma) is a FlashAttention-2 design on the
// tensor cores: 64-query blocks of 4 warps, two blocks an SM, 16 query rows a
// warp, Q's fragments held in registers; 64-key K and V tiles double-buffered
// in shared memory by cp.async (XOR-swizzled rows, or at D = 80 rows padded to
// 11 chunks, so ldmatrix is free of bank conflicts); S = Q K^T and O += P V by
// mma.sync m16n8k16 (bf16 in, fp32 accumulators); the scale applied to the fp32
// scores, as the reference applies it in fp32; the online softmax across each
// row's quad of lanes by shuffles; P rounded to bf16 in registers to feed P V,
// while l sums the fp32 P. That rounding is the one numeric change from the
// reference, which keeps P in fp32 (kernel.py:81-87): each P entry moves by at
// most 2^-8 of itself, so each output by at most 2^-8 * max|v|. At D = 192 and
// 256 a warp's accumulator alone is 96 or 128 registers a thread and Q, K and V
// take 120 or 160 KB of shared memory, so those head dims run one block an SM
// and reload Q's fragments from shared memory by ldmatrix at each 16-deep step
// instead of holding them in registers (64 more at D = 256, which would spill).
// At D = 80 (HuBERT) a row is 10 16-byte chunks: the XOR swizzle, which
// permutes 8 chunks, would send chunks 8 and 9 into the next row, so those
// tiles keep their chunks in place and pad each row to 11 chunks instead
// (row_elems): 8 consecutive rows at one chunk then start 3 chunks apart
// mod 8, on 8 distinct bank groups. D / 16 = 5 steps of 16 and D / 8 = 10
// accumulator tiles of 8, as the mma.sync loops take them.
//
// flash_attention_f32 (flash_kernel) keeps the reference's fp32 numerics on
// the CUDA cores: 64-query tiles and 32-key tiles, 128 threads in an 8 x 16
// layout (thread (ty, tx) owns query rows 8*ty .. 8*ty+7, score columns
// tx + 16*j and output columns tx + 16*j), q pre-scaled and K, V, P staged in
// 73 KB of shared memory at D = 128 (49.9 KB at D = 80; 141 KB at D = 256,
// one block an SM), row maxima and sums across the 16 threads of a row
// group by warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;   // -2**30, as the reference
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per KV tile
constexpr int THREADS = 128;  // 8 row groups x 16 column threads
constexpr int RG = 16;        // threads per row group
constexpr int TR = BQ / (THREADS / RG);   // 8 query rows per thread
constexpr int TC = BK / RG;               // 2 score columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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
             int has_window, int window, int q_offset) {
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
  const int p_start = q_offset + q_start;   // the tile's first position
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
    if (causal) relevant = k_start <= p_start + BQ - 1;
    if (has_window) relevant = relevant && (k_start + BK - 1 > p_start - window);
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
      const int q_pos = p_start + ty * TR + i;
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
             int has_window, int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, Sq, Sk, H, Hkv, seq_k, scale, causal, has_window, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
           int H, int Hkv, int D, int seq_k, float scale, int causal,
           int has_window, int window, int q_offset, cudaStream_t stream) {
  if (D == 64)
    return launch_d<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                           causal, has_window, window, q_offset, stream);
  if (D == 80)
    return launch_d<T, 80>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                           causal, has_window, window, q_offset, stream);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                            causal, has_window, window, q_offset, stream);
  if (D == 192)
    return launch_d<T, 192>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                            causal, has_window, window, q_offset, stream);
  if (D == 256)
    return launch_d<T, 256>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                            causal, has_window, window, q_offset, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// The bf16 entry: FlashAttention-2 tiles on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------
namespace mma_tiles {
constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;   // query rows a block: 16 a warp
constexpr int BKV = 64;          // keys a KV tile
constexpr int THREADS = 32 * WARPS;
// elements a tile row takes in shared memory: D where a row is a multiple
// of 8 chunks (swizzled in place), else one spare 16-byte chunk a row,
// which must leave an odd number of chunks (conflict-free ldmatrix)
template <int D>
__host__ __device__ constexpr int row_elems() {
  return D % 64 == 0 ? D : D + 8;
}
// Q [BQ][row], then K and V [2 buffers][BKV][row], bf16
template <int D>
constexpr size_t smem_bytes() {
  return 2 * (size_t)(BQ * row_elems<D>() + 2 * 2 * BKV * row_elems<D>());
}
// up to D = 128 Q's fragments stay in registers and two blocks share an SM;
// above, Q is reread from shared memory and a block has the SM to itself
template <int D>
__host__ __device__ constexpr bool q_in_registers() { return D <= 128; }
template <int D>
__host__ __device__ constexpr int blocks_per_sm() {
  return q_in_registers<D>() ? 2 : 1;
}
}  // namespace mma_tiles

// A copy of v the compiler cannot see through: a value computed from it in
// the KV loop is computed there, not hoisted and kept in a register across
// the loop (at D = 256 the loop holds 255 registers a thread already)
__device__ __forceinline__ int opaque(int v) {
  int r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c(16x8, fp32) += a(16x16, bf16, row) * b(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Offset (in elements) of 16-byte chunk `chunk` of row `row` in a tile of
// rows of D bf16: where a row is a multiple of 8 chunks, the chunk index is
// XORed with row % 8; otherwise the chunk stays in place in a row padded to
// an odd number of chunks. Either way the 8 rows an ldmatrix reads at one
// column fall on 8 different bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (D % 64 == 0) {
    return row * D + ((chunk ^ (row & 7)) << 3);
  } else {
    static_assert((mma_tiles::row_elems<D>() / 8) % 2 == 1,
                  "a padded row holds an odd number of chunks");
    return row * mma_tiles::row_elems<D>() + (chunk << 3);
  }
}

// One block owns 64 query rows of one (batch, head); warp w owns rows
// 16w .. 16w+15 of them. Per KV tile of 64 keys: S = Q K^T (16 x 64 a warp,
// fp32 in registers), scaled, masked, the online softmax across each row's
// quad of lanes, P rounded to bf16 in registers and used as the A operand
// of O += P V. The next KV tile is in flight (cp.async) meanwhile.
//
// mma.sync m16n8k16 fragments (g = lane / 4, t = lane % 4): A holds rows g
// and g+8, columns 2t, 2t+1 and 2t+8, 2t+9; B columns (n) g, rows (k) 2t,
// 2t+1 and 2t+8, 2t+9; C rows g and g+8, columns 2t, 2t+1. Q's A fragments
// and K's B fragments come from row-major tiles by ldmatrix, V's B fragments
// (k = key, n = d) by ldmatrix.trans; the score accumulators of two
// neighbouring 8-key tiles are exactly P's A fragment for a 16-key step.
template <int D>
__global__ void __launch_bounds__(mma_tiles::THREADS,
                                  mma_tiles::blocks_per_sm<D>())
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int Hkv,
                 int seq_k, float scale, int causal, int has_window,
                 int window, int q_offset) {
  // block-scope names hide the fp32 kernel's BQ and THREADS
  using mma_tiles::BQ; using mma_tiles::BKV; using mma_tiles::THREADS;
  constexpr int CH = D / 8;        // 16-byte chunks a row
  constexpr int RS = mma_tiles::row_elems<D>();   // row stride of the tiles
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + BQ * RS;
  __nv_bfloat16* Vs = Ks + 2 * BKV * RS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // blocks start in the order x, y, z: query tiles on z, last tile first,
  // so the longest causal rows of every head start first and the short
  // tiles fill the last wave (at any q_offset: a later tile's rows see
  // at least the keys an earlier tile's do)
  const int q_start = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * D;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;

  // the KV tiles the reference's skip test keeps (kernel.py:53-60, at this
  // kernel's tile sizes) form the range kt_lo .. kt_hi
  int kt_lo = 0, kt_hi = (seq_k + BKV - 1) / BKV - 1;
  if (causal) kt_hi = min(kt_hi, (q_start + q_offset + BQ - 1) / BKV);
  if (has_window) {
    const int t = q_start + q_offset - window - BKV + 1;   // iff k_start > t
    if (t >= 0) kt_lo = t / BKV + 1;
  }

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, s = q_start + r;
    cp_async16(Qs + swz<D>(r, c), qb + (size_t)min(s, Sq - 1) * q_row + c * 8,
               s < Sq ? 16 : 0);
  }
  auto load_kv = [&](int kt, int buf) {
    __nv_bfloat16* kd = Ks + buf * BKV * RS;
    __nv_bfloat16* vd = Vs + buf * BKV * RS;
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, key = kt * BKV + r;
      const bool in = key < seq_k;              // past seq_k: zeros
      const size_t off = (size_t)(in ? key : 0) * kv_row + c * 8;
      cp_async16(kd + swz<D>(r, c), kb + off, in ? 16 : 0);
      cp_async16(vd + swz<D>(r, c), vb + off, in ? 16 : 0);
    }
  };
  if (kt_lo <= kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-deep step of D:
  // loaded once into registers, or at each step from Qs (which only this
  // warp reads at its rows) for the large head dims
  constexpr bool QREG = mma_tiles::q_in_registers<D>();
  const int q_row0 = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
  uint32_t qf[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldmatrix_x4(qf[kd], Qs + swz<D>(q_row0, kd * 2 + lane / 16));
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};   // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};         // this thread's share of the row sum
  const int q_g = q_start + warp * 16 + lane / 4;   // row g

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BKV * RS;
    const __nv_bfloat16* Vt = Vs + buf * BKV * RS;

    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qa[4];
      if constexpr (QREG) {
        qa[0] = qf[kd][0]; qa[1] = qf[kd][1];
        qa[2] = qf[kd][2]; qa[3] = qf[kd][3];
      } else {
        ldmatrix_x4(qa, Qs + swz<D>(q_row0, kd * 2 + lane / 16));
      }
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + swz<D>(np * 16 + (lane % 8) + 8 * (lane / 16),
                                    kd * 2 + (lane / 8) % 2));
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // scale the fp32 scores; mask only tiles that cross the diagonal, the
    // window's edge or seq_k. The masks compare rows with keys in the rows'
    // frame (key position - q_offset), so the offset costs one register a
    // tile and none a score
    const int k0 = kt * BKV;
    const bool edge = k0 + BKV > seq_k ||
                      (causal && k0 + BKV - 1 > q_start + q_offset) ||
                      (has_window && q_start + q_offset + BQ - 1 - k0 >= window);
    const int off = opaque(q_offset), k0r = k0 - off;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int kp = k0r + j * 8 + (lane % 4) * 2 + (e & 1);
          const int qp = q_g + (e >= 2 ? 8 : 0);
          bool ok = kp + off < seq_k;
          if (causal) ok = ok && qp >= kp;
          if (has_window) ok = ok && (qp - kp < window);
          if (!ok) x = NEG_INF;
        }
        s[j][e] = x;
      }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        s[j][2 * r] = __expf(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = __expf(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + sum;   // l from the fp32 P
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + swz<D>(kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2),
                                          dp * 2 + lane / 16));
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

  // out = acc / max(l, 1e-37), staged through this warp's own rows of Qs
  // (read only by this warp, for its Q fragments, and no longer) so that
  // the stores to global memory are whole 16-byte chunks
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-37f);
    const int row = warp * 16 + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(Qs + swz<D>(row, j) + (lane % 4) * 2) =
          __floats2bfloat162_rn(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, s = q_start + warp * 16 + r;
    if (s < Sq)
      *reinterpret_cast<uint4*>(ob + (size_t)s * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<D>(warp * 16 + r, c));
  }
}

template <int D>
int launch_mma_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Sq,
                 int Sk, int H, int Hkv, int seq_k, float scale, int causal,
                 int has_window, int window, int q_offset,
                 cudaStream_t stream) {
  using mma_tiles::BQ; using mma_tiles::THREADS;
  constexpr size_t smem = mma_tiles::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_kernel_mma<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, Sq, Sk, H, Hkv, seq_k, scale, causal, has_window, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Sq, int Sk,
               int H, int Hkv, int D, int seq_k, float scale, int causal,
               int has_window, int window, int q_offset,
               cudaStream_t stream) {
  if (D == 64)
    return launch_mma_d<64>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                            causal, has_window, window, q_offset, stream);
  if (D == 80)
    return launch_mma_d<80>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                            causal, has_window, window, q_offset, stream);
  if (D == 128)
    return launch_mma_d<128>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                             causal, has_window, window, q_offset, stream);
  if (D == 192)
    return launch_mma_d<192>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                             causal, has_window, window, q_offset, stream);
  if (D == 256)
    return launch_mma_d<256>(q, k, v, o, B, Sq, Sk, H, Hkv, seq_k, scale,
                             causal, has_window, window, q_offset, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a head
// size other than 64, 80, 128, 192 or 256, which the wrapper refuses first).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int seq_k,
                                   float scale, int causal, int has_window,
                                   int window, int q_offset,
                                   cudaStream_t stream) {
  return launch<float>(q, k, v, o, B, Sq, Sk, H, Hkv, D, seq_k, scale,
                       causal, has_window, window, q_offset, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int B, int Sq, int Sk, int H, int Hkv,
                                    int D, int seq_k, float scale, int causal,
                                    int has_window, int window,
                                    int q_offset, cudaStream_t stream) {
  return launch_mma(q, k, v, o, B, Sq, Sk, H, Hkv, D, seq_k, scale, causal,
                    has_window, window, q_offset, stream);
}
