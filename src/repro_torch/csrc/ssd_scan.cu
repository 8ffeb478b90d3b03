// Chunked SSD scan (Mamba2 state-space duality) for Hopper (sm_90a), with the
// pruning head-mask epilogue:
//     x (B, S, H, P)   dt (B, S, H) float32   A (H,) float32
//     Bm, Cm (B, S, G, N), head h reads group h / (H / G)
//     head_mask (H,) float32
//  -> y (B, S, H, P) contiguous, in x's type, multiplied by head_mask[h];
//     state (B, H, P, N) float32, contiguous: the state after the last step,
//     for every head, pruned heads included, unmasked.
// x, Bm and Cm are float32 (ssd_scan_f32) or bfloat16 (ssd_scan_bf16); their
// last dimension is contiguous, the batch and step strides are arguments, so
// the wrapper passes the slices of the block's conv output as they lie.
// P = 64 and N = 64 or 128 (Zamba2-1.2B and Mamba2-2.7B). Sums are float32;
// y is rounded once.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:_ssd_kernel
// (ssd_scan_pallas). That kernel ran a grid (B, H, n_chunks) whose chunk axis
// was sequential ("arbitrary"), carrying the (P, N) state across grid steps
// in VMEM scratch, on inputs its wrapper had padded to whole 256-step chunks.
// Blocks on this card run in parallel and in no order. The recurrence is
// associative in the chunks, so the bf16 entry (the serving path) runs
// Mamba2's own chunked decomposition with the chunks in parallel, in three
// launches, chunks of Q = 256 steps (the model's chunk_size and the plain
// version's):
//   1. ssd_chunk_state_kernel, per (b, h, chunk): cs = cumsum(dt A), stored
//      once as float32 for the other passes, and the chunk's own state
//      S_c = (x o dt o exp(cs_end - cs))^T B into a workspace
//      (B, H, n_chunks, P, N), 21 MB at Mamba2-2.7B's R1 (in the 50 MB L2);
//   2. ssd_state_pass_kernel, per (b, h, 512 state entries): in chunk order
//      h_c = h_{c-1} exp(cs_end,c) + S_c, each S_c replaced by the state
//      carried into its chunk, the final state written for every head;
//   3. ssd_chunk_out_kernel, per (b, h, chunk, 64-row query tile):
//      y = sum over key tiles <= the query tile of ((C B^T) o L o dt) x
//          + exp(cs) o (C h_{c-1}^T),  L[i, j] = exp(cs_i - cs_j), j <= i,
//      then y * head_mask[h]; a pruned head writes exact zeros and skips
//      every product.
// The products run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulators), fragments by ldmatrix from XOR-swizzled tiles that cp.async
// fills (steps at or past S as zeros: nothing is padded). C, B and x enter
// exactly, being bf16; the float32 left operands (W = (C B^T) o L o dt and
// the carried state in pass 3, the decayed x in pass 1) are split into hi =
// bf16(v) and lo = bf16(v - hi), one mma each, which keeps about 16 of
// float32's 24 bits; for a prompt shorter than a chunk, pass 1 takes a third
// part, which keeps all 24.
// L is computed only where j <= i, so exp never sees the positive exponents
// above the diagonal (up to +400 at A = -16, dt = 0.1, where exp overflows
// and inf * 0 would give NaN).
//
// What bounds it: bytes, at the card's rates. At Mamba2-2.7B's R1 (B = 1,
// S = 2048, H = 80, P = 64, N = 128, bf16) one call must read x, B, C, dt
// and write y and the state, ~46 MB, 0.014 ms at 3.35 TB/s; its ~13 GFLOP at
// the reference's chunk (the hi/lo splits double the products on the tensor
// cores) take 0.013 ms at the bf16 rate. B H n_chunks = 640 blocks in pass 1
// and 2,560 in pass 3 fill the 132 SMs.
//
// The float32 entry, off the serving path, keeps the first kernel
// (ssd_kernel): one block of 256 threads per (batch, head) walks the chunks
// in order with the state in registers (thread (ty, tx) of the 16 x 16
// layout owns state rows ty + 16 c and columns 4 tx + 64 k .. + 3) and a copy
// in shared memory that the next chunk reads. Per chunk of Q = 64 steps:
//   cs   = cumsum(dt A)                      (one warp, by shuffles)
//   W    = (C B^T) o L o dt_j,  L[i,j] = exp(cs_i - cs_j) for j <= i, else 0
//   y    = W x + exp(cs) o (C state^T)
//   state <- state exp(cs_end) + (x o dt o exp(cs_end - cs))^T B
// (the result does not depend on the chunk length in exact arithmetic), all
// in float32 FMAs on the CUDA cores over float4 reads of padded shared-memory
// rows: x [Q][P], B and C [Q][N+4], the state [P][N+4], W [Q][Q+4].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // steps per chunk
constexpr int THREADS = 256;   // a 16 x 16 thread layout
constexpr int TG = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Offsets (in floats) of the shared-memory arrays; each a multiple of 4.
template <int P, int N>
struct Layout {
  static constexpr int NS = N + 4;   // row of B, C and the state
  static constexpr int QS = Q + 4;   // row of W
  static constexpr int x = 0;                  // [Q][P]
  static constexpr int b = x + Q * P;          // [Q][NS]
  static constexpr int c = b + Q * NS;         // [Q][NS]
  static constexpr int st = c + Q * NS;        // [P][NS]
  static constexpr int w = st + P * NS;        // [Q][QS]
  static constexpr int cs = w + Q * QS;        // [Q] cumsum of dt A
  static constexpr int ecs = cs + Q;           // [Q] exp(cs_i)
  static constexpr int dt = ecs + Q;           // [Q]
  static constexpr int wj = dt + Q;            // [Q] dt_j exp(cs_end - cs_j)
  static constexpr size_t bytes = sizeof(float) * (wj + Q);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ head_mask,
           T* __restrict__ y, float* __restrict__ state, int S, int H,
           int G, int x_sb, int x_ss, int bc_sb, int bc_ss, int dt_sb,
           int dt_ss) {
  using L = Layout<P, N>;
  constexpr int PC = P / TG;        // state / y columns per thread
  constexpr int NK = N / (4 * TG);  // float4 state columns per thread
  static_assert(P % TG == 0 && N % (4 * TG) == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xs = sm + L::x;
  float* bs = sm + L::b;
  float* cs_ = sm + L::c;
  float* sts = sm + L::st;
  float* ws = sm + L::w;
  float* cum = sm + L::cs;
  float* ecs = sm + L::ecs;
  float* dts = sm + L::dt;
  float* wj = sm + L::wj;

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / TG;
  const int tx = tid % TG;
  const T* xb = x + (size_t)bi * x_sb + (size_t)h * P;
  const T* bb = Bm + (size_t)bi * bc_sb + (size_t)g * N;
  const T* cb = Cm + (size_t)bi * bc_sb + (size_t)g * N;
  const float* db = dt + (size_t)bi * dt_sb + h;
  T* yb = y + (size_t)bi * S * H * P + (size_t)h * P;
  const float a = A[h];
  const float hm = head_mask[h];

  float4 st[PC][NK];
#pragma unroll
  for (int c = 0; c < PC; ++c)
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      st[c][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sts + (ty + TG * c) * L::NS + 4 * tx +
                                 4 * TG * k) = st[c][k];
    }

  for (int s0 = 0; s0 < S; s0 += Q) {
    // load the chunk, steps past S as zeros
    for (int e = tid; e < Q * P; e += THREADS) {
      const int j = e / P, p = e % P;
      xs[e] = s0 + j < S ? to_f32(xb[(size_t)(s0 + j) * x_ss + p]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e % N;
      const bool in = s0 + j < S;
      const size_t off = (size_t)(s0 + j) * bc_ss + n;
      bs[j * L::NS + n] = in ? to_f32(bb[off]) : 0.f;
      cs_[j * L::NS + n] = in ? to_f32(cb[off]) : 0.f;
    }
    if (tid < Q)
      dts[tid] = s0 + tid < S ? db[(size_t)(s0 + tid) * dt_ss] : 0.f;
    __syncthreads();

    // cs = cumsum(dt A) over the chunk: lane l holds steps 2l and 2l+1
    if (tid < 32) {
      const float a0 = dts[2 * tid] * a;
      const float a1 = dts[2 * tid + 1] * a;
      float inc = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += v;
      }
      float before = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) before = 0.f;
      const float c0 = before + a0;
      const float c1 = c0 + a1;
      const float cend = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecs[2 * tid] = expf(c0);
      ecs[2 * tid + 1] = expf(c1);
      wj[2 * tid] = dts[2 * tid] * expf(cend - c0);
      wj[2 * tid + 1] = dts[2 * tid + 1] * expf(cend - c1);
    }
    __syncthreads();

    // W[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0;
    // rows i = ty + 16 r, columns j = tx + 16 c
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs_ + (ty + TG * r) * L::NS + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = ld4(bs + (tx + TG * c) * L::NS + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = dot4(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + TG * r, j = tx + TG * c;
          // select, never multiply: exp(cs_i - cs_j) overflows for j > i
          const float wv =
              j <= i ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          ws[i * L::QS + j] = wv;
        }
    }
    __syncthreads();

    // y[i][p] = exp(cs_i) (C_i . state_p) + sum_j W[i][j] x[j][p]; rows
    // i = ty + 16 r, columns p = tx + 16 c
    {
      float yv[4][PC] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs_ + (ty + TG * r) * L::NS + n);
#pragma unroll
        for (int c = 0; c < PC; ++c)
          sv[c] = ld4(sts + (tx + TG * c) * L::NS + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) yv[r][c] = dot4(cv[r], sv[c], yv[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecs[ty + TG * r];
#pragma unroll
        for (int c = 0; c < PC; ++c) yv[r][c] *= e;
      }
      for (int j = 0; j < Q; j += 4) {
        float4 wv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = ld4(ws + (ty + TG * r) * L::QS + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xv[PC];
#pragma unroll
          for (int c = 0; c < PC; ++c) xv[c] = xs[(j + jj) * P + tx + TG * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float w = jj == 0 ? wv[r].x : jj == 1 ? wv[r].y
                            : jj == 2 ? wv[r].z : wv[r].w;
#pragma unroll
            for (int c = 0; c < PC; ++c) yv[r][c] = fmaf(w, xv[c], yv[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = s0 + ty + TG * r;
        if (s >= S) continue;
#pragma unroll
        for (int c = 0; c < PC; ++c)
          store(yb + (size_t)s * H * P + tx + TG * c, yv[r][c] * hm);
      }
    }

    // state <- state exp(cs_end) + sum_j (x_j dt_j exp(cs_end - cs_j)) B_j,
    // in this thread's registers
    {
      const float dec = expf(cum[Q - 1]);
#pragma unroll
      for (int c = 0; c < PC; ++c)
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          st[c][k].x *= dec;
          st[c][k].y *= dec;
          st[c][k].z *= dec;
          st[c][k].w *= dec;
        }
      for (int j = 0; j < Q; ++j) {
        const float w = wj[j];
        float xv[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = xs[j * P + ty + TG * c] * w;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float4 bv = ld4(bs + j * L::NS + 4 * tx + 4 * TG * k);
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            st[c][k].x = fmaf(xv[c], bv.x, st[c][k].x);
            st[c][k].y = fmaf(xv[c], bv.y, st[c][k].y);
            st[c][k].z = fmaf(xv[c], bv.z, st[c][k].z);
            st[c][k].w = fmaf(xv[c], bv.w, st[c][k].w);
          }
        }
      }
    }
    __syncthreads();   // every read of this chunk's x, B, C and state done
#pragma unroll
    for (int c = 0; c < PC; ++c)
#pragma unroll
      for (int k = 0; k < NK; ++k)
        *reinterpret_cast<float4*>(sts + (ty + TG * c) * L::NS + 4 * tx +
                                   4 * TG * k) = st[c][k];
  }

  float* sb = state + ((size_t)bi * H + h) * P * N;
#pragma unroll
  for (int c = 0; c < PC; ++c)
#pragma unroll
    for (int k = 0; k < NK; ++k)
      *reinterpret_cast<float4*>(sb + (ty + TG * c) * N + 4 * tx +
                                 4 * TG * k) = st[c][k];
}

template <typename T, int P, int N>
int launch_pn(const T* x, const float* dt, const float* A, const T* Bm,
              const T* Cm, const float* head_mask, T* y, float* state, int B,
              int S, int H, int G, int x_sb, int x_ss, int bc_sb, int bc_ss,
              int dt_sb, int dt_ss, cudaStream_t stream) {
  constexpr size_t smem = Layout<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  ssd_kernel<T, P, N><<<grid, THREADS, smem, stream>>>(
      x, dt, A, Bm, Cm, head_mask, y, state, S, H, G, x_sb, x_ss, bc_sb,
      bc_ss, dt_sb, dt_ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* head_mask, T* y, float* state, int B,
           int S, int H, int G, int P, int N, int x_sb, int x_ss, int bc_sb,
           int bc_ss, int dt_sb, int dt_ss, cudaStream_t stream) {
  if (P == 64 && N == 128)
    return launch_pn<T, 64, 128>(x, dt, A, Bm, Cm, head_mask, y, state, B, S,
                                 H, G, x_sb, x_ss, bc_sb, bc_ss, dt_sb, dt_ss,
                                 stream);
  if (P == 64 && N == 64)
    return launch_pn<T, 64, 64>(x, dt, A, Bm, Cm, head_mask, y, state, B, S,
                                H, G, x_sb, x_ss, bc_sb, bc_ss, dt_sb, dt_ss,
                                stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The bf16 entry: Mamba2's chunked decomposition, chunks in parallel, the
// products on the tensor cores
// ---------------------------------------------------------------------------
namespace chunked {
constexpr int Q = 256;          // steps a chunk: the model's chunk_size
constexpr int RT = 64;          // rows (steps) of a pass-3 tile
constexpr int TILES = Q / RT;   // query tiles a chunk
constexpr int THREADS = 128;    // 4 warps of 16 rows
constexpr int WARPS = THREADS / 32;
}  // namespace chunked

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
// A float32 pair as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi) (v - hi
// is exact in float32), so hi + lo keeps about 16 of v's 24 bits
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// ... and as three: hi, mid = bf16(v - hi), lo = bf16(v - hi - mid), which
// keeps float32's 24 bits
__device__ __forceinline__ void split3_bf16(float v0, float v1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// Offset (in elements) of 16-byte chunk `chunk` of row `row` in a tile of
// rows of D bf16: the chunk index is XORed with row % 8, so the 8 rows an
// ldmatrix reads at one column fall on 8 different bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}
template <int D>
__device__ __forceinline__ float tile_at(const __nv_bfloat16* t, int row,
                                         int col) {
  return __bfloat162float(t[swz<D>(row, col / 8) + col % 8]);
}
// ROWS rows of D bf16 from `src` (step s at src + s * stride), from step
// `first` on, into a swizzled tile; steps at or past S as zeros
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int stride, int first, int S) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += chunked::THREADS) {
    const int r = i / (D / 8), ch = i % (D / 8), s = first + r;
    const bool in = s < S;
    cp_async16(dst + swz<D>(r, ch), src + (size_t)(in ? s : 0) * stride + ch * 8,
               in ? 16 : 0);
  }
}

// mma.sync m16n8k16 fragments (g = lane / 4, t = lane % 4): A holds rows g
// and g+8, columns 2t, 2t+1 and 2t+8, 2t+9; B columns (n) g, rows (k) 2t,
// 2t+1 and 2t+8, 2t+9; C rows g and g+8, columns 2t, 2t+1. A tile stored
// [k][n] gives B fragments by ldmatrix.trans, one stored [n][k] by ldmatrix.

template <int P, int N>
constexpr size_t state_smem() {
  return 2 * 2 * (size_t)chunked::RT * (P + N) +
         sizeof(float) * (chunked::Q + chunked::WARPS + 1);
}

// Pass 1, block (chunk c, head h, batch b): cs = cumsum(dt A) over the chunk
// (stored once, float32, for the other passes) and the chunk's own state
//   S_c = (x o dt o exp(cs_end - cs))^T B      (P x N, float32)
// into the workspace. Warp w computes rows p = 16w .. 16w+15 over the whole
// chunk, 64 steps at a time, the next 64 in flight (cp.async, two buffers):
// the decayed x is split into PARTS bf16 parts, one mma each, B enters as it
// is. The final state comes from this pass alone, and its bound is (N + q +
// n_chunks + 2 max|cs|) eps32 at a chunk of q steps: two parts (2^-16 = 128
// eps32 a product) keep within it when the prompt fills a 256-step chunk,
// three (float32's own 2^-24) when it is shorter.
template <int P, int N, int PARTS>
__global__ void __launch_bounds__(chunked::THREADS)
ssd_chunk_state_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const __nv_bfloat16* __restrict__ Bm,
                       float* __restrict__ ws_cs, float* __restrict__ ws_st,
                       int S, int H, int G, int x_sb, int x_ss, int bc_sb,
                       int bc_ss, int dt_sb, int dt_ss) {
  using chunked::Q; using chunked::RT; using chunked::THREADS;
  using chunked::WARPS;
  static_assert(P == 16 * WARPS && Q == 2 * THREADS, "pass-1 layout");
  extern __shared__ __align__(128) unsigned char st_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st_smem);  // [2][RT][P]
  __nv_bfloat16* bs = xs + 2 * RT * P;                           // [2][RT][N]
  float* wj = reinterpret_cast<float*>(bs + 2 * RT * N);  // [Q] dt exp(cs_end - cs)
  float* wsum = wj + Q;                                   // [WARPS + 1]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = c * Q;
  const __nv_bfloat16* xb = x + (size_t)b * x_sb + (size_t)h * P;
  const __nv_bfloat16* bb = Bm + (size_t)b * bc_sb + (size_t)g * N;
  const int tiles = (min(S - s0, Q) + RT - 1) / RT;   // steps past S add 0
  load_rows<RT, P>(xs, xb, x_ss, s0, S);
  load_rows<RT, N>(bs, bb, bc_ss, s0, S);
  cp_async_commit();

  // cs over the chunk, thread t holding steps 2t and 2t+1; steps past S have
  // dt = 0, so they decay nothing and cs_end is the last step's
  const float a = A[h];
  const float* db = dt + (size_t)b * dt_sb + h;
  const int j0 = s0 + 2 * tid;
  const float d0 = j0 < S ? db[(size_t)j0 * dt_ss] : 0.0f;
  const float d1 = j0 + 1 < S ? db[(size_t)(j0 + 1) * dt_ss] : 0.0f;
  const float a0 = d0 * a, a1 = d1 * a;
  float inc = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  float before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before = 0.0f;
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  float base = 0.0f;
  for (int w = 0; w < warp; ++w) base += wsum[w];
  const float c0 = base + before + a0;
  const float c1 = c0 + a1;
  float* csb = ws_cs + ((size_t)(b * H + h) * nc + c) * Q;
  *reinterpret_cast<float2*>(csb + 2 * tid) = make_float2(c0, c1);
  if (tid == THREADS - 1) wsum[WARPS] = c1;
  __syncthreads();
  const float cend = wsum[WARPS];
  wj[2 * tid] = d0 * expf(cend - c0);
  wj[2 * tid + 1] = d1 * expf(cend - c1);

  float acc[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const int t = lane % 4;
  const int p0 = warp * 16 + lane / 4;   // rows p0 and p0 + 8
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles) {
      load_rows<RT, P>(xs + (buf ^ 1) * RT * P, xb, x_ss, s0 + (tile + 1) * RT, S);
      load_rows<RT, N>(bs + (buf ^ 1) * RT * N, bb, bc_ss, s0 + (tile + 1) * RT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // the tile has landed, and wj is written
    const __nv_bfloat16* xt = xs + buf * RT * P;
    const __nv_bfloat16* bt = bs + buf * RT * N;
    const float* wt = wj + tile * RT;
    // not unrolled: 127 registers against 170 at N = 128, four blocks an SM
#pragma unroll 1
    for (int ks = 0; ks < RT / 16; ++ks) {
      // A(p, j) = x[j][p] w_j at steps j, j+1, j+8, j+9 of the tile
      const int j = ks * 16 + 2 * t;
      const float w0 = wt[j], w1 = wt[j + 1], w8 = wt[j + 8], w9 = wt[j + 9];
      const float v[4][2] = {
          {tile_at<P>(xt, j, p0) * w0, tile_at<P>(xt, j + 1, p0) * w1},
          {tile_at<P>(xt, j, p0 + 8) * w0, tile_at<P>(xt, j + 1, p0 + 8) * w1},
          {tile_at<P>(xt, j + 8, p0) * w8, tile_at<P>(xt, j + 9, p0) * w9},
          {tile_at<P>(xt, j + 8, p0 + 8) * w8,
           tile_at<P>(xt, j + 9, p0 + 8) * w9}};
      uint32_t part[PARTS][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (PARTS == 3)
          split3_bf16(v[r][0], v[r][1], part[0][r], part[1][r], part[2][r]);
        else
          split_bf16(v[r][0], v[r][1], part[0][r], part[1][r]);
      }
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, bt + swz<N>(ks * 16 + (lane % 8) + 8 * ((lane / 8) % 2),
                                         np * 2 + lane / 16));
#pragma unroll
        for (int q = 0; q < PARTS; ++q) {
          mma_bf16(acc[2 * np], part[q], f[0], f[1]);
          mma_bf16(acc[2 * np + 1], part[q], f[2], f[3]);
        }
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }
  float* st = ws_st + ((size_t)(b * H + h) * nc + c) * P * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(st + (size_t)p0 * N + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(st + (size_t)(p0 + 8) * N + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// Pass 2, per (batch, head) and 512 entries of the state: in chunk order,
//   h_c = h_{c-1} exp(cs_end,c) + S_c,
// each chunk's own state in the workspace replaced by the state carried
// into it (h_{c-1}); the final state written for every head.
template <int P, int N>
__global__ void __launch_bounds__(chunked::THREADS)
ssd_state_pass_kernel(const float* __restrict__ ws_cs,
                      float* __restrict__ ws_st, float* __restrict__ state,
                      int H, int nc) {
  using chunked::Q; using chunked::THREADS;
  constexpr int STEP = P * N / 4;        // float4s a chunk's state
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  float4* st = reinterpret_cast<float4*>(ws_st + bh * nc * P * N) + e;
  const float* cs_end = ws_cs + bh * nc * Q + (Q - 1);
  float4 hc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 s = hc;
  float d = 1.0f;
  if (nc > 0) {
    s = st[0];
    d = expf(cs_end[0]);
  }
  for (int c = 0; c < nc; ++c) {
    float4 s_next = s;
    float d_next = d;
    if (c + 1 < nc) {   // the next chunk's loads do not wait on this one
      s_next = st[(size_t)(c + 1) * STEP];
      d_next = expf(cs_end[(size_t)(c + 1) * Q]);
    }
    st[(size_t)c * STEP] = hc;
    hc = make_float4(hc.x * d + s.x, hc.y * d + s.y, hc.z * d + s.z,
                     hc.w * d + s.w);
    s = s_next;
    d = d_next;
  }
  reinterpret_cast<float4*>(state + bh * P * N)[e] = hc;
}

template <int P, int N>
constexpr size_t out_smem() {
  return 2 * (size_t)chunked::RT * (2 * N + 2 * P) +
         3 * sizeof(float) * chunked::Q;
}

// Pass 3, block (query tile of a chunk, head, batch), warp w on 16 rows i:
//   y = exp(cs_i) (C_i . h_{c-1}^T) + sum over key tiles <= the query tile of
//       ((C B^T) o L o dt) x,   L[i, j] = exp(cs_i - cs_j) for j <= i, else 0,
// then y * head_mask[h], rounded to bf16 once. C, B and x enter exactly;
// the carried state and W = (C B^T) o L o dt are split into bf16 hi and lo.
// L is computed only where j <= i, so exp never sees a positive exponent.
// A pruned head writes exact zeros and computes nothing.
template <int P, int N>
__global__ void __launch_bounds__(chunked::THREADS)
ssd_chunk_out_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt,
                     const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm,
                     const float* __restrict__ head_mask,
                     const float* __restrict__ ws_cs,
                     const float* __restrict__ ws_st,
                     __nv_bfloat16* __restrict__ y, int S, int H, int G,
                     int x_sb, int x_ss, int bc_sb, int bc_ss, int dt_sb,
                     int dt_ss) {
  using chunked::Q; using chunked::RT; using chunked::TILES;
  using chunked::THREADS;
  // the key tiles' two buffers hold, before the key loop, this block's rows
  // of C (buffer 1 of B) and the carried state's hi (buffer 0 of B) and lo
  // (both buffers of x) parts: 51 KB at N = 128, three blocks an SM
  static_assert(P == RT && N <= 2 * RT, "pass-3 shared-memory layout");
  extern __shared__ __align__(128) unsigned char out_smem_[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(out_smem_);  // [2][RT][N]
  __nv_bfloat16* Xs = Bs + 2 * RT * N;       // [2][RT][P]
  __nv_bfloat16* Cs = Bs + RT * N;           // [RT][N], before the key loop
  __nv_bfloat16* Hhi = Bs;                   // [P][N], before the key loop
  __nv_bfloat16* Hlo = Xs;                   // [P][N], before the key loop
  float* csm = reinterpret_cast<float*>(Xs + 2 * RT * P);   // [Q]
  float* dts = csm + Q;                                      // [Q]
  float* us = dts + Q;        // [Q] dt_j exp(cs_end(tile of j) - cs_j)

  // query tiles of a chunk last first: the longest rows start first
  const int nc = gridDim.x / TILES;
  const int c = blockIdx.x / TILES, qt = TILES - 1 - blockIdx.x % TILES;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = c * Q, r0 = qt * RT;
  if (s0 + r0 >= S) return;
  const size_t y_row = (size_t)H * P;
  __nv_bfloat16* yb = y + (size_t)b * S * y_row + (size_t)h * P;
  const float hm = head_mask[h];
  if (hm == 0.0f) {
    for (int i = tid; i < RT * (P / 8); i += THREADS) {
      const int s = s0 + r0 + i / (P / 8);
      if (s < S)
        *reinterpret_cast<uint4*>(yb + s * y_row + (i % (P / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const __nv_bfloat16* xb = x + (size_t)b * x_sb + (size_t)h * P;
  const __nv_bfloat16* bb = Bm + (size_t)b * bc_sb + (size_t)g * N;
  load_rows<RT, N>(Cs, Cm + (size_t)b * bc_sb + (size_t)g * N, bc_ss,
                   s0 + r0, S);
  cp_async_commit();
  const size_t bhc = ((size_t)b * H + h) * nc + c;
  const float* db = dt + (size_t)b * dt_sb + h;
  for (int i = tid; i < r0 + RT; i += THREADS) {
    csm[i] = ws_cs[bhc * Q + i];
    dts[i] = s0 + i < S ? db[(size_t)(s0 + i) * dt_ss] : 0.0f;
  }
  __syncthreads();
  // key tiles before the query tile lie wholly below the diagonal, where
  // L[i, j] = exp(cs_i - e) exp(e - cs_j), e the key tile's last cs: both
  // exponents <= 0 (cs falls), one exp a step and one a row, not one a pair
  for (int j = tid; j < r0; j += THREADS)
    us[j] = dts[j] * expf(csm[(j / RT) * RT + RT - 1] - csm[j]);
  if (c > 0) {   // the state carried into the chunk, split into hi and lo
    const float* hin = ws_st + bhc * P * N;
    for (int i = tid; i < P * (N / 8); i += THREADS) {
      const int p = i / (N / 8), ch = i % (N / 8);
      const float4 u = *reinterpret_cast<const float4*>(hin + p * N + ch * 8);
      const float4 v =
          *reinterpret_cast<const float4*>(hin + p * N + ch * 8 + 4);
      uint4 hi, lo;
      split_bf16(u.x, u.y, hi.x, lo.x);
      split_bf16(u.z, u.w, hi.y, lo.y);
      split_bf16(v.x, v.y, hi.z, lo.z);
      split_bf16(v.z, v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(Hhi + swz<N>(p, ch)) = hi;
      *reinterpret_cast<uint4*>(Hlo + swz<N>(p, ch)) = lo;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 rows of C as A fragments, one per 16-deep step of N
  uint32_t cf[N / 16][4];
#pragma unroll
  for (int kd = 0; kd < N / 16; ++kd)
    ldmatrix_x4(cf[kd], Cs + swz<N>(warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2),
                                    kd * 2 + lane / 16));
  const int t = lane % 4;
  const int i0 = r0 + warp * 16 + lane / 4;   // rows i0 and i0 + 8
  float acc[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  if (c > 0) {
    float off[P / 8][4];
#pragma unroll
    for (int n = 0; n < P / 8; ++n) off[n][0] = off[n][1] = off[n][2] = off[n][3] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < N / 16; ++kd)
#pragma unroll
      for (int np = 0; np < P / 16; ++np) {
        const int at = swz<N>(np * 16 + (lane % 8) + 8 * (lane / 16),
                              kd * 2 + (lane / 8) % 2);
        uint32_t f[4];
        ldmatrix_x4(f, Hhi + at);
        mma_bf16(off[2 * np], cf[kd], f[0], f[1]);
        mma_bf16(off[2 * np + 1], cf[kd], f[2], f[3]);
        ldmatrix_x4(f, Hlo + at);
        mma_bf16(off[2 * np], cf[kd], f[0], f[1]);
        mma_bf16(off[2 * np + 1], cf[kd], f[2], f[3]);
      }
    const float e0 = expf(csm[i0]), e1 = expf(csm[i0 + 8]);
#pragma unroll
    for (int n = 0; n < P / 8; ++n) {
      acc[n][0] = off[n][0] * e0;
      acc[n][1] = off[n][1] * e0;
      acc[n][2] = off[n][2] * e1;
      acc[n][3] = off[n][3] * e1;
    }
  }
  __syncthreads();   // C and the state are read: the buffers take key tiles
  load_rows<RT, N>(Bs, bb, bc_ss, s0, S);
  load_rows<RT, P>(Xs, xb, x_ss, s0, S);
  cp_async_commit();

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    if (kt < qt) {
      load_rows<RT, N>(Bs + (buf ^ 1) * RT * N, bb, bc_ss, s0 + (kt + 1) * RT, S);
      load_rows<RT, P>(Xs + (buf ^ 1) * RT * P, xb, x_ss, s0 + (kt + 1) * RT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Bt = Bs + buf * RT * N;
    const __nv_bfloat16* Xt = Xs + buf * RT * P;

    // W = (C B^T) o L o dt over this warp's 16 rows and the tile's steps
    float w[RT / 8][4];
#pragma unroll
    for (int n = 0; n < RT / 8; ++n) w[n][0] = w[n][1] = w[n][2] = w[n][3] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < N / 16; ++kd)
#pragma unroll
      for (int np = 0; np < RT / 16; ++np) {
        uint32_t f[4];
        ldmatrix_x4(f, Bt + swz<N>(np * 16 + (lane % 8) + 8 * (lane / 16),
                                   kd * 2 + (lane / 8) % 2));
        mma_bf16(w[2 * np], cf[kd], f[0], f[1]);
        mma_bf16(w[2 * np + 1], cf[kd], f[2], f[3]);
      }
    if (kt < qt) {
      const float e = csm[kt * RT + RT - 1];
      const float v0 = expf(csm[i0] - e), v1 = expf(csm[i0 + 8] - e);
#pragma unroll
      for (int n = 0; n < RT / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[n][q] *= (q >= 2 ? v1 : v0) * us[kt * RT + n * 8 + 2 * t + (q & 1)];
    } else {
#pragma unroll
      for (int n = 0; n < RT / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = kt * RT + n * 8 + 2 * t + (q & 1);
          const int i = i0 + (q >= 2 ? 8 : 0);
          // select, never multiply: exp(cs_i - cs_j) overflows for j > i
          w[n][q] = j <= i ? w[n][q] * expf(csm[i] - csm[j]) * dts[j] : 0.0f;
        }
    }

    // y += W x: two neighbouring 8-step accumulators are W's A fragment for
    // a 16-step k, split into hi and lo
#pragma unroll
    for (int kk = 0; kk < RT / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(w[2 * kk][0], w[2 * kk][1], hi[0], lo[0]);
      split_bf16(w[2 * kk][2], w[2 * kk][3], hi[1], lo[1]);
      split_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, Xt + swz<P>(kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2),
                                         dp * 2 + lane / 16));
        mma_bf16(acc[2 * dp], hi, f[0], f[1]);
        mma_bf16(acc[2 * dp], lo, f[0], f[1]);
        mma_bf16(acc[2 * dp + 1], hi, f[2], f[3]);
        mma_bf16(acc[2 * dp + 1], lo, f[2], f[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + i0 + 8 * r;
    if (s >= S) continue;
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(yb + s * y_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * hm, acc[n][2 * r + 1] * hm);
  }
}

template <int P, int N>
int launch_chunked_pn(const __nv_bfloat16* x, const float* dt, const float* A,
                      const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
                      const float* head_mask, __nv_bfloat16* y, float* state,
                      float* ws_cs, float* ws_st, int B, int S, int H, int G,
                      int x_sb, int x_ss, int bc_sb, int bc_ss, int dt_sb,
                      int dt_ss, cudaStream_t stream) {
  using chunked::Q; using chunked::THREADS; using chunked::TILES;
  constexpr size_t smem1 = state_smem<P, N>(), smem3 = out_smem<P, N>();
  // the state's parts: two for a prompt of at least a chunk, else three
  const auto state_kernel = S >= Q ? ssd_chunk_state_kernel<P, N, 2>
                                   : ssd_chunk_state_kernel<P, N, 3>;
  cudaError_t err = cudaFuncSetAttribute(
      state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_chunk_out_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = (S + Q - 1) / Q;
  if (nc > 0) {
    state_kernel<<<dim3(nc, H, B), THREADS, smem1, stream>>>(
        x, dt, A, Bm, ws_cs, ws_st, S, H, G, x_sb, x_ss, bc_sb, bc_ss, dt_sb,
        dt_ss);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // with S = 0 the state pass alone writes the zero state
  ssd_state_pass_kernel<P, N><<<dim3(P * N / 4 / THREADS, H, B), THREADS, 0,
                                stream>>>(ws_cs, ws_st, state, H, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  ssd_chunk_out_kernel<P, N><<<dim3(nc * TILES, H, B), THREADS, smem3,
                               stream>>>(
      x, dt, Bm, Cm, head_mask, ws_cs, ws_st, y, S, H, G, x_sb, x_ss, bc_sb,
      bc_ss, dt_sb, dt_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// (P, N) other than (64, 64) or (64, 128), which the wrapper refuses first).
// Strides are in elements: x_sb / x_ss of x's batch and step, bc_sb / bc_ss
// of Bm's and Cm's (equal), dt_sb / dt_ss of dt's.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm,
                            const float* head_mask, float* y, float* state,
                            float* ws_cs, float* ws_st, int B, int S, int H,
                            int G, int P, int N, int x_sb, int x_ss,
                            int bc_sb, int bc_ss, int dt_sb, int dt_ss,
                            cudaStream_t stream) {
  (void)ws_cs;   // the one-block-per-head kernel keeps its state on chip
  (void)ws_st;
  return launch<float>(x, dt, A, Bm, Cm, head_mask, y, state, B, S, H, G, P,
                       N, x_sb, x_ss, bc_sb, bc_ss, dt_sb, dt_ss, stream);
}

// ws_cs (B, H, n_chunks, 256) and ws_st (B, H, n_chunks, P, N), float32,
// n_chunks = ceil(S / 256): the passes' workspace, allocated by the caller.
extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* A, const __nv_bfloat16* Bm,
                             const __nv_bfloat16* Cm, const float* head_mask,
                             __nv_bfloat16* y, float* state, float* ws_cs,
                             float* ws_st, int B, int S, int H, int G, int P,
                             int N, int x_sb, int x_ss, int bc_sb, int bc_ss,
                             int dt_sb, int dt_ss, cudaStream_t stream) {
  if (P == 64 && N == 128)
    return launch_chunked_pn<64, 128>(x, dt, A, Bm, Cm, head_mask, y, state,
                                      ws_cs, ws_st, B, S, H, G, x_sb, x_ss,
                                      bc_sb, bc_ss, dt_sb, dt_ss, stream);
  if (P == 64 && N == 64)
    return launch_chunked_pn<64, 64>(x, dt, A, Bm, Cm, head_mask, y, state,
                                     ws_cs, ws_st, B, S, H, G, x_sb, x_ss,
                                     bc_sb, bc_ss, dt_sb, dt_ss, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
