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
// P = 64 and N = 64 or 128 (Zamba2-1.2B and Mamba2-2.7B). All arithmetic is
// float32; y is rounded once.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:_ssd_kernel
// (ssd_scan_pallas). That kernel ran a grid (B, H, n_chunks) whose chunk axis
// was sequential ("arbitrary"), carrying the (P, N) state across grid steps
// in VMEM scratch, on inputs its wrapper had padded to whole 256-step chunks,
// and built each chunk's whole (Q, Q) decay matrix and C B^T in VMEM. Blocks
// on this card run in parallel and in no order, so here one block of 256
// threads owns one (batch, head) pair and walks the chunks itself, in order,
// with the state in registers (thread (ty, tx) of the 16 x 16 layout owns
// state rows ty + 16 c and columns 4 tx + 64 k .. + 3) and a copy in shared
// memory that the next chunk reads. Per chunk of Q = 64 steps:
//   cs   = cumsum(dt A)                      (one warp, by shuffles)
//   W    = (C B^T) o L o dt_j,  L[i,j] = exp(cs_i - cs_j) for j <= i, else 0
//   y    = W x + exp(cs) o (C state^T)
//   state <- state exp(cs_end) + (x o dt o exp(cs_end - cs))^T B
// The result does not depend on the chunk length in exact arithmetic, so the
// kernel walks 64-step chunks whatever the model's chunk_size (the plain
// version keeps the reference's 256): a 256 x 256 float32 matrix alone would
// be 256 KB, more than a block's 227 KB of shared memory. L is never stored:
// each entry is computed from cs where it is used, and only where j <= i, so
// exp never sees the positive exponents above the diagonal (up to +400 at
// A = -16, dt = 0.1, where exp overflows and inf * 0 would give NaN); below
// the diagonal exp underflows to 0, which is right. A step at or past S is
// neither loaded nor stored: it enters as x = B = C = 0 and dt = 0, so it
// adds nothing and decays nothing. Nothing is padded.
//
// Shared memory (float32), rows padded by 4 floats so that the float4 reads
// of 16 threads walking 16 rows fall in distinct banks: x [Q][P], B and C
// [Q][N+4], the state [P][N+4], W [Q][Q+4]; 136 KB at N = 128 (one block an
// SM), 87 KB at N = 64. The products are 4 x 4 register tiles per thread
// (rows ty + 16 r, columns tx + 16 c) over float4 reads of shared memory.
//
// What bounds it: bytes, at the card's rates. At Mamba2-2.7B's R1 (B = 1,
// S = 2048, H = 80, P = 64, N = 128, bf16) one launch must read x, B, C, dt
// and write y and the state, ~46 MB, 0.014 ms at 3.35 TB/s; its ~13 GFLOP
// (the causal half of the two Q x Q products and the two state products at
// the reference's chunk) take 0.013 ms at the bf16 tensor-core rate. This
// first version is far from either: it computes every product in float32
// FMAs on the CUDA cores (~9.4 GFLOP at Q = 64, the full W square included),
// and one block per (batch, head) gives B H = 80 blocks for the card's 132
// SMs, 39% of them idle. Tensor-core (mma/wgmma) tiles and splitting P
// across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int Q = 64;          // steps per chunk
constexpr int THREADS = 256;   // a 16 x 16 thread layout
constexpr int TG = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
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

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// (P, N) other than (64, 64) or (64, 128), which the wrapper refuses first).
// Strides are in elements: x_sb / x_ss of x's batch and step, bc_sb / bc_ss
// of Bm's and Cm's (equal), dt_sb / dt_ss of dt's.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm,
                            const float* head_mask, float* y, float* state,
                            int B, int S, int H, int G, int P, int N,
                            int x_sb, int x_ss, int bc_sb, int bc_ss,
                            int dt_sb, int dt_ss, cudaStream_t stream) {
  return launch<float>(x, dt, A, Bm, Cm, head_mask, y, state, B, S, H, G, P,
                       N, x_sb, x_ss, bc_sb, bc_ss, dt_sb, dt_ss, stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* A, const __nv_bfloat16* Bm,
                             const __nv_bfloat16* Cm, const float* head_mask,
                             __nv_bfloat16* y, float* state, int B, int S,
                             int H, int G, int P, int N, int x_sb, int x_ss,
                             int bc_sb, int bc_ss, int dt_sb, int dt_ss,
                             cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, head_mask, y, state, B, S,
                               H, G, P, N, x_sb, x_ss, bc_sb, bc_ss, dt_sb,
                               dt_ss, stream);
}
