// K4: the Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_kernel
// (entry ssd_scan), and computes what the JAX package's model runs as
// src/repro/models/ssm.py::ssd_ref.  For one (batch, head), over chunks of Q
// steps, with dax = x * dt, da = dt * A, cum the inclusive prefix sum of da in
// the chunk and last = cum[Q-1]:
//
//     y[q]  = sum_{k<=q} (C_q . B_k) exp(cum[q] - cum[k]) dax[k]
//           + exp(cum[q]) (C_q . S)
//     S    <- exp(last) S + sum_k B_k^T exp(last - cum[k]) dax[k]
//
// carrying the N x P state S from chunk to chunk.  B and C are shared by the
// heads of a group: head h reads group h / (H / G).  All math is f32; x, B and
// C arrive as float32 or bfloat16, y leaves as float32 (what the model's
// ssd_ref returns; the TPU kernel writes x's dtype).  A length
// that is not a multiple of Q is handled as ssd_ref's right zero-padding: the
// missing steps load dt = x = B = C = 0, which are exact no-ops, and are never
// stored.
//
// Bound on an H100 SXM: bytes.  At mamba2-130m's prefill (B=4, S=2048, H=24,
// P=64, G=1, N=128, Q=128) the scan needs about 8.2e9 FLOP (about 0.008 ms at
// the 989 TFLOP/s bf16 tensor-core peak) against about 80 MB of x, dt, B, C
// in and f32 y out (about 0.024 ms at 3.35 TB/s).
//
// Design (simple and right first; f32 CUDA-core arithmetic, no tensor cores):
//   * one block of 256 threads per (head, batch); the chunk loop runs inside
//     the block, in order, and replaces the TPU's sequential grid axis, so
//     nothing carries between blocks;
//   * the state S (128x64), the chunk's B^T and C (128x128 each), dax
//     (128x64) and the prefix sums stay in shared memory: about 215 KB, set
//     with cudaFuncSetAttribute.  All f32 tiles at once would need 256 KB
//     with the QxQ score tile, above the 227 KB a block may have, so the
//     scores are formed 32 query rows at a time (16 KB);
//   * exp(cum[q] - cum[k]) is formed only for k <= q: above the diagonal the
//     segment sum is >= 0 and could overflow, so it is never computed;
//   * dax = x * dt and da = dt * A are formed as the chunk is loaded, from
//     the model's (B, S, H, P) layout, so no transposed copy is made;
//   * the prefix sum is one warp's shuffle scan.
//
// Left for later: tensor-core products (C.B^T per group is exact in bf16),
// more than one block per (batch, head) to fill 132 SMs at small B*H, and
// overlapping the next chunk's loads with this chunk's math.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;   // devices one process may launch on
constexpr int kQMax = 128;          // largest chunk
constexpr int kNMax = 128;          // largest state size
constexpr int kPMax = 64;           // largest head dim
constexpr int kRB = 32;             // score rows formed at once
constexpr int kThreads = 256;
constexpr int kBStride = kQMax + 1; // bt[n][k]
constexpr int kCStride = kNMax + 1; // cs[q][n]
constexpr int kGStride = kQMax + 1; // gs[row][k]

constexpr size_t kSmemBytes =
    sizeof(float) * (kNMax * kPMax + kNMax * kBStride + kQMax * kCStride + kQMax * kPMax +
                     kRB * kGStride + 3 * kQMax);

struct Args {
  const void* x;     // (B, S, H, P)
  const float* dt;   // (B, S, H)
  const float* A;    // (H,)
  const void* B;     // (B, S, G, N)
  const void* C;     // (B, S, G, N)
  float* y;          // (B, S, H, P)
  int seqlen, n_heads, headdim, n_groups, state, chunk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                     // [kNMax][kPMax]   carried state S[n][p]
  float* bt = st + kNMax * kPMax;       // [kNMax][kBStride] B^T of the chunk
  float* cs = bt + kNMax * kBStride;    // [kQMax][kCStride] C of the chunk
  float* xs = cs + kQMax * kCStride;    // [kQMax][kPMax]   dax of the chunk
  float* gs = xs + kQMax * kPMax;       // [kRB][kGStride]  masked scores, one row block
  float* cum = gs + kRB * kGStride;     // [kQMax] prefix sums of da
  float* dts = cum + kQMax;             // [kQMax] dt of the chunk's steps
  float* wend = dts + kQMax;            // [kQMax] exp(last - cum)

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int P = a.headdim, N = a.state, Q = a.chunk, S = a.seqlen;
  const int grp = h / (a.n_heads / a.n_groups);
  const float A = a.A[h];
  const long long x_step = static_cast<long long>(a.n_heads) * P;
  const long long bc_step = static_cast<long long>(a.n_groups) * N;

  const long long bs = static_cast<long long>(b) * S;   // first step of this sequence
  const T* x = static_cast<const T*>(a.x) + bs * x_step + static_cast<long long>(h) * P;
  float* y = a.y + bs * x_step + static_cast<long long>(h) * P;
  const float* dt = a.dt + bs * a.n_heads + h;
  const T* Bg = static_cast<const T*>(a.B) + bs * bc_step + static_cast<long long>(grp) * N;
  const T* Cg = static_cast<const T*>(a.C) + bs * bc_step + static_cast<long long>(grp) * N;

  for (int i = tid; i < kNMax * kPMax; i += kThreads) st[i] = 0.f;

  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();   // the previous chunk is consumed (and S is zeroed)
    if (tid < Q) dts[tid] = t0 + tid < S ? dt[static_cast<long long>(t0 + tid) * a.n_heads] : 0.f;
    for (int i = tid; i < Q * N; i += kThreads) {
      const int q = i / N, n = i - q * N;
      const long long t = t0 + q;
      const bool in = t < S;
      bt[n * kBStride + q] = in ? to_f32(Bg[t * bc_step + n]) : 0.f;
      cs[q * kCStride + n] = in ? to_f32(Cg[t * bc_step + n]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < Q * P; i += kThreads) {
      const int q = i / P, p = i - q * P;
      const long long t = t0 + q;
      xs[q * kPMax + p] = t < S ? to_f32(x[t * x_step + p]) * dts[q] : 0.f;
    }
    if (tid < 32) {   // inclusive prefix sum of da: 4 steps a lane, then a shuffle scan
      float part[4];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tid * 4 + j;
        run += q < Q ? dts[q] * A : 0.f;
        part[j] = run;
      }
      float tot = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += o;
      }
      const float before = tot - run;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tid * 4 + j;
        if (q < Q) cum[q] = before + part[j];
      }
    }
    __syncthreads();
    const float last = cum[Q - 1];
    if (tid < Q) wend[tid] = expf(last - cum[tid]);

    // y, 32 query rows at a time: thread rows r0 + ty*2 + {0,1}
    for (int r0 = 0; r0 < Q; r0 += kRB) {
      const int kend = min(Q, r0 + kRB);        // later keys are masked for every row here
      const int jn = (kend + 15) / 16;          // score columns tx + 16j, j < jn
      const int q0 = r0 + ty * 2, q1 = q0 + 1;  // < kQMax always
      float sc[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float c0 = cs[q0 * kCStride + n], c1 = cs[q1 * kCStride + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < jn) {
            const float bv = bt[n * kBStride + tx + 16 * j];
            sc[0][j] = fmaf(c0, bv, sc[0][j]);
            sc[1][j] = fmaf(c1, bv, sc[1][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = tx + 16 * j;
          if (k < kend) {
            gs[(ty * 2 + i) * kGStride + k] =
                (k <= q && q < Q) ? sc[i][j] * expf(cum[q] - cum[k]) : 0.f;
          }
        }
      }
      __syncthreads();

      float yv[2][4], yi[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yv[i][j] = yi[i][j] = 0.f;
      for (int k = 0; k < kend; ++k) {
        const float g0 = gs[(ty * 2) * kGStride + k], g1 = gs[(ty * 2 + 1) * kGStride + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = xs[k * kPMax + tx + 16 * j];
          yv[0][j] = fmaf(g0, xv, yv[0][j]);
          yv[1][j] = fmaf(g1, xv, yv[1][j]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float c0 = cs[q0 * kCStride + n], c1 = cs[q1 * kCStride + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sv = st[n * kPMax + tx + 16 * j];
          yi[0][j] = fmaf(c0, sv, yi[0][j]);
          yi[1][j] = fmaf(c1, sv, yi[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + i;
        const long long t = t0 + q;
        if (q >= Q || t >= S) continue;
        const float eq = expf(cum[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) y[t * x_step + p] = yv[i][j] + eq * yi[i][j];
        }
      }
      __syncthreads();   // gs is rewritten by the next row block; S is read above
    }

    // S <- exp(last) S + sum_k (B_k exp(last - cum[k]))^T dax[k]:
    // thread entries n = ty + 16i (i < 8), p = tx + 16j (j < 4)
    const float el = expf(last);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < Q; ++k) {
      const float w = wend[k];
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[k * kPMax + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float bw = bt[(ty + 16 * i) * kBStride + k] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bw, xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty + 16 * i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < P) st[n * kPMax + p] = el * st[n * kPMax + p] + acc[i][j];
      }
    }
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  // the attribute is set on the current device's copy of the kernel
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  ssd_scan_kernel<T><<<dim3(a.n_heads, batch), kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K4 on `stream`.  x (B, S, H, P), B/C (B, S, G, N) contiguous, float32
// (in_bf16 = 0) or bfloat16 (1); dt (B, S, H) and A (H,) float32 contiguous;
// y (B, S, H, P) float32 contiguous.  Returns cudaGetLastError() after the
// launch (0 on success); the caller validates devices, dtypes and shapes.
extern "C" int ssd_scan_launch(int in_bf16, const void* x, const float* dt, const float* A,
                               const void* B, const void* C, float* y,
                               int batch, int seqlen, int n_heads, int headdim, int n_groups,
                               int state, int chunk, void* stream) {
  if (batch < 1 || seqlen < 1 || headdim < 1 || headdim > kPMax || state < 1 ||
      state > kNMax || chunk < 1 || chunk > kQMax || n_groups < 1 || n_heads < 1 ||
      n_heads % n_groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, dt, A, B, C, y, seqlen, n_heads, headdim, n_groups, state, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch<__nv_bfloat16>(a, batch, st) : launch<float>(a, batch, st);
}
