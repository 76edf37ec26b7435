// K3: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (entry flash_attention), and is what the model's prefill runs where the JAX
// package's models/attention.py::attend_blockwise takes its flash branch.  For
// each (batch, head, query) it computes, in one pass over the keys:
//
//     s_k   = (q * scale) . k_k              f32, scale = 1/sqrt(dh)
//     s_k   = NEG_INF (-1e30) where masked   causal: k_pos <= q_pos;
//                                            window: k_pos > q_pos - window
//     online softmax with f32 (m, l, acc) over key tiles
//     out   = acc / max(l, 1e-30)            cast to q's dtype
//
// GQA: query head h reads kv head h / (H / Hkv); the repeat is never formed.
// Inputs are float32 or bfloat16, converted to f32 as they are loaded; all
// arithmetic is f32, as the TPU kernel's.
//
// Bound on an H100 SXM: operations.  Causal prefill at B=4, H=24, S=2048,
// Dh=128 does about 1.03e11 FLOP (about 0.104 ms at the 989 TFLOP/s bf16
// tensor-core peak) against about 134 MB of Q, K, V and O (about 0.040 ms at
// 3.35 TB/s).
//
// Design (simple and right first; no tensor cores yet, so it runs at the f32
// CUDA-core rate, far from that bound):
//   * one block of 256 threads per (64-query tile, head, batch); the Q tile
//     (scaled, transposed) stays in shared memory while 64-key K and V tiles
//     stream through it, so every score and probability stays on chip and
//     device memory sees each input tile once per query tile;
//   * each thread owns a 4x4 block of scores and a 4-row x 8-column block of
//     the accumulator; float4 shared-memory loads feed 16 or 32 FMAs each;
//   * row max and row sum of a tile go across the 16 threads of a row with
//     warp shuffles;
//   * key tiles that the mask hides from every query of the tile are skipped
//     (causal: above the diagonal; window: too far behind), decided from the
//     min/max of the tile's positions, so any positions are exact;
//   * ragged tails (any Sq, Sk) are masked in the kernel: missing queries are
//     never stored, missing keys load as zero and get probability 0;
//   * a query row that sees no key at all (possible only with positions
//     where some query precedes, or lies a window past, every key) gets
//     what the plain version gives it: every score is NEG_INF, so every key
//     of the sequence weighs 1 and the output is the mean of V.  Tiles
//     skipped for the block may hold such keys, so a block with such a row
//     sums V over every tile once more for it;
//   * strides are arguments, so the (B, S, H, Dh) layout of the model and the
//     (B, H, S, Dh) layout of the TPU kernel both run without a copy.
//   * about 118 KB of dynamic shared memory per block (set with
//     cudaFuncSetAttribute above the 48 KB default), so one block per SM.
//
// Left for later: wgmma with bf16 operands, TMA loads and warp
// specialisation.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;   // devices one process may launch on
constexpr int kBQ = 64;             // queries per block
constexpr int kBK = 64;             // keys per tile
constexpr int kDMax = 128;          // largest head dim
constexpr int kThreads = 256;
constexpr int kQStride = kBQ + 4;   // qt[d][r]
constexpr int kKStride = kBK + 4;   // kt[d][c]
constexpr int kPStride = kBQ + 4;   // pt[c][r]
constexpr float kNegInf = -1e30f;

constexpr size_t kSmemBytes =
    sizeof(float) * (kDMax * kQStride + kDMax * kKStride + kBK * kDMax + kBK * kPStride) +
    sizeof(int) * (kBQ + kBK);

struct Strides {
  long long b, h, s;   // in elements; the head-dim stride is 1
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;
  const int* k_pos;
  Strides qs, ks, vs, os;
  int sq, sk, dh, group, causal, window;   // window <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// min and max of pos[lo, min(lo + 64, n)) in every lane of the warp
__device__ __forceinline__ void tile_range(const int* pos, int lo, int n, int& mn, int& mx) {
  const int lane = threadIdx.x & 31;
  mn = INT_MAX;
  mx = INT_MIN;
  for (int i = lane; i < 64; i += 32) {
    if (lo + i < n) {
      const int p = pos[lo + i];
      mn = min(mn, p);
      mx = max(mx, p);
    }
  }
  for (int off = 16; off; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
}

// reductions over the 16 threads that share a row (lane bits 0-3)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [kDMax][kQStride]  (q * scale)^T
  float* kt = qt + kDMax * kQStride;       // [kDMax][kKStride]  k^T
  float* vs = kt + kDMax * kKStride;       // [kBK][kDMax]       v
  float* pt = vs + kBK * kDMax;            // [kBK][kPStride]    p^T
  int* qpos = reinterpret_cast<int*>(pt + kBK * kPStride);   // [kBQ]
  int* kpos = qpos + kBQ;                                     // [kBK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx*4..+3; acc columns tx*4..+3 and 64+tx*4..+3
  const int ty = tid >> 4;   // rows ty*4..+3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const int dh = a.dh;

  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  T* o = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;

  for (int i = tid; i < kBQ * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const int row = q0 + r;
    qt[d * kQStride + r] = row < a.sq ? to_f32(q[row * a.qs.s + d]) * a.scale : 0.f;
  }
  if (tid < kBQ) qpos[tid] = q0 + tid < a.sq ? a.q_pos[q0 + tid] : 0;
  int qmin, qmax;
  tile_range(a.q_pos, q0, a.sq, qmin, qmax);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (a.sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    int kmin, kmax;
    tile_range(a.k_pos, k0, a.sk, kmin, kmax);
    // every warp reaches the same decision, so the whole block skips together
    if (a.causal && kmin > qmax) continue;
    if (a.window > 0 && static_cast<long long>(kmax) <= static_cast<long long>(qmin) - a.window)
      continue;

    __syncthreads();   // the previous tile is consumed (and the Q tile is written)
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int c = i / dh, d = i - c * dh;
      const int col = k0 + c;
      const bool in = col < a.sk;
      kt[d * kKStride + c] = in ? to_f32(k[col * a.ks.s + d]) : 0.f;
      vs[c * kDMax + d] = in ? to_f32(v[col * a.vs.s + d]) : 0.f;
    }
    if (tid < kBK) kpos[tid] = k0 + tid < a.sk ? a.k_pos[k0 + tid] : 0;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kQStride + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kt + d * kKStride + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qpos[ty * 4 + i];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int kp = kpos[c];
        bool ok = k0 + c < a.sk;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window > 0) ok = ok && kp > qp - a.window;
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a key past the end of the sequence never counts, even in a row
        // that has seen no visible key yet
        const float p = k0 + tx * 4 + j < a.sk ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kPStride + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int n_keys = min(kBK, a.sk - k0);
    for (int c = 0; c < n_keys; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * kPStride + ty * 4);
      const float4 v0 = *reinterpret_cast<const float4*>(vs + c * kDMax + tx * 4);
      const float4 v1 = *reinterpret_cast<const float4*>(vs + c * kDMax + 64 + tx * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // rows that saw no visible key: the mean of V over the whole sequence
  bool blind[4];
  int any_blind = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    blind[i] = m[i] == kNegInf && q0 + ty * 4 + i < a.sq;
    any_blind |= blind[i];
  }
  if (__syncthreads_or(any_blind)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!blind[i]) continue;
      l[i] = static_cast<float>(a.sk);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBK;
      __syncthreads();   // the previous tile of V is consumed
      for (int i = tid; i < kBK * dh; i += kThreads) {
        const int c = i / dh, d = i - c * dh;
        vs[c * kDMax + d] = k0 + c < a.sk ? to_f32(v[(k0 + c) * a.vs.s + d]) : 0.f;
      }
      __syncthreads();
      const int n_keys = min(kBK, a.sk - k0);
      for (int c = 0; c < n_keys; ++c) {
        const float4 v0 = *reinterpret_cast<const float4*>(vs + c * kDMax + tx * 4);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + c * kDMax + 64 + tx * 4);
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (blind[i])
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      if (d < dh) store(o + row * a.os.s + d, acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const Args& a, int batch, int n_heads, cudaStream_t stream) {
  // the attribute is set on the current device's copy of the kernel
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K3 on `stream`.  q: (B, H, Sq, Dh), k/v: (B, Hkv, Sk, Dh), o like q,
// each given by its pointer and (batch, head, sequence) strides in elements
// with a unit head-dim stride; q_pos (Sq,) and k_pos (Sk,) int32.  window <= 0
// means no window.  Returns cudaGetLastError() after the launch (0 on
// success); the caller validates devices, dtypes and shapes.
extern "C" int flash_attention_launch(int dtype_bf16, const void* q, const void* k,
                                      const void* v, void* o, const int* q_pos,
                                      const int* k_pos, long long q_sb, long long q_sh,
                                      long long q_ss, long long k_sb, long long k_sh,
                                      long long k_ss, long long v_sb, long long v_sh,
                                      long long v_ss, long long o_sb, long long o_sh,
                                      long long o_ss, int batch, int n_heads, int n_kv_heads,
                                      int sq, int sk, int dh, int causal, int window,
                                      float scale, void* stream) {
  if (dh < 1 || dh > kDMax || n_kv_heads < 1 || n_heads % n_kv_heads != 0 || batch < 1 ||
      sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k,  v,  o,  q_pos, k_pos, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
               {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}, sq, sk, dh, n_heads / n_kv_heads,
               causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype_bf16 ? launch<__nv_bfloat16>(a, batch, n_heads, st)
                    : launch<float>(a, batch, n_heads, st);
}
