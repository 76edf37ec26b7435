// K1: the fused over-the-air uplink kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ota_fused.py::_fused_kernel
// (with its helpers _mix and _counter_noise).  For every element j of the
// flattened parameter vector it computes, in one pass:
//
//     v_j = sum_a h[a] * G[a, j]          gain matvec, f32 accumulation
//     v_j = v_j + sigma * n_j             counter-PRNG AWGN (optional)
//     u_j = v_j * scale                   debias 1 / (N * m_h)
//
// with, when a device rescale factor r is given (the round service's
// participation correction N / W, ota.py::_participation_rescale), the scale
// taken as __fmul_rn(scale, r) in float32 first, as the JAX package forms it
// (a host float times a float32 device value), so a W that depends on the
// round's mask costs no host synchronisation.  r = 0 (nobody made the round)
// makes u an exact zero whatever the noise.  Without r no extra operation
// runs, so the bits are those of the plain scale.
//
// and writes u (mode agg), p - alpha * u (mode sgd), or the bias-corrected
// Adam update (p', mu', nu') (mode adam).  G arrives as float32 or on a
// bfloat16 wire; the master parameters and all arithmetic stay float32.
//
// Bound on an H100 SXM: memory.  The kernel does O(A) flops per element and
// must read A*P*wire_bytes of gradients plus one f32 P-vector per state, and
// write one f32 P-vector per output.  At A=8, P=2^21, sgd, f32 wire that is
// about 84 MB, or about 25 us at 3.35 TB/s.
//
// Design (simple and exact first):
//   * one thread per element j, grid ceil(P / threads); the ragged edge is
//     masked, so no padding is needed.
//   * the agent loop reads G[a, j]: neighbouring threads read neighbouring
//     addresses, so every load is coalesced.  The sum is a strict sequential
//     fold from 0 with __fmul_rn / __fadd_rn, which nvcc never contracts
//     into an FMA, so the result is bitwise equal to the plain PyTorch fold
//     in kernels/ref.py and invariant to the block size.
//   * the noise counter is the absolute index j (uint32), mixed by the same
//     murmur3 finalizer and salts as the TPU kernel, then Box-Muller with
//     logf / cosf (no --use_fast_math), so the uniform bits are bitwise the
//     TPU kernel's and the normals agree to a few ulp.  The generator lives
//     in ota_counter.cuh, shared with K2 (ota_channel.cu).
//   * runtime scalars are kernel arguments; the seed and the rescale factor
//     are read from device memory when a pointer is given, so a seed drawn
//     on the card, or a normaliser computed there, needs no host
//     synchronisation.
//
// Left for later: at a huge fleet and a small d (A=10^4, P=165) only one or
// two blocks are in flight and each thread runs the whole agent loop.
// Splitting the agent axis across blocks would change the summation order,
// so that redesign must restate the bitwise contract above.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ota_counter.cuh"

namespace {

using ota_counter::counter_bits;
using ota_counter::counter_normal;

constexpr int kModeAgg = 0;
constexpr int kModeSgd = 1;
constexpr int kModeAdam = 2;

struct Args {
  const void* g;          // (A, P) float or bfloat16, row-major
  const float* h;         // (A,)
  int n_agents;
  unsigned long long n_params;
  const float* p;         // (P,) sgd/adam
  const float* mu;        // (P,) adam
  const float* nu;        // (P,) adam
  float* out0;            // u | p' | p'
  float* out1;            // adam mu'
  float* out2;            // adam nu'
  float sigma, scale, alpha, b1, b2, c1, c2, eps;
  const long long* seed_ptr;  // device seed, or null to use seed_val
  uint32_t seed_val;
  const float* rescale_ptr;   // device factor on scale, or null for none
};

__device__ __forceinline__ uint32_t load_seed(const Args& a) {
  return a.seed_ptr ? static_cast<uint32_t>(*a.seed_ptr) : a.seed_val;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int MODE, bool NOISE>
__global__ void ota_fused_kernel(Args a) {
  const unsigned long long j =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= a.n_params) return;
  const T* __restrict__ g = static_cast<const T*>(a.g);

  float acc = 0.0f;
  for (int i = 0; i < a.n_agents; ++i) {
    const float gi = to_f32(g[static_cast<unsigned long long>(i) * a.n_params + j]);
    acc = __fadd_rn(acc, __fmul_rn(a.h[i], gi));
  }
  if (NOISE) {
    const float n = counter_normal(static_cast<uint32_t>(j), load_seed(a));
    acc = __fadd_rn(acc, __fmul_rn(a.sigma, n));
  }
  const float scale = a.rescale_ptr ? __fmul_rn(a.scale, *a.rescale_ptr) : a.scale;
  const float u = __fmul_rn(acc, scale);

  if (MODE == kModeAgg) {
    a.out0[j] = u;
  } else if (MODE == kModeSgd) {
    a.out0[j] = __fsub_rn(a.p[j], __fmul_rn(a.alpha, u));
  } else {
    const float m = __fadd_rn(__fmul_rn(a.b1, a.mu[j]),
                              __fmul_rn(__fsub_rn(1.0f, a.b1), u));
    const float v = __fadd_rn(__fmul_rn(a.b2, a.nu[j]),
                              __fmul_rn(__fsub_rn(1.0f, a.b2), __fmul_rn(u, u)));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.c2)), a.eps);
    const float step = -__fdiv_rn(__fmul_rn(a.alpha, __fdiv_rn(m, a.c1)), den);
    a.out0[j] = __fadd_rn(a.p[j], step);
    a.out1[j] = m;
    a.out2[j] = v;
  }
}

__global__ void counter_bits_kernel(unsigned long long n, Args a, int* out_b1,
                                    int* out_b2) {
  const unsigned long long j =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t b1, b2;
  counter_bits(static_cast<uint32_t>(j), load_seed(a), &b1, &b2);
  out_b1[j] = static_cast<int>(b1);
  out_b2[j] = static_cast<int>(b2);
}

template <typename T, int MODE>
void launch_mode(bool noise, dim3 grid, int threads, cudaStream_t st, const Args& a) {
  if (noise) {
    ota_fused_kernel<T, MODE, true><<<grid, threads, 0, st>>>(a);
  } else {
    ota_fused_kernel<T, MODE, false><<<grid, threads, 0, st>>>(a);
  }
}

template <typename T>
void launch_type(int mode, bool noise, dim3 grid, int threads, cudaStream_t st,
                 const Args& a) {
  if (mode == kModeAgg) {
    launch_mode<T, kModeAgg>(noise, grid, threads, st, a);
  } else if (mode == kModeSgd) {
    launch_mode<T, kModeSgd>(noise, grid, threads, st, a);
  } else {
    launch_mode<T, kModeAdam>(noise, grid, threads, st, a);
  }
}

dim3 grid_for(unsigned long long n, int threads) {
  return dim3(static_cast<unsigned int>((n + threads - 1) / threads));
}

}  // namespace

// Launch K1 on `stream`.  mode: 0 agg, 1 sgd, 2 adam.  rescale_ptr (one
// float32 on the device, or null) multiplies scale as above.  Returns the
// cudaGetLastError() code after the launch (0 on success); the caller
// validates shapes, dtypes and devices before calling.
extern "C" int ota_fused_launch(int mode, int wire_bf16, int with_noise,
                                const void* g, const float* h, int n_agents,
                                unsigned long long n_params, const float* p,
                                const float* mu, const float* nu, float* out0,
                                float* out1, float* out2, float sigma, float scale,
                                float alpha, float b1, float b2, float c1, float c2,
                                float eps, const long long* seed_ptr,
                                unsigned int seed_val, const float* rescale_ptr,
                                int threads, void* stream) {
  if (mode < kModeAgg || mode > kModeAdam) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{g,     h,     n_agents, n_params, p,  mu, nu,  out0,     out1,    out2,
               sigma, scale, alpha,    b1,       b2, c1, c2,  eps,      seed_ptr, seed_val,
               rescale_ptr};
  const dim3 grid = grid_for(n_params, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wire_bf16) {
    launch_type<__nv_bfloat16>(mode, with_noise != 0, grid, threads, st, a);
  } else {
    launch_type<float>(mode, with_noise != 0, grid, threads, st, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The counter PRNG's two 24-bit uniform streams for indices 0..n-1, so a
// check can hold them bitwise against the plain version.
extern "C" int ota_counter_bits_launch(unsigned long long n, const long long* seed_ptr,
                                       unsigned int seed_val, int* out_b1, int* out_b2,
                                       int threads, void* stream) {
  Args a{};
  a.seed_ptr = seed_ptr;
  a.seed_val = seed_val;
  counter_bits_kernel<<<grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, a, out_b1, out_b2);
  return static_cast<int>(cudaGetLastError());
}
