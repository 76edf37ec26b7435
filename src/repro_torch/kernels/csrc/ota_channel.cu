// K2: the server-side over-the-air update kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ota_channel.py::_kernel
// (called through ota_channel_apply).  Over a tensor v of any shape,
// flattened, it computes for every element j
//
//     u_j = (v_j + sigma * n_j) * scale          scale = 1 / (N * m_h)
//
// in float32 and writes u in v's dtype (float32, or bfloat16 rounded to
// nearest even).  n_j is the counter-PRNG normal of ota_counter.cuh keyed on
// (seed, j) with j the absolute flat index: the TPU kernel's counter
// (i * block_rows + row) * 128 + lane is that index, so K2's stream is K1's
// (fused_server_pass over the same flat vector gives the same bits).
// sigma = 0 skips the noise, as the TPU kernel does.
//
// Bound on an H100 SXM: memory.  One read and one write of v's bytes per
// element against about 20 float32 operations (the mixer's integer work
// aside): at 2^26 float32 elements that is 512 MB, about 160 us at 3.35 TB/s,
// against about 20 us of float32 operations at 67 TFLOP/s.
//
// Design:
//   * a grid-stride loop over 16-byte packs (4 float32 or 8 bfloat16) when
//     both pointers are 16-byte aligned, so every warp load and store is a
//     full 512-byte transaction; the ragged tail (and an unaligned tensor)
//     goes element by element.  The result does not depend on the path.
//   * __fadd_rn / __fmul_rn in the order (v + sigma * n) * scale: nvcc never
//     contracts them into an FMA, so the result is bitwise the plain PyTorch
//     version's given the same noise.
//   * sigma, scale and the seed are kernel arguments (the wrapper rounds
//     scale from Python double to float32 once, as the TPU wrapper does).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ota_counter.cuh"

namespace {

// Storage of one element and its float32 view.
struct F32 {
  using Raw = uint32_t;
  static __device__ __forceinline__ float load(Raw r) { return __uint_as_float(r); }
  static __device__ __forceinline__ Raw store(float x) { return __float_as_uint(x); }
};

struct BF16 {
  using Raw = unsigned short;
  static __device__ __forceinline__ float load(Raw r) {
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  static __device__ __forceinline__ Raw store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <typename T, bool NOISE>
__device__ __forceinline__ typename T::Raw apply(typename T::Raw r, uint64_t j,
                                                 float sigma, float scale,
                                                 uint32_t seed) {
  float x = T::load(r);
  if (NOISE) {
    const float n = ota_counter::counter_normal(static_cast<uint32_t>(j), seed);
    x = __fadd_rn(x, __fmul_rn(sigma, n));
  }
  return T::store(__fmul_rn(x, scale));
}

template <typename T, bool NOISE, bool VEC>
__global__ void ota_channel_kernel(const typename T::Raw* __restrict__ v,
                                   typename T::Raw* __restrict__ out, uint64_t n,
                                   float sigma, float scale, uint32_t seed) {
  using Raw = typename T::Raw;
  constexpr int kPack = 16 / sizeof(Raw);
  const uint64_t tid = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  uint64_t done = 0;
  if (VEC) {
    union Pack {
      uint4 u;
      Raw e[kPack];
    };
    const uint64_t n_packs = n / kPack;
    const uint4* __restrict__ vin = reinterpret_cast<const uint4*>(v);
    uint4* __restrict__ vout = reinterpret_cast<uint4*>(out);
    for (uint64_t p = tid; p < n_packs; p += stride) {
      Pack in, res;
      in.u = vin[p];
#pragma unroll
      for (int k = 0; k < kPack; ++k) {
        res.e[k] = apply<T, NOISE>(in.e[k], p * kPack + k, sigma, scale, seed);
      }
      vout[p] = res.u;
    }
    done = n_packs * kPack;
  }
  for (uint64_t j = done + tid; j < n; j += stride) {
    out[j] = apply<T, NOISE>(v[j], j, sigma, scale, seed);
  }
}

template <typename T, bool NOISE>
void launch_noise(bool vec, const void* v, void* out, uint64_t n, float sigma,
                  float scale, uint32_t seed, int threads, cudaStream_t st) {
  using Raw = typename T::Raw;
  constexpr uint64_t kPack = 16 / sizeof(Raw);
  const uint64_t work = vec ? (n / kPack + n % kPack) : n;
  // enough blocks for a few waves of the 132 SMs; the loop strides the rest
  const uint64_t cap = 132ull * 16;
  uint64_t blocks = (work + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  if (blocks == 0) blocks = 1;
  const auto* vp = static_cast<const Raw*>(v);
  auto* op = static_cast<Raw*>(out);
  if (vec) {
    ota_channel_kernel<T, NOISE, true><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        vp, op, n, sigma, scale, seed);
  } else {
    ota_channel_kernel<T, NOISE, false><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        vp, op, n, sigma, scale, seed);
  }
}

template <typename T>
void launch_type(bool noise, bool vec, const void* v, void* out, uint64_t n,
                 float sigma, float scale, uint32_t seed, int threads,
                 cudaStream_t st) {
  if (noise) {
    launch_noise<T, true>(vec, v, out, n, sigma, scale, seed, threads, st);
  } else {
    launch_noise<T, false>(vec, v, out, n, sigma, scale, seed, threads, st);
  }
}

}  // namespace

// Launch K2 on `stream`: out = (v + sigma * n) * scale over n elements of
// float32 (bf16 = 0) or bfloat16 (bf16 = 1); with_noise = 0 skips the noise.
// Returns the cudaGetLastError() code after the launch (0 on success); the
// caller validates devices, dtypes, sizes (n < 2^32) and contiguity.
extern "C" int ota_channel_launch(int bf16, int with_noise, const void* v, void* out,
                                  unsigned long long n, float sigma, float scale,
                                  unsigned int seed, int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_type<BF16>(with_noise != 0, vec, v, out, n, sigma, scale, seed, threads, st);
  } else {
    launch_type<F32>(with_noise != 0, vec, v, out, n, sigma, scale, seed, threads, st);
  }
  return static_cast<int>(cudaGetLastError());
}
