// K1: the fused over-the-air uplink kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ota_fused.py::_fused_kernel
// (with its helpers _mix and _counter_noise).  For every lane l and every
// element j of the flattened parameter vector it computes, in one pass:
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
// The contract both bodies keep: the sum is a strict sequential fold over
// agents from 0 with __fmul_rn / __fadd_rn, which nvcc never contracts into
// an FMA, so every output is bitwise the plain PyTorch fold in kernels/ref.py
// and the agent-streamed fold (core/ota.py::stream_fold_block) is bitwise
// invariant to how the agents are blocked.  The noise counter is the
// absolute index j (uint32), mixed by the same murmur3 finalizer and salts
// as the TPU kernel, then Box-Muller with logf / cosf (no --use_fast_math);
// the generator lives in ota_counter.cuh, shared with K2 (ota_channel.cu).
//
// Lanes (the TPU kernel's vmap axis, folded into its grid by the Pallas
// batching rule) are blockIdx.y in both bodies: lane l reads G at a lane
// stride that may be 0 (one stack shared by every lane), its gains likewise,
// its own sigma, scale, alpha, seed and rescale factor when the caller gives
// per-lane device arrays (else the one value passed by value), and writes
// row l of an (L, P) output.  Each lane runs exactly the code of a one-lane
// launch, so it is bitwise that launch.
//
// Bound on an H100 SXM: memory.  The kernel does O(A) flops per element and
// must read A*P*wire_bytes of gradients plus one f32 P-vector per state, and
// write one f32 P-vector per output.  The fold order puts a second floor
// under it: one dependent float add per agent and column, about 4 clocks
// each, so at least about A * 4 clocks whatever the bandwidth.
//
// Two bodies; the wrapper (kernels/ota_fused.py::k1_body) picks one from the
// shapes and the wire dtype alone:
//
//   * wide (the first design): one thread per element j, grid
//     ceil(P / threads) x L.  The agent loop reads G[a, j]: neighbouring
//     threads read neighbouring addresses, so every load is coalesced.  It
//     reaches 75 % (f32) and 55 % (bf16 wire) of the byte bound at (8,
//     2^21).  At a small P and a large fleet (10^4 x 165) it puts one block
//     on one SM whose threads each walk 10^4 rows with a device-memory load
//     per step: about 1 % of the bound.
//
//   * tall (large A, P <= kTallMaxParams): one block per lane covers the
//     whole parameter row.  One producer warp streams contiguous tiles of R
//     agent rows of G into a ring of shared-memory stages with the Hopper
//     bulk asynchronous copy (cp.async.bulk, the TMA's 1D form: no tensor
//     map) completing on one mbarrier per stage (expect_tx), and the tile's
//     gains h[r0 .. r0+R) with 4-byte cp.async copies that arrive on the
//     same mbarrier.  A second mbarrier per stage returns it to the producer
//     once every consumer warp has folded it.  The folding threads own one
//     column each (two when P > 992), load 16 rows (8 of bf16) of a column
//     and their gains from shared memory ahead of the add chain, and fold in
//     agent order exactly as the wide body does; the epilogue per column is
//     the same device function.  A tile starts on a 16-byte boundary because
//     R is a multiple of the rows that make 16 bytes (4 for f32 P = 165) and
//     of 4 (the float4 of gains); the last A mod R rows that make no whole
//     16-byte tile are read straight from device memory.  The wrapper's
//     rule gives a G whose pointer or lane stride is not 16-byte aligned
//     to the wide body, and a forced tall body refuses it.  The ring splits
//     the block's 227 KB into kTallStages tiles (3 of about 76 KB at P =
//     165): one SM's bulk copies do not overlap each other well, so few
//     large tiles load fastest; perf/k1_parts.py builds the body at other
//     depths by editing kTallStages.  On one SM the fold's instruction rate
//     (a shared load, a multiply, an add and an address step a row in each
//     warp), then the copy rate, set the pace, well above the add chain's
//     floor; spreading the columns over a thread-block cluster is the next
//     lever (PERF.md, perf/k1_parts.py).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ota_counter.cuh"

namespace {

constexpr int kMaxDevices = 64;   // devices one process may launch on

using ota_counter::counter_bits;
using ota_counter::counter_normal;

constexpr int kModeAgg = 0;
constexpr int kModeSgd = 1;
constexpr int kModeAdam = 2;

constexpr int kBodyWide = 0;
constexpr int kBodyTall = 1;

constexpr int kTallMaxParams = 1984;     // 992 folding threads x 2 columns
constexpr int kTallOneColumn = 992;      // up to here one column a thread
constexpr int kTallMaxRows = 1024;       // rows of a tile
constexpr int kTallStages = 3;           // ring depth
constexpr int kBarBytes = 256;           // a full and an empty barrier a stage
static_assert(kTallStages >= 2 && 2 * 8 * kTallStages <= kBarBytes, "ring depth");
constexpr int kSmemMax = 232448;         // 227 KB a block on Hopper

struct Args {
  const void* g;          // lane l, agent i, element j at g[l*g_lane + i*P + j]
  const float* h;         // h[l*h_lane + i]
  long long g_lane, h_lane, state_lane;   // lane strides in elements (0: shared)
  int n_agents;
  unsigned long long n_params;
  const float* p;         // (P,) or (L, P): sgd/adam
  const float* mu;        // adam
  const float* nu;        // adam
  float* out0;            // u | p' | p'        (L, P)
  float* out1;            // adam mu'
  float* out2;            // adam nu'
  float sigma, scale, alpha, b1, b2, c1, c2, eps;
  const float* sigma_ptr;     // per-lane sigma, or null to use sigma
  const float* scale_ptr;     // per-lane scale, or null to use scale
  const float* alpha_ptr;     // per-lane alpha, or null to use alpha
  const long long* seed_ptr;  // per-lane device seed, or null to use seed_val
  uint32_t seed_val;
  const float* rescale_ptr;   // per-lane device factor on scale, or null
};

// The tall body's ring, laid out by the host (tall_plan).
struct Tall {
  int rows;             // R: rows of a full tile
  int n_full;           // full tiles
  int last_rows;        // rows of a shorter last tile, or 0
  int n_tiles;
  int cols;             // folding threads (a multiple of 32)
  unsigned tile_bytes;  // R * P * wire bytes; the gains follow at this offset
  unsigned stage_bytes;
};

__device__ __forceinline__ uint32_t load_seed(const Args& a, int lane) {
  return a.seed_ptr ? static_cast<uint32_t>(a.seed_ptr[lane]) : a.seed_val;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Noise, scale and the mode's update for element j of lane `lane`, the noise
// drawn at counter `ctr`.
template <int MODE, bool NOISE>
__device__ __forceinline__ void finish_at(const Args& a, int lane, unsigned long long j,
                                          uint32_t ctr, float acc) {
  if (NOISE) {
    const float sigma = a.sigma_ptr ? a.sigma_ptr[lane] : a.sigma;
    const float n = counter_normal(ctr, load_seed(a, lane));
    acc = __fadd_rn(acc, __fmul_rn(sigma, n));
  }
  const float s0 = a.scale_ptr ? a.scale_ptr[lane] : a.scale;
  const float scale = a.rescale_ptr ? __fmul_rn(s0, a.rescale_ptr[lane]) : s0;
  const float u = __fmul_rn(acc, scale);
  const unsigned long long o = static_cast<unsigned long long>(lane) * a.n_params + j;
  const unsigned long long s = static_cast<unsigned long long>(lane) * a.state_lane + j;
  const float alpha = a.alpha_ptr ? a.alpha_ptr[lane] : a.alpha;

  if (MODE == kModeAgg) {
    a.out0[o] = u;
  } else if (MODE == kModeSgd) {
    a.out0[o] = __fsub_rn(a.p[s], __fmul_rn(alpha, u));
  } else {
    const float m = __fadd_rn(__fmul_rn(a.b1, a.mu[s]),
                              __fmul_rn(__fsub_rn(1.0f, a.b1), u));
    const float v = __fadd_rn(__fmul_rn(a.b2, a.nu[s]),
                              __fmul_rn(__fsub_rn(1.0f, a.b2), __fmul_rn(u, u)));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.c2)), a.eps);
    const float step = -__fdiv_rn(__fmul_rn(alpha, __fdiv_rn(m, a.c1)), den);
    a.out0[o] = __fadd_rn(a.p[s], step);
    a.out1[o] = m;
    a.out2[o] = v;
  }
}

// The unmapped epilogue: the noise counter is the element's own index.
template <int MODE, bool NOISE>
__device__ __forceinline__ void finish(const Args& a, int lane, unsigned long long j,
                                       float acc) {
  finish_at<MODE, NOISE>(a, lane, j, static_cast<uint32_t>(j), acc);
}

// ----- the wide body ----------------------------------------------------------

// LANES = false is the wide kernel as it was before lanes: with a lane
// offset in the addresses nvcc keeps fewer of the agent loop's loads in
// flight and the loop runs slower, so a one-lane launch takes this instance.
template <typename T, int MODE, bool NOISE, bool LANES>
__global__ void ota_fused_wide(Args a) {
  const int lane = LANES ? static_cast<int>(blockIdx.y) : 0;
  const unsigned long long j =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= a.n_params) return;
  const T* __restrict__ g = static_cast<const T*>(a.g) + (LANES ? lane * a.g_lane : 0);
  const float* h = a.h + (LANES ? lane * a.h_lane : 0);

  float acc = 0.0f;
  for (int i = 0; i < a.n_agents; ++i) {
    const float gi = to_f32(g[static_cast<unsigned long long>(i) * a.n_params + j]);
    acc = __fadd_rn(acc, __fmul_rn(h[i], gi));
  }
  finish<MODE, NOISE>(a, lane, j, acc);
}

// ----- the wide body under a counter map ------------------------------------------

// A counter map (kernels/ota_fused.py::CounterMap): one row of kMapCols int64
// a segment, [offset in the row, base counter, sizes (kMapDims, the last
// fastest), global strides (kMapDims)], the segments in row order.  Element
// j of the row lies in the last segment whose offset is <= j; its local
// index r = j - offset, taken row-major over the sizes as (i_0, .., i_3),
// draws the noise of counter base + sum_d i_d * stride_d, modulo 2^32, as the
// JAX package's uint32 counter wraps (the wrapper checks that a segment's
// sizes, strides and element count fit 32 bits, so 32-bit arithmetic gives
// the sum modulo 2^32 exactly).  The plain version is
// kernels/ref.py::counter_map_index.
constexpr int kMapDims = 4;
constexpr int kMapCols = 2 + 2 * kMapDims;

__device__ __forceinline__ uint32_t map_counter(const long long* __restrict__ m, int n_seg,
                                                unsigned long long j) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (static_cast<unsigned long long>(__ldg(m + mid * kMapCols)) <= j) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* seg = m + lo * kMapCols;
  uint32_t r = static_cast<uint32_t>(j - static_cast<unsigned long long>(__ldg(seg)));
  uint32_t c = static_cast<uint32_t>(__ldg(seg + 1));
#pragma unroll
  for (int d = kMapDims - 1; d >= 0; --d) {
    const uint32_t size = static_cast<uint32_t>(__ldg(seg + 2 + d));
    const uint32_t stride = static_cast<uint32_t>(__ldg(seg + 2 + kMapDims + d));
    c += (r % size) * stride;
    r /= size;
  }
  return c;
}

// Agg mode, one lane: the wide body's fold and epilogue, the noise at the
// mapped counter (a sharded gradient's row of shards).
template <typename T, bool NOISE>
__global__ void ota_fused_wide_mapped(Args a, const long long* __restrict__ map, int n_seg) {
  const unsigned long long j =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= a.n_params) return;
  const T* __restrict__ g = static_cast<const T*>(a.g);
  float acc = 0.0f;
  for (int i = 0; i < a.n_agents; ++i) {
    const float gi = to_f32(g[static_cast<unsigned long long>(i) * a.n_params + j]);
    acc = __fadd_rn(acc, __fmul_rn(a.h[i], gi));
  }
  finish_at<kModeAgg, NOISE>(a, 0, j, NOISE ? map_counter(map, n_seg, j) : 0u, acc);
}

// ----- mbarriers and asynchronous copies (the tall body) ------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the phase of the given parity has completed.  A wait of more
// than about ten seconds of clocks is a broken pipeline: it traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - start > 20000000000ll) __trap();
}
// One contiguous tile, global -> shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (.noinc: the arrival is one of those the barrier was initialised with).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ----- the tall body -----------------------------------------------------------

// Fold `rows` (a multiple of 4) rows of a tile into the NC columns this
// thread owns, in agent order; gains from the tile's float4 slots.  Columns
// past P (the idle lanes of the last warp) read column P - 1 and are never
// written, so every read stays inside the tile.  A step loads kStep rows of
// a column and their gains into registers before its part of the add
// chain, so the shared-memory loads are in flight together whatever order
// nvcc picks: with steps of four rows, equivalent builds of this source
// scheduled the loads differently and differed by up to 8 % in time
// (PERF.md).  16 rows (f32) and 8 (bf16) timed fastest on the H100 at P =
// 165; the last rows of a tile take steps of four.
template <typename T, int NC>
__device__ __forceinline__ void fold_tile(float (&acc)[NC], const int (&col)[NC],
                                          const T* __restrict__ gs,
                                          const float4* __restrict__ hs, int rows, int n) {
  constexpr int kStep = sizeof(T) == 4 ? 16 : 8;
  int r = 0;
  for (; r + kStep <= rows; r += kStep) {
    float4 hv[kStep / 4];
#pragma unroll
    for (int q = 0; q < kStep / 4; ++q) hv[q] = hs[(r >> 2) + q];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T* x = gs + r * n + col[c];
      float v[kStep];
#pragma unroll
      for (int k = 0; k < kStep; ++k) v[k] = to_f32(x[k * n]);
#pragma unroll
      for (int q = 0; q < kStep / 4; ++q) {
        acc[c] = __fadd_rn(acc[c], __fmul_rn(hv[q].x, v[4 * q]));
        acc[c] = __fadd_rn(acc[c], __fmul_rn(hv[q].y, v[4 * q + 1]));
        acc[c] = __fadd_rn(acc[c], __fmul_rn(hv[q].z, v[4 * q + 2]));
        acc[c] = __fadd_rn(acc[c], __fmul_rn(hv[q].w, v[4 * q + 3]));
      }
    }
  }
  for (; r < rows; r += 4) {
    const float4 hv = hs[r >> 2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T* x = gs + r * n + col[c];
      const float x0 = to_f32(x[0]);
      const float x1 = to_f32(x[n]);
      const float x2 = to_f32(x[2 * n]);
      const float x3 = to_f32(x[3 * n]);
      acc[c] = __fadd_rn(acc[c], __fmul_rn(hv.x, x0));
      acc[c] = __fadd_rn(acc[c], __fmul_rn(hv.y, x1));
      acc[c] = __fadd_rn(acc[c], __fmul_rn(hv.z, x2));
      acc[c] = __fadd_rn(acc[c], __fmul_rn(hv.w, x3));
    }
  }
}

template <typename T, int MODE, bool NOISE, int NC>
__global__ void __launch_bounds__(1024) ota_fused_tall(Args a, Tall t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const uint32_t full0 = smem_u32(smem);
  const uint32_t empty0 = full0 + kBarBytes / 2;
  unsigned char* ring = smem + kBarBytes;

  if (tid == 0) {
    for (int s = 0; s < kTallStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);     // expect_tx + the producer lanes' gains
      mbar_init(empty0 + 8 * s, t.cols / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const T* g = static_cast<const T*>(a.g) + lane * a.g_lane;
  const float* h = a.h + lane * a.h_lane;
  const int n = static_cast<int>(a.n_params);

  if (tid >= t.cols) {
    // producer warp: lane 0 starts the tile's copy, all 32 lanes the gains'
    const int pl = tid - t.cols;
    for (int k = 0; k < t.n_tiles; ++k) {
      const int s = k % kTallStages;
      const int use = k / kTallStages;
      if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
      unsigned char* stage = ring + static_cast<size_t>(s) * t.stage_bytes;
      const int rows = k < t.n_full ? t.rows : t.last_rows;
      const long long row0 = static_cast<long long>(k) * t.rows;
      const uint32_t hs = smem_u32(stage + t.tile_bytes);
      for (int r = pl; r < rows; r += 32) cp_async4(hs + 4 * r, h + row0 + r);
      cp_async_arrive(full0 + 8 * s);
      if (pl == 0) {
        const uint32_t bytes = static_cast<uint32_t>(rows) * n * sizeof(T);
        mbar_expect_tx(full0 + 8 * s, bytes);
        bulk_load(smem_u32(stage), g + row0 * n, bytes, full0 + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // folding threads: columns tid and tid + cols
  float acc[NC];
  int col[NC];
  bool on[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = tid + c * t.cols;
    on[c] = j < n;
    col[c] = on[c] ? j : n - 1;
    acc[c] = 0.0f;
  }
  for (int k = 0; k < t.n_tiles; ++k) {
    const int s = k % kTallStages;
    mbar_wait(full0 + 8 * s, (k / kTallStages) & 1);
    const unsigned char* stage = ring + static_cast<size_t>(s) * t.stage_bytes;
    const int rows = k < t.n_full ? t.rows : t.last_rows;
    fold_tile<T, NC>(acc, col, reinterpret_cast<const T*>(stage),
                     reinterpret_cast<const float4*>(stage + t.tile_bytes), rows, n);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * s);
  }
  // the rows that make no whole 16-byte tile, straight from device memory
  const int done = t.n_full * t.rows + t.last_rows;
  for (int i = done; i < a.n_agents; ++i) {
    const float hi = h[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(hi, to_f32(g[static_cast<long long>(i) * n + col[c]])));
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (on[c]) finish<MODE, NOISE>(a, lane, col[c], acc[c]);
}

// The tall body's ring for an (A, P) stack of `elem`-byte values:
// kTallStages stages that share the block's shared memory, each a tile of as
// many rows as fit (a multiple of the 16-byte row quantum and of 4, at most
// kTallMaxRows) and the tile's gains.  False when the body cannot take P.
bool tall_plan(int n_agents, unsigned long long n_params, int elem, Tall* t) {
  if (n_params < 1 || n_params > static_cast<unsigned long long>(kTallMaxParams)) return false;
  const unsigned row_bytes = static_cast<unsigned>(n_params) * elem;
  unsigned gcd = row_bytes, m = 16;
  while (m) {
    const unsigned r = gcd % m;
    gcd = m;
    m = r;
  }
  const int quantum = static_cast<int>(16 / gcd) > 4 ? static_cast<int>(16 / gcd) : 4;
  // a stage: rows * (row_bytes + 4) bytes, rounded up to 128
  const unsigned per_stage = (kSmemMax - kBarBytes) / kTallStages / 128u * 128u;
  int rows = static_cast<int>(per_stage / (row_bytes + 4u)) / quantum * quantum;
  if (rows > kTallMaxRows) rows = kTallMaxRows;
  if (rows < quantum) return false;
  const int fleet = n_agents / quantum * quantum;     // a small fleet: one tile
  if (fleet < rows) rows = fleet > quantum ? fleet : quantum;
  t->rows = rows;
  t->n_full = n_agents / rows;
  t->last_rows = (n_agents - t->n_full * rows) / quantum * quantum;
  t->n_tiles = t->n_full + (t->last_rows > 0 ? 1 : 0);
  t->tile_bytes = static_cast<unsigned>(rows) * row_bytes;
  t->stage_bytes = (t->tile_bytes + 4u * rows + 127u) / 128u * 128u;
  const int per = n_params > static_cast<unsigned long long>(kTallOneColumn)
                      ? static_cast<int>((n_params + 1) / 2)
                      : static_cast<int>(n_params);
  t->cols = (per + 31) / 32 * 32;
  return true;
}

template <typename T, int MODE, bool NOISE, int NC>
int launch_tall(const Tall& t, int n_lanes, cudaStream_t st, const Args& a) {
  // the attribute is set on the current device's copy of the kernel
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ota_fused_tall<T, MODE, NOISE, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const size_t smem = kBarBytes + static_cast<size_t>(kTallStages) * t.stage_bytes;
  ota_fused_tall<T, MODE, NOISE, NC><<<dim3(1, n_lanes), t.cols + 32, smem, st>>>(a, t);
  return 0;
}

template <typename T, int MODE, bool NOISE>
int launch_body(int body, const Tall& t, int n_lanes, int threads, cudaStream_t st,
                const Args& a) {
  if (body == kBodyTall) {
    return a.n_params > static_cast<unsigned long long>(kTallOneColumn)
               ? launch_tall<T, MODE, NOISE, 2>(t, n_lanes, st, a)
               : launch_tall<T, MODE, NOISE, 1>(t, n_lanes, st, a);
  }
  const dim3 grid(static_cast<unsigned int>((a.n_params + threads - 1) / threads), n_lanes);
  if (n_lanes > 1) {
    ota_fused_wide<T, MODE, NOISE, true><<<grid, threads, 0, st>>>(a);
  } else {
    ota_fused_wide<T, MODE, NOISE, false><<<grid, threads, 0, st>>>(a);
  }
  return 0;
}

template <typename T, int MODE>
int launch_mode(int body, bool noise, const Tall& t, int n_lanes, int threads, cudaStream_t st,
                const Args& a) {
  return noise ? launch_body<T, MODE, true>(body, t, n_lanes, threads, st, a)
               : launch_body<T, MODE, false>(body, t, n_lanes, threads, st, a);
}

template <typename T>
int launch_type(int body, int mode, bool noise, const Tall& t, int n_lanes, int threads,
                cudaStream_t st, const Args& a) {
  if (mode == kModeAgg) return launch_mode<T, kModeAgg>(body, noise, t, n_lanes, threads, st, a);
  if (mode == kModeSgd) return launch_mode<T, kModeSgd>(body, noise, t, n_lanes, threads, st, a);
  return launch_mode<T, kModeAdam>(body, noise, t, n_lanes, threads, st, a);
}

__global__ void counter_bits_kernel(unsigned long long n, Args a, int* out_b1,
                                    int* out_b2) {
  const unsigned long long j =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t b1, b2;
  counter_bits(static_cast<uint32_t>(j), load_seed(a, 0), &b1, &b2);
  out_b1[j] = static_cast<int>(b1);
  out_b2[j] = static_cast<int>(b2);
}

dim3 grid_for(unsigned long long n, int threads) {
  return dim3(static_cast<unsigned int>((n + threads - 1) / threads));
}

}  // namespace

// Launch K1 on `stream`.  body: 0 wide, 1 tall; mode: 0 agg, 1 sgd, 2 adam.
// n_lanes lanes (grid y) of an (A, P) stack each, at the given lane strides
// (elements; 0 shares one operand between lanes); outputs (L, P).  The
// per-lane pointers (sigma, scale, alpha, seed, rescale), each of n_lanes
// values or null, replace the by-value scalars.  threads is the wide body's
// block size.  Returns the cudaGetLastError() code after the launch (0 on success), or
// cudaErrorInvalidValue for what the chosen body cannot take; the caller
// validates shapes, dtypes and devices before calling.
extern "C" int ota_fused_launch(int body, int mode, int wire_bf16, int with_noise,
                                const void* g, const float* h, int n_lanes, int n_agents,
                                unsigned long long n_params, long long g_lane,
                                long long h_lane, long long state_lane, const float* p,
                                const float* mu, const float* nu, float* out0, float* out1,
                                float* out2, float sigma, float scale, float alpha, float b1,
                                float b2, float c1, float c2, float eps,
                                const float* sigma_ptr, const float* scale_ptr,
                                const float* alpha_ptr, const long long* seed_ptr,
                                unsigned int seed_val, const float* rescale_ptr, int threads,
                                void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (mode < kModeAgg || mode > kModeAdam || n_lanes < 1 || n_lanes > 65535 || n_agents < 1)
    return invalid;
  const Args a{g,         h,          g_lane,     h_lane,    state_lane, n_agents,
               n_params,  p,          mu,         nu,        out0,       out1,
               out2,      sigma,      scale,      alpha,     b1,         b2,
               c1,        c2,         eps,        sigma_ptr, scale_ptr,  alpha_ptr,
               seed_ptr,  seed_val,   rescale_ptr};
  const int elem = wire_bf16 ? 2 : 4;
  Tall t{};
  if (body == kBodyTall) {
    if (!tall_plan(n_agents, n_params, elem, &t)) return invalid;
    if ((reinterpret_cast<uintptr_t>(g) & 15) || ((g_lane * elem) & 15)) return invalid;
  } else if (body != kBodyWide) {
    return invalid;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = wire_bf16
                     ? launch_type<__nv_bfloat16>(body, mode, with_noise != 0, t, n_lanes,
                                                  threads, st, a)
                     : launch_type<float>(body, mode, with_noise != 0, t, n_lanes, threads, st,
                                          a);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K1's agg mode on the wide body, one lane, with the noise of element j drawn
// at the counter `map` gives it (n_seg segments; see map_counter).  The other
// arguments are ota_fused_launch's.  Returns the cudaGetLastError() code after
// the launch, or cudaErrorInvalidValue for an empty map or stack.
extern "C" int ota_fused_mapped_launch(int wire_bf16, int with_noise, const void* g,
                                       const float* h, int n_agents,
                                       unsigned long long n_params, float* out, float sigma,
                                       float scale, const long long* seed_ptr,
                                       unsigned int seed_val, const float* rescale_ptr,
                                       const long long* map, int n_seg, int threads,
                                       void* stream) {
  if (n_agents < 1 || n_params < 1 || n_seg < 1 || map == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.g = g;
  a.h = h;
  a.n_agents = n_agents;
  a.n_params = n_params;
  a.out0 = out;
  a.sigma = sigma;
  a.scale = scale;
  a.seed_ptr = seed_ptr;
  a.seed_val = seed_val;
  a.rescale_ptr = rescale_ptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(n_params, threads);
  if (wire_bf16) {
    if (with_noise) {
      ota_fused_wide_mapped<__nv_bfloat16, true><<<grid, threads, 0, st>>>(a, map, n_seg);
    } else {
      ota_fused_wide_mapped<__nv_bfloat16, false><<<grid, threads, 0, st>>>(a, map, n_seg);
    }
  } else if (with_noise) {
    ota_fused_wide_mapped<float, true><<<grid, threads, 0, st>>>(a, map, n_seg);
  } else {
    ota_fused_wide_mapped<float, false><<<grid, threads, 0, st>>>(a, map, n_seg);
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
