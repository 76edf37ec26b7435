// K3 on Hopper's tensor cores: the flash-attention forward for bf16 inputs
// (sm_90a, wgmma + TMA + mbarriers, warp specialised).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (entry flash_attention) on the bf16 path; csrc/flash_attention.cu keeps
// float32 and the head dims this kernel does not take.  It computes what
// ref.flash_attention_plain computes, for each (batch, head, query):
//
//     s_k  = (q . k_k) * scale                bf16 products, f32 sums, then
//                                             the f32 scale 1/sqrt(dh)
//     s_k  masked                             causal: k_pos <= q_pos;
//                                             window: k_pos > q_pos - window
//     online softmax with f32 (m, l, acc) over 128-key tiles, in the log2
//     domain (exp2 on the special-function unit)
//     acc += p_hi . v + p_lo . v              p_hi = bf16(p), p_lo = bf16(p - p_hi)
//     out  = acc / max(l, 1e-30)              rounded to bf16 (RNE)
//
// GQA: query head h reads kv head h / (H / Hkv).  A query that sees no key
// gets the mean of V, as the plain version gives it.  ref.flash_attention_tc
// is the plain model of this arithmetic.
//
// Why P is split: the plain version multiplies the f32 probabilities with V
// in f32.  One bf16 P keeps 8 significant bits and can part from it by about
// 2^-9 max|V| in an output, more than one bf16 ulp of a small output.
// p_hi + p_lo keeps about 16 bits, so the P.V product costs two tensor-core
// passes (1.5x the counted FLOPs) and stays within one bf16 ulp.
//
// Bound on an H100 SXM: operations.  Causal prefill at B=4, H=24, S=2048,
// Dh=128 does about 1.03e11 FLOP (0.104 ms at the 989 TFLOP/s bf16 peak)
// against about 134 MB of Q, K, V and O (0.040 ms at 3.35 TB/s).
//
// Design:
//   * one block of 384 threads per (128-query tile, head, batch), the
//     query tiles with the most keys issued first (grid z counts down), so the
//     causal tail does not leave SMs idle at the end;
//   * warpgroup 0 is the producer: one thread issues TMA loads (128-byte
//     swizzle, 64 head-dim columns a box) of the Q tile once, then of K and V
//     tiles of 128 keys into a 2-stage ring guarded by full/empty mbarriers;
//     it gives its registers to the consumers (setmaxnreg);
//   * warpgroups 1 and 2 are the consumers, 64 query rows each:
//     S = Q.K^T by wgmma.m64n128k16 with both operands in shared memory
//     (K-major), mask and online softmax in registers, then O += P.V by
//     wgmma.m64n64k16 per 64-column box with P from registers (the S
//     accumulator's fragment is the A fragment: FlashAttention-3's layout
//     identity) and V from shared memory, MN-major (the transpose bit);
//   * key tiles that the mask hides from every query of the block are never
//     loaded (causal: above the diagonal; window: too far behind), decided by
//     every warp alike from the min/max of the tile's positions; tiles that
//     every query sees wholly skip the per-element mask in a branch of its
//     own, and the softmax scales, subtracts and exponentiates in the log2
//     domain (one multiply, one subtract and one ex2 a score): the
//     consumers' instruction count, not the tensor cores, sets the pace;
//   * ragged tails: TMA fills rows past Sq/Sk and columns past Dh with
//     zeros; keys past Sk get probability 0 and rows past Sq are not stored;
//   * rows that see no key: a warp vote, then one more pass over V in device
//     memory for those rows only;
//   * shared memory at Dh=128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB, so
//     one block per SM;
//   * the tensor maps are built per call from the pointers and strides, with
//     cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint (no
//     -lcuda link).  TMA needs 16-byte-aligned bases and strides; the
//     wrapper sends anything else to csrc/flash_attention.cu.
//
// Left for later: ping-pong scheduling of the two consumer warpgroups and
// overlapping the softmax of one tile with the next tile's S product.
#include <climits>
#include <cstdint>
#include <cuda.h>   // CUtensorMap and the driver's enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;   // devices one process may launch on
constexpr int kBM = 128;                    // queries per block
constexpr int kBN = 128;                    // keys per tile
constexpr int kBox = 64;                    // head-dim columns per TMA box (128 B)
constexpr int kBoxBytes = kBN * kBox * 2;   // 16 KB; a Q box is the same (kBM == kBN)
constexpr int kStages = 2;
constexpr int kThreads = 384;               // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumers = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>   // the head dim rounded up to 64 or 128
struct Smem {
  static constexpr int kBoxes = kD / kBox;
  static constexpr int kTile = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                    // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;     // + stage * kTile
  static constexpr int kBar = kV + kStages * kTile;   // 7 mbarriers
  static constexpr int kBytes = kBar + 64 + 1024;     // + slack to align to 1024
};

struct Args {
  void* o;
  const void* v;       // read again for rows that see no key
  const int* q_pos;
  const int* k_pos;
  long long o_sb, o_sh, o_ss, v_sb, v_sh, v_ss;
  int sq, sk, dh, group, causal, window, n_qtiles;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----- mbarriers and TMA ----------------------------------------------------

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
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// ----- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose 8-row
// groups lie 1024 bytes apart (TMA's SWIZZLE_128B layout of 128-byte rows).
// The same 1024 serves as the leading offset: K-major operands of depth 16
// never use it, and for V (MN-major, 64 columns) it is the stride between
// 8-key groups under either reading of the two fields.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads and writes across the
// asynchronous product: called on its operands after the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D(64x128, f32) += A(64x16, smem, K-major) . B(16x128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64, f32) += A(64x16, registers) . B(16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// 2^x by the special-function unit (about 2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ----- positions ------------------------------------------------------------

// min and max of pos[lo, min(lo + 128, n)) in every lane of the warp
__device__ __forceinline__ void tile_range(const int* pos, int lo, int n, int& mn, int& mx) {
  const int lane = threadIdx.x & 31;
  mn = INT_MAX;
  mx = INT_MIN;
#pragma unroll
  for (int i = lane; i < kBN; i += 32) {
    if (lo + i < n) {
      const int p = pos[lo + i];
      mn = min(mn, p);
      mx = max(mx, p);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
}

// 0: no query of the block sees a key of the tile (skipped, never loaded);
// 1: every query sees every key (no per-element mask); 2: mask per element.
// Every warp calls it with the same arguments and reaches the same answer.
__device__ __forceinline__ int tile_kind(const Args& a, int k0, int qmin, int qmax) {
  int kmin, kmax;
  tile_range(a.k_pos, k0, a.sk, kmin, kmax);
  if (a.causal && kmin > qmax) return 0;
  if (a.window > 0 && static_cast<long long>(kmax) <= static_cast<long long>(qmin) - a.window)
    return 0;
  bool all = k0 + kBN <= a.sk;
  if (a.causal && kmax > qmin) all = false;
  if (a.window > 0 && static_cast<long long>(kmin) <= static_cast<long long>(qmax) - a.window)
    all = false;
  return all ? 1 : 2;
}

// ----- the kernel -----------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Smem<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);   // swizzle atoms need 1024
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;    // + 8 * stage
  const uint32_t v_full = k_full + 16;   // + 8 * stage
  const uint32_t empty = v_full + 16;    // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (a.n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kBM;
  const int hk = h / a.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int qmin, qmax;
  tile_range(a.q_pos, q0, a.sq, qmin, qmax);
  const int n_tiles = (a.sk + kBN - 1) / kBN;

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every load ----
    regs_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(q_full, L::kTile);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(base + L::kQ + x * kBoxBytes, &tq, x * kBox, q0, h, b, q_full);
      }
      int it = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBN;
        if (tile_kind(a, k0, qmin, qmax) == 0) continue;
        const int s = it & 1;
        const int ph = (it >> 1) & 1;
        if (lane == 0) {
          mbar_wait(empty + 8 * s, ph ^ 1);   // passes at once on a fresh stage
          mbar_expect_tx(k_full + 8 * s, L::kTile);
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(base + L::kK + s * L::kTile + x * kBoxBytes, &tk, x * kBox, k0, hk, b,
                        k_full + 8 * s);
          mbar_expect_tx(v_full + 8 * s, L::kTile);
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(base + L::kV + s * L::kTile + x * kBoxBytes, &tv, x * kBox, k0, hk, b,
                        v_full + 8 * s);
        }
        __syncwarp();
        ++it;
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    regs_inc<232>();
    const int wg = (warp >> 2) - 1;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g;   // this thread's rows: row0, row0 + 8
    int qp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qp[i] = row0 + 8 * i < a.sq ? a.q_pos[row0 + 8 * i] : 0;

    float o[L::kBoxes][32];
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
      for (int r = 0; r < 32; ++r) o[x][r] = 0.f;
    const float minus_inf = __int_as_float(0xff800000u);
    const float scale_log2e = a.scale * kLog2e;
    float m[2] = {minus_inf, minus_inf};   // running row max of t = s * scale * log2(e)
    float l[2] = {0.f, 0.f};               // this thread's share of the row sums
    const uint32_t q_tile = base + L::kQ + wg * 64 * 128;

    mbar_wait(q_full, 0);
    int it = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBN;
      const int kind = tile_kind(a, k0, qmin, qmax);
      if (kind == 0) continue;
      const int s = it & 1;
      const int ph = (it >> 1) & 1;

      // S = Q . K^T: accumulator entry 4j + 2i + c is row row0 + 8i, key k0 + 8j + 2 t4 + c
      float sc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) sc[r] = 0.f;
      mbar_wait(k_full + 8 * s, ph);
      const uint32_t k_tile = base + L::kK + s * L::kTile;
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n128(sc, desc_sw128(q_tile + x * kBoxBytes + kk * 32),
                           desc_sw128(k_tile + x * kBoxBytes + kk * 32), 1);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // mask, only in tiles that need it: masked keys get -inf, keys past
      // the end of the sequence too
      if (kind == 2) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + 8 * j + 2 * t4 + c;
            const bool in = col < a.sk;
            const int kp = in ? a.k_pos[col] : 0;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              bool ok = in;
              if (a.causal) ok = ok && kp <= qp[i];
              if (a.window > 0)
                ok = ok && static_cast<long long>(kp) > static_cast<long long>(qp[i]) - a.window;
              if (!ok) sc[4 * j + 2 * i + c] = minus_inf;
            }
          }
        }
      }
      // online softmax in the log2 domain, t = s * scale * log2(e).  A row
      // that has seen no visible key keeps m = -inf and zero sums (the pass
      // over V below serves a row that never sees one); elsewhere p and
      // the correction are those of the plain version, whose NEG_INF scores
      // of such a row are wiped by its first visible key
      float mx[2] = {minus_inf, minus_inf};
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        sc[r] *= scale_log2e;
        mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
      }
      float corr[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = m[i] == minus_inf ? 0.f : ex2(m[i] - m_new);
        m_use[i] = m_new == minus_inf ? 0.f : m_new;
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const float p = ex2(sc[r] - m_use[(r >> 1) & 1]);   // -inf gives 0
        sc[r] = p;
        l[(r >> 1) & 1] += p;
      }
      // P as two bf16 A fragments; k-step kk covers keys 16 kk .. 16 kk + 15
      uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 = sc[8 * kk + 2 * r], p1 = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = bf16x2_bits(hi);
          p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }
      }
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
        for (int r = 0; r < 32; ++r) o[x][r] *= corr[(r >> 1) & 1];

      // O += P_hi . V + P_lo . V
      mbar_wait(v_full + 8 * s, ph);
      const uint32_t v_tile = base + L::kV + s * L::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          const uint64_t dv = desc_sw128(v_tile + x * kBoxBytes + kk * 2048);
          wgmma_rs_m64n64_tb(o[x], p_hi[kk], dv, 1);
          wgmma_rs_m64n64_tb(o[x], p_lo[kk], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x) reg_fence(o[x]);
      reg_fence(p_hi);
      reg_fence(p_lo);
      mbar_arrive(empty + 8 * s);
      ++it;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    // rows that saw no visible key: the mean of V over the whole sequence
    bool blind[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) blind[i] = m[i] == minus_inf && row0 + 8 * i < a.sq;
    const __nv_bfloat16* vg =
        static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
    if (__any_sync(0xffffffffu, blind[0] || blind[1])) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!blind[i]) continue;
        l[i] = static_cast<float>(a.sk);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
          for (int r = 0; r < 32; ++r)
            if (((r >> 1) & 1) == i) o[x][r] = 0.f;
      }
      for (int key = 0; key < a.sk; ++key) {
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = x * kBox + 8 * j + 2 * t4;
            if (col >= a.dh) continue;
            const float2 vv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(vg + key * a.v_ss + col));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (!blind[i]) continue;
              o[x][4 * j + 2 * i] += vv.x;
              o[x][4 * j + 2 * i + 1] += vv.y;
            }
          }
        }
      }
    }

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= a.sq) continue;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = x * kBox + 8 * j + 2 * t4;
          if (col >= a.dh) continue;
          *reinterpret_cast<__nv_bfloat162*>(og + row * a.o_ss + col) = __floats2bfloat162_rn(
              o[x][4 * j + 2 * i] / denom, o[x][4 * j + 2 * i + 1] / denom);
        }
      }
    }
  }
}

// ----- host side ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, heads, seq, dh) bf16 tensor given by strides in elements, as a 4-D
// tensor map {dh, seq, heads, B} with 64 x 128 boxes; out-of-range rows and
// columns load as zero.
bool make_map(CUtensorMap* map, const void* ptr, int dh, int seq, int heads, int batch,
              long long sb, long long sh, long long ss) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, kBN, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Args& a,
           int batch, int n_heads, cudaStream_t stream) {
  // the attribute is set on the current device's copy of the kernel
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_wgmma_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<kD>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid(n_heads, batch, a.n_qtiles);
  flash_fwd_wgmma_kernel<kD><<<grid, kThreads, Smem<kD>::kBytes, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launch the bf16 tensor-core K3 on `stream`.  q: (B, H, Sq, Dh), k/v: (B,
// Hkv, Sk, Dh), o like q, bf16, each given by its pointer and (batch, head,
// sequence) strides in elements with a unit head-dim stride; q_pos (Sq,) and
// k_pos (Sk,) int32.  Needs Dh a multiple of 16 up to 128, 16-byte-aligned
// pointers and strides that are positive multiples of 8 elements.  window <=
// 0 means no window.  Returns 0 on success, a cudaError_t otherwise (also
// when a tensor map cannot be built); the caller validates the rest.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            const int* q_pos, const int* k_pos, long long q_sb,
                                            long long q_sh, long long q_ss, long long k_sb,
                                            long long k_sh, long long k_ss, long long v_sb,
                                            long long v_sh, long long v_ss, long long o_sb,
                                            long long o_sh, long long o_ss, int batch,
                                            int n_heads, int n_kv_heads, int sq, int sk, int dh,
                                            int causal, int window, float scale, void* stream) {
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  bool ok = dh >= 16 && dh <= 128 && dh % 16 == 0 && n_kv_heads >= 1 &&
            n_heads % n_kv_heads == 0 && batch >= 1 && sq >= 1 && sk >= 1 && aligned(q) &&
            aligned(k) && aligned(v) && aligned(o);
  for (long long s : strides) ok = ok && s > 0 && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, dh, sq, n_heads, batch, q_sb, q_sh, q_ss) ||
      !make_map(&tk, k, dh, sk, n_kv_heads, batch, k_sb, k_sh, k_ss) ||
      !make_map(&tv, v, dh, sk, n_kv_heads, batch, v_sb, v_sh, v_ss))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{o,    v,    q_pos, k_pos, o_sb, o_sh, o_ss, v_sb, v_sh, v_ss, sq,
               sk,   dh,   n_heads / n_kv_heads, causal, window, (sq + kBM - 1) / kBM, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dh <= 64 ? launch<64>(tq, tk, tv, a, batch, n_heads, st)
                  : launch<128>(tq, tk, tv, a, batch, n_heads, st);
}
