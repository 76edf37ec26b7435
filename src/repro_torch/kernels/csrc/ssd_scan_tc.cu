// K4 on Hopper's tensor cores: the Mamba2 SSD chunked scan for bf16 inputs
// (sm_90a; mma.sync bf16 with f32 accumulation, cp.async prefetch).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_kernel
// (entry ssd_scan) on the bf16 path; csrc/ssd_scan.cu keeps float32 inputs
// and the shapes this kernel does not take.  It computes what ref.ssd_ref
// computes.  For one (batch, head), over chunks of Q steps, with dax = x * dt,
// da = dt * A, cum the inclusive prefix sum of da in the chunk and last =
// cum[Q-1]:
//
//     y[q]  = sum_{k<=q} (C_q . B_k) exp(cum[q] - cum[k]) dax[k]
//           + exp(cum[q]) (C_q . S)
//     S    <- exp(last) S + sum_k B_k^T exp(last - cum[k]) dax[k]
//
// carrying the N x P state S from chunk to chunk; y leaves as float32.  B and
// C are shared by the heads of a group: head h reads group h / (H / G).  A
// length that is not a multiple of Q is ssd_ref's right zero-padding: the
// missing steps load dt = x = B = C = 0, exact no-ops, and are never stored.
// ref.ssd_tc is the plain model of this arithmetic.
//
// Bound on an H100 SXM: bytes.  At mamba2-130m's prefill (B=4, S=2048, H=24,
// P=64, G=1, N=128, Q=128) the scan needs about 8.2e9 FLOP (0.008 ms at the
// 989 TFLOP/s bf16 peak) against about 80 MB of x, dt, B, C in and f32 y out
// (0.024 ms at 3.35 TB/s).
//
// Design:
//   * the state's P columns are split across blocks: column p of S evolves
//     only with column p of dax, and y[:, p] reads only that column, so a
//     block per (16-column slice, head, batch) computes its slice exactly.
//     mamba2-130m gets 4 x 24 x 4 = 384 blocks instead of PR 12's 96.  A
//     block takes about 100 KB of shared memory and at most 128 registers a
//     thread, so two blocks share an SM (264 slots, 1.45 waves of blocks
//     that each run the whole chunk loop); a 32-column slice would give 192
//     blocks, most SMs one block and no second block to hide its loads;
//   * every product runs on the tensor cores (mma.sync.m16n8k16, bf16 in,
//     f32 accumulation).  C.B^T has bf16 operands, so its products are
//     exact.  The other three products have one f32 operand and one exact
//     bf16 operand (C or x): (C.B^T o decay o dt) . x, C . S and
//     (B o exp(last - cum) o dt)^T . x.  The f32 operand is split into three
//     bf16 terms (hi, mid, lo: about 24 significant bits, as f32 has), so
//     each such product is three passes and keeps f32 accuracy;
//   * each warp owns 16 query rows of the chunk for y.  The C.B^T tile of
//     16 x 16 is formed at or below the diagonal only, turned in registers
//     into the A fragment of the next product (decay, dt, split), and never
//     stored.  Warp w has w + 1 such tiles, so the state's 16-row blocks go
//     to the warps with the least work; the f32 state stays in shared
//     memory between chunks, beside its three bf16 terms, which the next
//     chunk's C . S product reads;
//     The row blocks are paired across the SM's four sub-partitions (warps
//     w and w + 4 take row blocks w and 7 - w), so each sub-partition has
//     the same C.B^T work;
//   * the kernel is bound by issued instructions and by the L2, not by the
//     tensor cores (perf/k4_parts.py times it part by part): fragments come
//     from shared memory by ldmatrix (.trans where the operand is stored
//     the other way), the splits convert two values per instruction, the
//     C.B^T tile runs four independent mma chains, the copy loops divide
//     nothing, and N = chunk = 128 (mamba2's) is compiled as constants, so
//     its loops unroll without run-time bounds;
//   * B and C stay bf16 in shared memory (34 KB each, rows padded by 16
//     bytes so that an ldmatrix meets no bank conflict).  cp.async
//     prefetches chunk c+1's x and dt into a second buffer while chunk c
//     computes, C as soon as the warps hold their C fragments in
//     registers, and B after its last use, behind the C . S product.
//
// C.B^T is computed again by every slice and every head of a group (about
// 2.6e10 FLOP at mamba2-130m's prefill, 0.03 ms at the bf16 peak), and every
// block reads its batch's B and C whole.  A block of three heads that shares
// C.B^T and the loads was slower: one such block per SM left too few warps
// to hide the mma latency.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;   // devices one process may launch on
constexpr int kQMax = 128;        // largest chunk
constexpr int kNMax = 128;        // largest state size
constexpr int kPS = 16;           // state columns per block
constexpr int kLd = kNMax + 8;    // row stride of B, C and the state terms (bf16): 272 B
constexpr int kXld = kPS + 8;     // row stride of x (bf16): 48 B
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;

// shared memory, in bytes.  The row strides of 272 and 48 bytes put the 8
// rows that one ldmatrix reads in distinct banks.
constexpr int kBs = 0;                                   // B [kQMax][kLd] bf16
constexpr int kCs = kBs + kQMax * kLd * 2;               // C [kQMax][kLd] bf16
constexpr int kXs = kCs + kQMax * kLd * 2;               // x [2][kQMax][kXld] bf16
constexpr int kDts = kXs + 2 * kQMax * kXld * 2;         // dt [2][kQMax] f32
constexpr int kCum = kDts + 2 * kQMax * 4;               // cum [kQMax] f32
constexpr int kWdt = kCum + kQMax * 4;                   // exp(last - cum) dt [kQMax]
constexpr int kEcum = kWdt + kQMax * 4;                  // exp(cum) [kQMax]
constexpr int kSt = kEcum + kQMax * 4;                   // S terms [3][kPS][kLd] bf16
constexpr int kSf = kSt + 3 * kPS * kLd * 2;             // S [kNMax][kPS] f32
constexpr int kSmemBytes = kSf + kNMax * kPS * 4;

struct Args {
  const __nv_bfloat16* x;   // (B, S, H, P)
  const float* dt;          // (B, S, H)
  const float* A;           // (H,)
  const __nv_bfloat16* B;   // (B, S, G, N)
  const __nv_bfloat16* C;   // (B, S, G, N)
  float* y;                 // (B, S, H, P)
  int seqlen, n_heads, headdim, n_groups, state, chunk;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.  .trans hands each thread a column pair
// instead of a row pair.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D(16x8) += A(16x16) . B(16x8), bf16 in, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// a pair of f32 values as three bf16 pairs (hi, mid, lo) whose sums are the
// values to about 24 significant bits
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// kNp, kQp: the state size and the chunk padded to 16, when known at
// compile time (mamba2's 128 and 128), or 0 to read them from the arguments
template <int kNp, int kQp>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_tc_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + kBs);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem + kCs);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + kXs);
  float* dts = reinterpret_cast<float*>(smem + kDts);
  float* cum = reinterpret_cast<float*>(smem + kCum);
  float* wdt = reinterpret_cast<float*>(smem + kWdt);
  float* ecum = reinterpret_cast<float*>(smem + kEcum);
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + kSt);
  float* sf = reinterpret_cast<float*>(smem + kSf);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int lq = lane >> 3;   // the 8x8 matrix this lane addresses in an ldmatrix
  const int lr = lane & 7;    // and its row there
  const int p0 = blockIdx.x * kPS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int P = a.headdim, N = a.state, Q = a.chunk, S = a.seqlen;
  const int qp = kQp ? kQp : (Q + 15) & ~15;   // the chunk padded to whole 16-row tiles
  const int np = kNp ? kNp : (N + 15) & ~15;
  const int grp = h / (a.n_heads / a.n_groups);
  const float A = a.A[h];
  const long long x_step = static_cast<long long>(a.n_heads) * P;
  const long long bc_row = static_cast<long long>(a.n_groups) * N;   // B, C step stride
  const long long bs0 = static_cast<long long>(b) * S;   // first step of this sequence
  const __nv_bfloat16* xg = a.x + bs0 * x_step + static_cast<long long>(h) * P + p0;
  const float* dtg = a.dt + bs0 * a.n_heads + h;
  const __nv_bfloat16* bg = a.B + bs0 * bc_row + static_cast<long long>(grp) * N;
  const __nv_bfloat16* cg = a.C + bs0 * bc_row + static_cast<long long>(grp) * N;
  float* yg = a.y + bs0 * x_step + static_cast<long long>(h) * P + p0;

  // zero B, C and the state: the pad columns of B and C are never written
  // again, and S starts at 0
  for (int i = tid; i < kXs / 16; i += kThreads) reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 3 * kPS * kLd / 2; i += kThreads) reinterpret_cast<uint32_t*>(st)[i] = 0u;
  for (int i = tid; i < kNMax * kPS; i += kThreads) sf[i] = 0.f;
  __syncthreads();

  // a row of B or C is N / 8 16-byte pieces: this thread copies piece
  // bc_c of rows bc_q0, bc_q0 + bc_step, ... (no division in the loop)
  const int pieces = N / 8;
  const int bc_step = kThreads / pieces;
  const int bc_c = tid % pieces;
  const int bc_q0 = tid / pieces;
  auto load_bc = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int t0) {
    if (bc_q0 >= bc_step) return;
    for (int q = bc_q0; q < qp; q += bc_step) {
      const bool in = q < Q && t0 + q < S;
      cp16(dst + q * kLd + bc_c * 8, in ? src + (t0 + q) * bc_row + bc_c * 8 : src,
           in ? 16 : 0);
    }
  };
  auto load_x_dt = [&](int buf, int t0) {
    for (int i = tid; i < qp * 2; i += kThreads) {
      const int q = i >> 1, c = i & 1;
      const bool in = q < Q && t0 + q < S && p0 + c * 8 < P;
      cp16(xs + (buf * kQMax + q) * kXld + c * 8, in ? xg + (t0 + q) * x_step + c * 8 : xg,
           in ? 16 : 0);
    }
    for (int q = tid; q < qp; q += kThreads) {
      const bool in = q < Q && t0 + q < S;
      cp4(dts + buf * kQMax + q, in ? dtg + static_cast<long long>(t0 + q) * a.n_heads : dtg,
          in ? 4 : 0);
    }
  };

  load_bc(bs, bg, 0);
  load_bc(cs, cg, 0);
  load_x_dt(0, 0);
  cp_commit();

  // Warp w forms y for the 16 query rows of row block rb; rb = w + 1 key
  // blocks of C.B^T work at or below the diagonal.  Warps w and w + 4 share
  // an SM sub-partition, so they take row blocks w and 7 - w: 9 blocks of
  // work for each sub-partition.  The state's 16-row blocks then go to the
  // warps with the least work, greedily (counted in mma).
  const int rb = warp < 4 ? warp : 11 - warp;
  const bool rows_y = rb * 16 < qp;
  uint32_t my_blocks = 0;
  {
    int load[kWarps];
    for (int w = 0; w < kWarps; ++w) {
      const int r = w < 4 ? w : 11 - w;
      load[w] = r * 16 < qp ? (r + 1) * (np / 16 * 2 + 6) + np / 16 * 6 : 0;
    }
    for (int nb = 0; nb < np / 16; ++nb) {
      int best = 0;
      for (int w = 1; w < kWarps; ++w)
        if (load[w] < load[best]) best = w;
      load[best] += qp / 16 * 6;
      if (best == warp) my_blocks |= 1u << nb;
    }
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int buf = c & 1;
    const __nv_bfloat16* xb = xs + buf * kQMax * kXld;
    const float* dtb = dts + buf * kQMax;
    cp_wait_all();
    __syncthreads();   // chunk c's B, C, x and dt have landed; the last chunk is consumed
    if (c + 1 < n_chunks) {
      load_x_dt(buf ^ 1, t0 + Q);
      cp_commit();
    }
    if (warp == 0) {   // inclusive prefix sum of da: 4 steps a lane, then a shuffle scan
      float part[4];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = lane * 4 + j;
        run += q < qp ? dtb[q] * A : 0.f;
        part[j] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += o;
      }
      const float before = tot - run;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = lane * 4 + j;
        if (q < qp) cum[q] = before + part[j];
      }
    }
    __syncthreads();
    const float last = cum[qp - 1];   // the padded steps add da = 0
    if (tid < qp) {
      wdt[tid] = expf(last - cum[tid]) * dtb[tid];
      ecum[tid] = expf(cum[tid]);
    }

    // this warp's C fragments (its 16 rows, all of N), held for the chunk
    uint32_t cf[kNMax / 16][4];
    if (rows_y) {
#pragma unroll
      for (int ks = 0; ks < kNMax / 16; ++ks)
        if (ks * 16 < np)
          ldsm4(cf[ks], cs + (rb * 16 + (lq & 1) * 8 + lr) * kLd + ks * 16 + (lq >> 1) * 8);
    }
    __syncthreads();   // C is in registers (and wdt, ecum are written)
    if (c + 1 < n_chunks) {
      load_bc(cs, cg, t0 + Q);
      cp_commit();
    }

    // S <- exp(last) S + (B o wdt)^T . x for this warp's 16-row blocks of S;
    // the f32 state lives in shared memory between chunks (its bf16 terms
    // are what y_inter reads)
    const float el = expf(last);
    for (int nb = 0; nb < np / 16; ++nb) {
      if (!(my_blocks >> nb & 1u)) continue;
      const int n_lo = nb * 16 + g;
      // S[n][p]: n = n_lo (+8), p = 8j + 2 t4 (+1); one accumulator per
      // bf16 term, so three independent mma chains per n8 tile
      float sacc[3][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sacc[0][j][r] = el * sf[(n_lo + 8 * (r >> 1)) * kPS + 8 * j + 2 * t4 + (r & 1)];
          sacc[1][j][r] = sacc[2][j][r] = 0.f;
        }
      for (int kk = 0; kk < qp / 16; ++kk) {
        // A = B^T of keys kk*16.., state rows nb*16..: a[r] holds (n, keys
        // k, k + 1) with n = n_lo (+8 for r odd), k = kk*16 + 2 t4 (+8 for r >= 2)
        uint32_t bt[4];
        ldsm4_t(bt, bs + (kk * 16 + (lq >> 1) * 8 + lr) * kLd + nb * 16 + (lq & 1) * 8);
        const float2 w_lo = *reinterpret_cast<const float2*>(wdt + kk * 16 + 2 * t4);
        const float2 w_hi = *reinterpret_cast<const float2*>(wdt + kk * 16 + 2 * t4 + 8);
        uint32_t ah[4], am[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 bv = unpack(bt[r]);
          const float2 w = r >= 2 ? w_hi : w_lo;
          split3(bv.x * w.x, bv.y * w.y, ah[r], am[r], al[r]);
        }
        uint32_t xf[4];   // b0, b1 of p 0-7, then of p 8-15
        ldsm4_t(xf, xb + (kk * 16 + (lq & 1) * 8 + lr) * kXld + (lq >> 1) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma(sacc[0][j], ah, xf[2 * j], xf[2 * j + 1]);
          mma(sacc[1][j], am, xf[2 * j], xf[2 * j + 1]);
          mma(sacc[2][j], al, xf[2 * j], xf[2 * j + 1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sf[(n_lo + 8 * (r >> 1)) * kPS + 8 * j + 2 * t4 + (r & 1)] =
              sacc[0][j][r] + (sacc[1][j][r] + sacc[2][j][r]);
    }

    // y_intra: per 16-key block at or below the diagonal, G = C . B^T, then
    // (G o decay o dt) . x with the f32 operand in three bf16 terms
    float yacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (rows_y) {
      const int q_lo = rb * 16 + g;   // rows q_lo, q_lo + 8
      const float cq[2] = {cum[q_lo], cum[q_lo + 8]};
      for (int kb = 0; kb <= rb; ++kb) {
        // two accumulators per n8 tile (even and odd depth steps): four
        // independent mma chains instead of two
        float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float gu[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < kNMax / 16; ++ks) {
          if (ks * 16 >= np) continue;
          uint32_t bf[4];   // b0, b1 of keys 0-7 of the block, then of keys 8-15
          ldsm4(bf, bs + (kb * 16 + (lq >> 1) * 8 + lr) * kLd + ks * 16 + (lq & 1) * 8);
          mma(ks & 1 ? gu[0] : gt[0], cf[ks], bf[0], bf[1]);
          mma(ks & 1 ? gu[1] : gt[1], cf[ks], bf[2], bf[3]);
        }
        // gt[j][2i + e]: row q_lo + 8i, key kb*16 + 8j + 2 t4 + e
        float v[8];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k0 = kb * 16 + 8 * j + 2 * t4;
          const float2 ck = *reinterpret_cast<const float2*>(cum + k0);
          const float2 dk = *reinterpret_cast<const float2*>(dtb + k0);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = q_lo + 8 * i;
            // exp of the segment sum only at or below the diagonal
            v[4 * j + 2 * i] =
                k0 <= q ? (gt[j][2 * i] + gu[j][2 * i]) * (__expf(cq[i] - ck.x) * dk.x) : 0.f;
            v[4 * j + 2 * i + 1] = k0 + 1 <= q ? (gt[j][2 * i + 1] + gu[j][2 * i + 1]) *
                                                     (__expf(cq[i] - ck.y) * dk.y)
                                               : 0.f;
          }
        }
        uint32_t ah[4], am[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split3(v[2 * r], v[2 * r + 1], ah[r], am[r], al[r]);
        uint32_t xf[4];
        ldsm4_t(xf, xb + (kb * 16 + (lq & 1) * 8 + lr) * kXld + (lq >> 1) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma(yacc[j], ah, xf[2 * j], xf[2 * j + 1]);
          mma(yacc[j], am, xf[2 * j], xf[2 * j + 1]);
          mma(yacc[j], al, xf[2 * j], xf[2 * j + 1]);
        }
      }
    }
    __syncthreads();   // every read of B is done; S is new in sf
    if (c + 1 < n_chunks) {
      load_bc(bs, bg, t0 + Q);
      cp_commit();
    }

    // y_inter = C . S_prev, from the state's three bf16 terms (one
    // accumulator per term: six independent mma chains)
    float yi[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (rows_y) {
      float yt[3][2][4];
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) yt[term][j][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kNMax / 16; ++ks) {
        if (ks * 16 >= np) continue;
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          uint32_t sb[4];   // b0, b1 of p 0-7, then of p 8-15
          ldsm4(sb, st + (term * kPS + (lq >> 1) * 8 + lr) * kLd + ks * 16 + (lq & 1) * 8);
          mma(yt[term][0], cf[ks], sb[0], sb[1]);
          mma(yt[term][1], cf[ks], sb[2], sb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) yi[j][r] = yt[0][j][r] + (yt[1][j][r] + yt[2][j][r]);
    }
    __syncthreads();   // every read of the state terms is done
    // the new state's bf16 terms, transposed: st[term][p][n]
    for (int i = tid; i < np * kPS; i += kThreads) {
      const int n = i / kPS, p = i - n * kPS;
      const float v = sf[i];
      const __nv_bfloat16 s_hi = __float2bfloat16_rn(v);
      const float r = v - __bfloat162float(s_hi);
      const __nv_bfloat16 s_mid = __float2bfloat16_rn(r);
      st[p * kLd + n] = s_hi;
      st[(kPS + p) * kLd + n] = s_mid;
      st[(2 * kPS + p) * kLd + n] = __float2bfloat16_rn(r - __bfloat162float(s_mid));
    }
    if (rows_y) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = rb * 16 + g + 8 * i;
        if (q >= Q || t0 + q >= S) continue;
        const float eq = ecum[q];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = 8 * j + 2 * t4;
          if (p0 + p >= P) continue;
          *reinterpret_cast<float2*>(yg + (t0 + q) * x_step + p) =
              make_float2(yacc[j][2 * i] + eq * yi[j][2 * i],
                          yacc[j][2 * i + 1] + eq * yi[j][2 * i + 1]);
        }
      }
    }
  }
}

template <int kNp, int kQp>
int launch(const Args& a, int batch, cudaStream_t stream) {
  // the attribute is set on the current device's copy of the kernel
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(ssd_scan_tc_kernel<kNp, kQp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid((a.headdim + kPS - 1) / kPS, a.n_heads, batch);
  ssd_scan_tc_kernel<kNp, kQp><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the bf16 tensor-core K4 on `stream`.  x (B, S, H, P), B/C (B, S, G,
// N) bfloat16 contiguous with 16-byte-aligned pointers; dt (B, S, H) and A
// (H,) float32 contiguous; y (B, S, H, P) float32 contiguous.  Needs P and N
// multiples of 8, N <= 128 and chunk <= 128.  Returns cudaGetLastError()
// after the launch (0 on success); the caller validates devices, dtypes and
// shapes.
extern "C" int ssd_scan_tc_launch(const void* x, const float* dt, const float* A, const void* B,
                                  const void* C, float* y, int batch, int seqlen, int n_heads,
                                  int headdim, int n_groups, int state, int chunk,
                                  void* stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (batch < 1 || seqlen < 1 || headdim < 1 || headdim % 8 != 0 || state < 8 ||
      state > kNMax || state % 8 != 0 || chunk < 1 || chunk > kQMax || n_groups < 1 ||
      n_heads < 1 || n_heads % n_groups != 0 || !aligned(x) || !aligned(B) || !aligned(C))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(B),
               static_cast<const __nv_bfloat16*>(C), y, seqlen, n_heads, headdim, n_groups,
               state, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // N and the chunk both padded to 128 (mamba2's 128 and 128): sizes fixed
  // at compile time; anything else reads them at run time
  return state > 112 && chunk > 112 ? launch<128, 128>(a, batch, st)
                                    : launch<0, 0>(a, batch, st);
}
