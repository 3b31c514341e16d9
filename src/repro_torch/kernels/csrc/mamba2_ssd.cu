// The Mamba2 SSD scan (Zamba2's backbone) for Hopper (sm_90a), forward and
// a deterministic backward, both in the chunked matmul form on tensor cores.
//
// The forward replaces the TPU kernel in src/repro/kernels/mamba2_ssd.py:
//   mamba2_pallas (_ssd_kernel, pl.pallas_call at :101)
// and computes what its body computes, per batch row b and head h:
//   S_t = exp(A_h dt_t) S_{t-1} + dt_t x_t B_t^T    (P x N, f32)
//   y_t = S_t C_t                                    (written in x's dtype)
// with x, B, C read in their dtype (f32 or bf16; B and C are shared by every
// head of a batch row), dt and A in f32, and the state in f32.  Unlike the
// Pallas kernel, which asserts a zero initial state, it starts from a given
// state s0 (null: zero).  The reference has no backward kernel (JAX
// differentiates the jnp chunked version); this one gives dx, ddt, dA, dB,
// dC and d(s0), none through the final state.
//
// The chunk form (chunks of kChunk = 64 tokens, as the TPU kernel's), with
// L_i the inclusive sum of a_k = A dt_k over the chunk, u_j = dt_j x_j, S0
// and S1 the chunk's start and end states and dS1 the gradient on S1:
//   M_ij = (C_i . B_j) e^{L_i - L_j} [j <= i]
//   y_i  = sum_j M_ij u_j + e^{L_i} S0 C_i
//   S1   = e^{L_last} S0 + sum_j e^{L_last - L_j} u_j B_j^T
//   du_j = sum_i M_ij dy_i + w_j dS1 B_j                  (w_j = e^{L_last - L_j})
//   dB_j = sum_i (dM E)_ij C_i + w_j dt_j dS1^T x_j        (dM_ij = dt_j dy_i . x_j)
//   dC_i = sum_j (dM E)_ij B_j + e^{L_i} S0^T dy_i
//   dS0  = e^{L_last} dS1 + sum_i e^{L_i} dy_i C_i^T
//   da_k = sum_{i>=k} (rowZ_i - colZ_i + r_i) + sum_{j<k} q_j + e^{L_last} <dS1, S0>
// with Z = dM * M off its diagonal, r_i = e^{L_i} dy_i . (S0 C_i) and q_j =
// w_j dt_j x_j . (dS1 B_j); then dx = dt du, ddt_k = x_k . du_k + A da_k and
// dA = sum_k dt_k da_k.  kernels/ref.py mirrors this arithmetic plainly
// (mamba2_ssd_chunked, mamba2_ssd_chunked_grads).  No exponent is positive:
// e^{L_i - L_j} is taken only where j <= i, and no decay is ever divided
// out.  The state-gradient terms of da are summed from the front (q) and
// the diagonal of Z is left out of both its sums, so no sum takes the
// difference of two whole-chunk totals.
//
// Bound: at zamba2-2.7b's training shape (B 4, T 512, 80 heads, P = N = 64,
// bf16 x/B/C) the forward must move ~48 MB and the backward ~65 MB, ~0.014
// and ~0.019 ms at 3.35 TB/s; the chunk form's products (four 64 x 64 x 64
// per chunk and head forward, nine backward) need ~1.3 and ~3 GFLOP of
// tensor-core work, so both are bound by bytes on paper.  What bounds these
// kernels is latency along the chain over chunks: each block walks its
// (b, h)'s 8 chunks in order (forward) or in reverse (backward), and the
// 320 blocks of that shape give each SM about 10 warps, too few to hide
// the ldmatrix -> mma -> barrier chain of a chunk.  The design keeps the
// chain short (barriers per chunk: 2 forward, 6 backward plus 2 cluster
// barriers; the per-token f64 scans run off it), keeps the state in
// registers (no state round-trips through device memory inside a call),
// and keeps every block resident at once (3 blocks per SM).
//
// Design.  One block of 4 warps per (b, h); warp w owns rows 16w..16w+15 of
// every 64 x 64 product (tokens i or j, or state rows p), so the state S
// (forward) and dS (backward) live in registers in the m16n8 accumulator
// layout.  P and N are zero-padded to 64 in shared memory, and the ragged
// last chunk is zero-filled (dt = 0 there, so L stays flat and padded tokens
// add nothing); one instantiation per dtype.
// - bf16 route (the training path): every product is mma.sync m16n8k16
//   (bf16 in, f32 accumulate), operands read with ldmatrix (.trans for the
//   transposed ones) from 64 x 64 bf16 tiles whose 16-byte groups are
//   XOR-swizzled by row, so neither ldmatrix nor the fragment stores
//   conflict on banks.  x, B, C and dy are exact bf16 operands; an f32
//   operand (M, S, dS, dM E, the decayed B and C) enters as a hi + lo bf16
//   pair and costs two passes, so products carry ~16 bits of the f32
//   value.  The forward's y_intra takes M straight from G's accumulator
//   registers (no shared-memory round trip); a per-token scale of an exact
//   operand (w dt B, e^L C) is applied and split as the fragment loads.
// - f32 route: the same chunk form in exact f32 FMAs on the CUDA cores over
//   f32 tiles (not on the training path).
// - Forward: x, B, C and dt of chunk c + 1 are copied with cp.async
//   (16-byte groups; element copies when P or N is not a multiple of 8)
//   into a second buffer while chunk c computes.  The chunk-start states
//   (every 64 tokens) are written only when asked (save, for the backward).
// - Backward: the chunks run in reverse; dS1 starts at 0.  S0 comes from
//   the forward's saved state.  The per-token scalars (row and column sums
//   of Z, r, q, x . du) are f32 sums over one chunk; da's sums, ddt, and
//   dA's sum over T run in f64 in the last warp (warp scans), one chunk
//   behind, beside warp 0's decays of the next chunk.  L itself is summed
//   in f64 (so L_i - L_j keeps f32's precision) and every exponential is
//   f32.
//   dB and dC are summed over a cluster of G blocks (G heads of one batch
//   row, G | H, up to 8): each block leaves its (64 x N) partials in shared
//   memory, and after a cluster barrier block g sums rows g 64/G.. over the
//   cluster's blocks in head order (distributed shared memory), so the
//   partial written per head group is (B, T, H / G, N) f32.  The next
//   chunk's tiles are copied during that sum.  A second, small launch sums
//   the head groups' partials and dA's per-(b, h) f64 parts in a fixed
//   order.  No atomics anywhere: the same inputs give the same bits.
//   CUDA launches per call: forward 1, backward 2.
//
// Instantiations: ssd_fwd_kernel, ssd_bwd_kernel and ssd_finish_kernel for
// float and bf16; P and N padded to 64 (one bucket).  The bf16 kernels are
// capped at 168 registers (__launch_bounds__ for 3 blocks of 128 threads
// per SM, so all 320 blocks of zamba2's training shape are resident at
// once); under that cap ptxas spills 24 B in the forward and about 0.5 KB
// in the backward (the build's -Xptxas -v report, printed by
// chip_smoke.py).  Without the cap (2 blocks per SM) neither spills more
// than 70 B, but the 320 blocks take two waves and both kernels run ~1.3x
// (backward) to ~1.5x (forward) slower (tools/ssd_variants.py).  The f32
// kernels take up to 255 registers, no spills.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;    // tokens per chunk; the state-save interval
constexpr int kDim = 64;      // P and N are zero-padded to this
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kF32Stride = kDim + 1;
constexpr unsigned kFull = 0xffffffffu;
// the lo halves of split operands take their own mma pass (off: f32
// operands rounded once to bf16; tools/ssd_variants.py times both)
constexpr bool kLoPass = true;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------- //
// tiles
// ---------------------------------------------------------------------- //

struct TileB { bf16 v[kDim * kDim]; };          // bf16, 16-byte groups swizzled
struct SplitB { TileB hi, lo; };                 // an f32 tile as hi + lo
struct TileF { float v[kDim * kF32Stride]; };    // f32, rows padded by one

template <typename T> struct Route;
template <> struct Route<bf16> { using Exact = TileB; using Split = SplitB; };
template <> struct Route<float> { using Exact = TileF; using Split = TileF; };

__device__ __forceinline__ int swz(int r, int c) {
  return r * kDim + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}
__device__ __forceinline__ int fidx(int r, int c) { return r * kF32Stride + c; }

__device__ __forceinline__ float get(const TileB& t, int r, int c) {
  return __bfloat162float(t.v[swz(r, c)]);
}
__device__ __forceinline__ float get(const TileF& t, int r, int c) {
  return t.v[fidx(r, c)];
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi + lo bf16 pairs of two f32 values
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// the f32 values (r, c) and (r, c + 1), c even
__device__ __forceinline__ void put2(SplitB& t, int r, int c, float a, float b) {
  uint32_t hi, lo;
  split2(a, b, hi, lo);
  *reinterpret_cast<uint32_t*>(&t.hi.v[swz(r, c)]) = hi;
  *reinterpret_cast<uint32_t*>(&t.lo.v[swz(r, c)]) = lo;
}
__device__ __forceinline__ void put2(TileF& t, int r, int c, float a, float b) {
  t.v[fidx(r, c)] = a;
  t.v[fidx(r, c + 1)] = b;
}

// a split tile seen as 64 x 64 f32 (for the cluster's dB / dC sum)
__device__ __forceinline__ float* red_ptr(SplitB& t) { return reinterpret_cast<float*>(&t); }
__device__ __forceinline__ float* red_ptr(TileF& t) { return t.v; }
__device__ __forceinline__ int red_at(const SplitB*, int r, int c) {
  return r * kDim + (c ^ ((r & 7) << 3));
}
__device__ __forceinline__ int red_at(const TileF*, int r, int c) { return fidx(r, c); }

// ---------------------------------------------------------------------- //
// copies into shared memory
// ---------------------------------------------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// rows [0, rows) x cols [0, width) of a strided matrix at src + base, zero
// elsewhere; 16-byte groups when ``vec`` (width % 8 == 0, aligned rows)
__device__ __forceinline__ void stage(TileB& dst, const bf16* src, size_t base,
                                      size_t stride, int rows, int width, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kDim * 8; idx += kThreads) {
      const int r = idx >> 3, c = (idx & 7) << 3;
      const bool ok = r < rows && c < width;
      cp16(&dst.v[swz(r, c)], ok ? src + base + r * stride + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kDim * kDim; idx += kThreads) {
      const int r = idx >> 6, c = idx & 63;
      dst.v[swz(r, c)] = (r < rows && c < width) ? src[base + r * stride + c]
                                                 : __float2bfloat16(0.f);
    }
  }
}
__device__ __forceinline__ void stage(TileF& dst, const float* src, size_t base,
                                      size_t stride, int rows, int width, bool) {
  for (int idx = threadIdx.x; idx < kDim * kDim; idx += kThreads) {
    const int r = idx >> 6, c = idx & 63;
    const bool ok = r < rows && c < width;
    cp4(&dst.v[fidx(r, c)], ok ? src + base + r * stride + c : src, ok);
  }
}
__device__ __forceinline__ void stage_dt(float* dst, const float* dt, size_t base,
                                         int heads, int rows) {
  for (int j = threadIdx.x; j < kChunk; j += kThreads) {
    cp4(&dst[j], j < rows ? dt + base + static_cast<size_t>(j) * heads : dt, j < rows);
  }
}

// ---------------------------------------------------------------------- //
// tensor-core products (bf16 route)
// ---------------------------------------------------------------------- //

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (rows m0.., cols k0..k0+15) of a tile holding A as [m][k]
// (KF: k is the fast index) or as [k][m].
template <bool KF>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int m0, int k0,
                                       int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  if (KF) {
    ldsm4(a, t + swz(m0 + rr + (mi & 1) * 8, k0 + (mi >> 1) * 8));
  } else {
    ldsm4t(a, t + swz(k0 + rr + (mi >> 1) * 8, m0 + (mi & 1) * 8));
  }
}
// The B fragments of n-tiles n0 and n0 + 8 (regs 0-1 and 2-3), rows k0..,
// of a tile holding B as [n][k] (KF) or as [k][n].
template <bool KF>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* t, int n0, int k0,
                                       int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  if (KF) {
    ldsm4(b, t + swz(n0 + rr + (mi >> 1) * 8, k0 + (mi & 1) * 8));
  } else {
    ldsm4t(b, t + swz(k0 + rr + (mi & 1) * 8, n0 + (mi >> 1) * 8));
  }
}

// operands: an exact bf16 tile, a split f32 tile, an exact tile scaled by a
// per-k factor (split as it loads), or (A only) a 16 x 64 f32 strip in the
// caller's accumulator registers
template <bool KF, bool SPLIT> struct OpA { const bf16* hi; const bf16* lo; };
template <bool KF> struct OpAScaled { const bf16* t; const float* s; };
template <bool KF, bool SPLIT> struct OpB { const bf16* hi; const bf16* lo; };
template <typename T> struct ARegs { const float (*v)[4]; };

// acc (16 x 64) += A(k0..k0+15) B(k0..k0+15, :) for one k-step
template <bool ASPLIT, bool BKF, bool BSPLIT>
__device__ __forceinline__ void mma_k16(float (&acc)[8][4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const OpB<BKF, BSPLIT>& B,
                                        int k0, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bh[4], bl[4];
    load_b<BKF>(bh, B.hi, np * 16, k0, lane);
    if constexpr (BSPLIT && kLoPass) load_b<BKF>(bl, B.lo, np * 16, k0, lane);
    mma(acc[2 * np], ah, bh[0], bh[1]);
    mma(acc[2 * np + 1], ah, bh[2], bh[3]);
    if constexpr (ASPLIT && kLoPass) {
      mma(acc[2 * np], al, bh[0], bh[1]);
      mma(acc[2 * np + 1], al, bh[2], bh[3]);
    }
    if constexpr (BSPLIT && kLoPass) {
      mma(acc[2 * np], ah, bl[0], bl[1]);
      mma(acc[2 * np + 1], ah, bl[2], bl[3]);
    }
  }
}

// acc += A B over k = 0..63, for the warp's rows m0..m0 + 15
template <bool AKF, bool ASPLIT, class BOp>
__device__ __forceinline__ void product(float (&acc)[8][4], const OpA<AKF, ASPLIT>& A,
                                        const BOp& B, int m0, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < kDim; k0 += 16) {
    uint32_t ah[4], al[4];
    load_a<AKF>(ah, A.hi, m0, k0, lane);
    if constexpr (ASPLIT && kLoPass) load_a<AKF>(al, A.lo, m0, k0, lane);
    mma_k16<ASPLIT>(acc, ah, al, B, k0, lane);
  }
}
// A scaled by a per-k factor, split as it loads: regs 0-1 hold k0 + 2 (lane
// % 4) and the next k, regs 2-3 those + 8
template <bool AKF, class BOp>
__device__ __forceinline__ void product(float (&acc)[8][4], const OpAScaled<AKF>& A,
                                        const BOp& B, int m0, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < kDim; k0 += 16) {
    uint32_t raw[4], ah[4], al[4];
    load_a<AKF>(raw, A.t, m0, k0, lane);
    const int k = k0 + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = k + (r >> 1) * 8;
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
      split2(f.x * A.s[kk], f.y * A.s[kk + 1], ah[r], al[r]);
    }
    mma_k16<true>(acc, ah, al, B, k0, lane);
  }
}
template <class BOp>
__device__ __forceinline__ void product(float (&acc)[8][4], const ARegs<bf16>& A,
                                        const BOp& B, int, int lane) {
#pragma unroll
  for (int kk = 0; kk < kDim / 16; ++kk) {
    uint32_t ah[4], al[4];
    split2(A.v[2 * kk][0], A.v[2 * kk][1], ah[0], al[0]);
    split2(A.v[2 * kk][2], A.v[2 * kk][3], ah[1], al[1]);
    split2(A.v[2 * kk + 1][0], A.v[2 * kk + 1][1], ah[2], al[2]);
    split2(A.v[2 * kk + 1][2], A.v[2 * kk + 1][3], ah[3], al[3]);
    mma_k16<true>(acc, ah, al, B, kk * 16, lane);
  }
}

template <bool KF> __device__ __forceinline__ OpA<KF, false> a_of(const TileB& t) {
  return {t.v, nullptr};
}
template <bool KF> __device__ __forceinline__ OpA<KF, true> a_of(const SplitB& t) {
  return {t.hi.v, t.lo.v};
}
template <bool KF> __device__ __forceinline__ OpB<KF, false> b_of(const TileB& t) {
  return {t.v, nullptr};
}
template <bool KF> __device__ __forceinline__ OpB<KF, true> b_of(const SplitB& t) {
  return {t.hi.v, t.lo.v};
}
template <bool KF>
__device__ __forceinline__ OpAScaled<KF> a_scaled(const TileB& t, const float* s) {
  return {t.v, s};
}

// ---------------------------------------------------------------------- //
// CUDA-core products (f32 route), in the same accumulator layout
// ---------------------------------------------------------------------- //

template <bool KF> struct FOpA { const float* t; const float* s; };   // s: per-k scale or null
template <bool KF> struct FOpB { const float* t; };

template <bool BKF>
__device__ __forceinline__ void fma_k(float (&acc)[8][4], float a0, float a1,
                                      const FOpB<BKF>& B, int k, int lane) {
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = nt * 8 + c0 + e;
      const float bv = BKF ? B.t[fidx(n, k)] : B.t[fidx(k, n)];
      acc[nt][e] = fmaf(a0, bv, acc[nt][e]);
      acc[nt][2 + e] = fmaf(a1, bv, acc[nt][2 + e]);
    }
  }
}
template <bool AKF, bool BKF>
__device__ __forceinline__ void product(float (&acc)[8][4], const FOpA<AKF>& A,
                                        const FOpB<BKF>& B, int m0, int lane) {
  const int r0 = m0 + (lane >> 2);
#pragma unroll 2
  for (int k = 0; k < kDim; ++k) {
    const float s = A.s != nullptr ? A.s[k] : 1.f;
    const float a0 = (AKF ? A.t[fidx(r0, k)] : A.t[fidx(k, r0)]) * s;
    const float a1 = (AKF ? A.t[fidx(r0 + 8, k)] : A.t[fidx(k, r0 + 8)]) * s;
    fma_k(acc, a0, a1, B, k, lane);
  }
}
template <bool BKF>
__device__ __forceinline__ void product(float (&acc)[8][4], const ARegs<float>& A,
                                        const FOpB<BKF>& B, int, int lane) {
  const int base = lane & ~3;
#pragma unroll
  for (int k = 0; k < kDim; ++k) {   // A(row, k) lives in lane base + (k & 7) / 2
    const int src = base | ((k & 7) >> 1);
    const float a0 = __shfl_sync(kFull, A.v[k >> 3][k & 1], src);
    const float a1 = __shfl_sync(kFull, A.v[k >> 3][2 + (k & 1)], src);
    fma_k(acc, a0, a1, B, k, lane);
  }
}

template <bool KF> __device__ __forceinline__ FOpA<KF> a_of(const TileF& t) {
  return {t.v, nullptr};
}
template <bool KF>
__device__ __forceinline__ FOpA<KF> a_scaled(const TileF& t, const float* s) {
  return {t.v, s};
}
template <bool KF> __device__ __forceinline__ FOpB<KF> b_of(const TileF& t) { return {t.v}; }

// ---------------------------------------------------------------------- //
// shared pieces
// ---------------------------------------------------------------------- //

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
}
// the row and the column of accumulator element (nt, e) of this lane
__device__ __forceinline__ int frag_row(int m0, int lane, int e) {
  return m0 + (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int nt, int lane, int e) {
  return nt * 8 + 2 * (lane & 3) + (e & 1);
}

template <typename S>
__device__ __forceinline__ void put_acc(S& t, const float (&acc)[8][4], int m0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    put2(t, frag_row(m0, lane, 0), frag_col(nt, lane, 0), acc[nt][0], acc[nt][1]);
    put2(t, frag_row(m0, lane, 2), frag_col(nt, lane, 0), acc[nt][2], acc[nt][3]);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows [0, rows) x cols [0, width) of the warp's strip to dst[row * stride +
// col]; pairs in one store where width and stride are even
template <typename T>
__device__ __forceinline__ void write_acc(T* dst, size_t stride, const float (&acc)[8][4],
                                          int rows, int width, int m0, int lane) {
  const bool pair = ((width | stride) & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = frag_row(m0, lane, e), c = frag_col(nt, lane, e);
      if (r >= rows || c >= width) continue;
      T* d = dst + r * stride + c;
      if (pair) {
        store2(d, acc[nt][e], acc[nt][e + 1]);
      } else {
        store(d, acc[nt][e]);
        if (c + 1 < width) store(d + 1, acc[nt][e + 1]);
      }
    }
  }
}
__device__ __forceinline__ void read_acc(float (&acc)[8][4], const float* src, int rows,
                                         int width, int m0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = frag_row(m0, lane, e), c = frag_col(nt, lane, e);
      acc[nt][e] = (src != nullptr && r < rows && c < width) ? src[r * width + c] : 0.f;
    }
  }
}

// warp 0: L (inclusive sums of A dt, in f64, so that a difference L_i - L_j
// keeps f32's precision), e^{L_i}, the token weights w_j = e^{L_last - L_j}
// (times dt_j when ``times_dt``) and e^{L_last}
__device__ __forceinline__ void decays(const float* dt, float a, double* L, float* el,
                                       float* w, float* ell, bool times_dt, int lane) {
  const double v0 = a * dt[2 * lane], v1 = a * dt[2 * lane + 1];
  double s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += u;
  }
  double excl = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) excl = 0.0;
  const double l0 = excl + v0, l1 = l0 + v1;
  const double last = __shfl_sync(kFull, l1, 31);
  L[2 * lane] = l0;
  L[2 * lane + 1] = l1;
  el[2 * lane] = expf(static_cast<float>(l0));
  el[2 * lane + 1] = expf(static_cast<float>(l1));
  const float w0 = expf(static_cast<float>(last - l0));
  const float w1 = expf(static_cast<float>(last - l1));
  w[2 * lane] = times_dt ? w0 * dt[2 * lane] : w0;
  w[2 * lane + 1] = times_dt ? w1 * dt[2 * lane + 1] : w1;
  if (lane == 0) *ell = expf(static_cast<float>(last));
}

// the sum over the 4 lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

template <typename T>
struct FwdSmem {
  typename Route<T>::Exact x[2], b[2], c[2];
  typename Route<T>::Split s;   // the chunk's start state (y's operand)
  float dt[2][kChunk];
  double L[kChunk];
  float el[kChunk], wdt[kChunk];
  float ell;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 1)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s0,   // or null
               T* __restrict__ y, float* __restrict__ s_out,
               float* __restrict__ ckpt,   // (B, H, nc, P, N) or null
               int t_len, int heads, int p, int n, int vec_x, int vec_bc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<T>& sm = *reinterpret_cast<FwdSmem<T>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m0 = warp * 16;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const int nc = (t_len + kChunk - 1) / kChunk;
  const float a = A[h];
  const size_t pn = static_cast<size_t>(p) * n;

  float S[8][4];   // rows p, cols n
  read_acc(S, s0 == nullptr ? nullptr : s0 + bh * pn, p, n, m0, lane);
  put_acc(sm.s, S, m0, lane);

  auto copy_chunk = [&](int c) {
    const int t0 = c * kChunk, rows = min(kChunk, t_len - t0), buf = c & 1;
    const size_t row0 = static_cast<size_t>(b) * t_len + t0;
    stage(sm.x[buf], x, (row0 * heads + h) * p, static_cast<size_t>(heads) * p, rows, p,
          vec_x);
    stage(sm.b[buf], Bm, row0 * n, n, rows, n, vec_bc);
    stage(sm.c[buf], Cm, row0 * n, n, rows, n, vec_bc);
    stage_dt(sm.dt[buf], dt, row0 * heads + h, heads, rows);
    cp_commit();
  };
  copy_chunk(0);

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1, t0 = c * kChunk, rows = min(kChunk, t_len - t0);
    cp_wait_all();
    __syncthreads();   // chunk c staged; sm.s holds its start state
    if (c + 1 < nc) copy_chunk(c + 1);
    if (warp == 0) decays(sm.dt[buf], a, sm.L, sm.el, sm.wdt, &sm.ell, true, lane);
    float G[8][4], Y[8][4];
    zero(G);
    zero(Y);
    product(G, a_of<true>(sm.c[buf]), b_of<true>(sm.b[buf]), m0, lane);   // C B^T
    product(Y, a_of<true>(sm.c[buf]), b_of<true>(sm.s), m0, lane);        // C S0^T
    __syncthreads();   // the decays are in; every read of sm.s is done
    {
      const int i0 = frag_row(m0, lane, 0);
      const double Li[2] = {sm.L[i0], sm.L[i0 + 8]};
      const float eli[2] = {sm.el[i0], sm.el[i0 + 8]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + (e >> 1) * 8, j = frag_col(nt, lane, e);
          G[nt][e] = j <= i ? G[nt][e] * expf(static_cast<float>(Li[e >> 1] - sm.L[j])) *
                                  sm.dt[buf][j]
                            : 0.f;
          Y[nt][e] *= eli[e >> 1];
        }
      }
    }
    product(Y, ARegs<T>{G}, b_of<false>(sm.x[buf]), m0, lane);   // += (M dt) X
    write_acc(y + ((static_cast<size_t>(b) * t_len + t0) * heads + h) * p,
              static_cast<size_t>(heads) * p, Y, rows, p, m0, lane);

    if (ckpt != nullptr) write_acc(ckpt + (bh * nc + c) * pn, n, S, p, n, m0, lane);
    const float ell = sm.ell;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) S[nt][e] *= ell;
    }
    product(S, a_scaled<false>(sm.x[buf], sm.wdt), b_of<false>(sm.b[buf]), m0, lane);
    put_acc(sm.s, S, m0, lane);
  }
  write_acc(s_out + bh * pn, n, S, p, n, m0, lane);
}

// ---------------------------------------------------------------------- //
// backward
// ---------------------------------------------------------------------- //

template <typename T>
struct BwdSmem {
  typename Route<T>::Exact x, dy, b, c;
  // m: M, then dM E, then this head's dB partial (f32); s: dS1, then S0,
  // then this head's dC partial (f32)
  typename Route<T>::Split m, s;
  float dt[2][kChunk];
  double L[kChunk];
  float el[kChunk], w[kChunk];
  float rowz[kChunk], colz[kWarps][kChunk], r[kChunk], q[kChunk], xdu[kChunk];
  double ss[kWarps];
  float ell[2];   // by chunk parity: the last warp reads chunk c + 1's in chunk c
};

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ ckpt,
               const T* __restrict__ dy,
               const float* __restrict__ dstate,   // (B, H, P, N) or null: zero
               T* __restrict__ dx,
               float* __restrict__ ddt,        // (B, T, H)
               double* __restrict__ dA_part,   // (B, H)
               float* __restrict__ dB_part,    // (B, T, H / group, N)
               float* __restrict__ dC_part,    // (B, T, H / group, N)
               float* __restrict__ ds0,        // (B, H, P, N)
               int t_len, int heads, int p, int n, int group, int vec_x, int vec_bc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<T>& sm = *reinterpret_cast<BwdSmem<T>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m0 = warp * 16;
  const int i0 = frag_row(m0, lane, 0);   // this lane's rows: i0 and i0 + 8
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const int nc = (t_len + kChunk - 1) / kChunk;
  const float a = A[h];
  const size_t pn = static_cast<size_t>(p) * n;
  const int groups = heads / group;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = group > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  auto cluster_sync = [&]() {
    if (group > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  auto copy_chunk = [&](int c) {
    const int t0 = c * kChunk, rows = min(kChunk, t_len - t0);
    const size_t row0 = static_cast<size_t>(b) * t_len + t0;
    const size_t xs = static_cast<size_t>(heads) * p;
    stage(sm.x, x, (row0 * heads + h) * p, xs, rows, p, vec_x);
    stage(sm.dy, dy, (row0 * heads + h) * p, xs, rows, p, vec_x);
    stage(sm.b, Bm, row0 * n, n, rows, n, vec_bc);
    stage(sm.c, Cm, row0 * n, n, rows, n, vec_bc);
    stage_dt(sm.dt[c & 1], dt, row0 * heads + h, heads, rows);
    cp_commit();
  };
  // scale the rows of a strip by f(row)
  auto scale_rows = [&](float (&acc)[8][4], float s0, float s1) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= s0;
      acc[nt][1] *= s0;
      acc[nt][2] *= s1;
      acc[nt][3] *= s1;
    }
  };

  float dS[8][4];   // the gradient on the chunk's end state: rows p, cols n
  // the last chunk's end state is the final state: its gradient is dstate
  read_acc(dS, dstate != nullptr ? dstate + bh * pn : nullptr, p, n, m0, lane);
  double dA_acc = 0.0;
  // chunk c's da (f64 warp scans over its tokens), ddt and its part of dA;
  // run by the last warp at the start of chunk c - 1 (beside warp 0's
  // decays), off the chain of barriers: chunk c's per-token terms are
  // rewritten only after chunk c - 1's second barrier
  auto scalars = [&](int c) {
    const int t0 = c * kChunk, rows = min(kChunk, t_len - t0);
    const float* dtc = sm.dt[c & 1];
    double v[2], qv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * lane + e;
      double col = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) col += sm.colz[w][k];
      v[e] = static_cast<double>(sm.rowz[k]) - col + sm.r[k];
      qv[e] = sm.q[k];
    }
    // suffix sums of v, prefix sums of q, over the chunk's 64 tokens
    double suf = v[0] + v[1], pre = qv[0] + qv[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double us = __shfl_down_sync(kFull, suf, o);
      const double up = __shfl_up_sync(kFull, pre, o);
      if (lane + o < 32) suf += us;
      if (lane >= o) pre += up;
    }
    double suf_x = __shfl_down_sync(kFull, suf, 1);
    double pre_x = __shfl_up_sync(kFull, pre, 1);
    if (lane == 31) suf_x = 0.0;
    if (lane == 0) pre_x = 0.0;
    double ss = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ss += sm.ss[w];
    const double base = static_cast<double>(sm.ell[c & 1]) * ss;
    double da[2];
    da[1] = suf_x + v[1] + pre_x + qv[0] + base;
    da[0] = suf_x + v[1] + v[0] + pre_x + base;
    double part = 0.0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * lane + e;
      if (k < rows) {
        ddt[(static_cast<size_t>(b) * t_len + t0 + k) * heads + h] =
            static_cast<float>(sm.xdu[k] + static_cast<double>(a) * da[e]);
      }
      part += static_cast<double>(dtc[k]) * da[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    dA_acc += part;
  };

  copy_chunk(nc - 1);

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, rows = min(kChunk, t_len - t0);
    const float* dtc = sm.dt[c & 1];
    cp_wait_all();
    __syncthreads();   // chunk c staged; sm.m and sm.s are free
    if (warp == 0) decays(dtc, a, sm.L, sm.el, sm.w, &sm.ell[c & 1], false, lane);
    if (warp == kWarps - 1 && c + 1 < nc) scalars(c + 1);
    put_acc(sm.s, dS, m0, lane);
    float G[8][4], D[8][4];
    zero(G);
    zero(D);
    product(G, a_of<true>(sm.c), b_of<true>(sm.b), m0, lane);    // C B^T
    product(D, a_of<true>(sm.dy), b_of<true>(sm.x), m0, lane);   // dY X^T
    __syncthreads();   // decays in; sm.s = dS1

    // G -> M, D -> dM E; the off-diagonal Z = dM M summed by row and column
    {
      const double Li[2] = {sm.L[i0], sm.L[i0 + 8]};
      float rz[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float cz[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + (e >> 1) * 8, j = frag_col(nt, lane, e);
          const bool on = j <= i;
          const float E = on ? expf(static_cast<float>(Li[e >> 1] - sm.L[j])) : 0.f;
          const float m = G[nt][e] * E;
          const float dm = on ? D[nt][e] * dtc[j] : 0.f;
          const float z = j < i ? dm * m : 0.f;
          rz[e >> 1] += z;
          cz[e & 1] += z;
          G[nt][e] = m;
          D[nt][e] = dm * E;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cz[e];
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          v += __shfl_xor_sync(kFull, v, 16);
          if (lane < 4) sm.colz[warp][frag_col(nt, lane, e)] = v;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v = quad_sum(rz[half]);
        if ((lane & 3) == 0) sm.rowz[i0 + 8 * half] = v;
      }
    }
    put_acc(sm.m, G, m0, lane);
    __syncthreads();   // sm.m = M

    // du = w (B dS1^T) + M^T dY: rows j, cols p; q_j from the first term
    {
      float U[8][4];
      zero(U);
      product(U, a_of<true>(sm.b), b_of<true>(sm.s), m0, lane);
      float qs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qs[e >> 1] += get(sm.x, i0 + (e >> 1) * 8, frag_col(nt, lane, e)) * U[nt][e];
        }
      }
      const float w0 = sm.w[i0], w1 = sm.w[i0 + 8];
      scale_rows(U, w0, w1);
      product(U, a_of<false>(sm.m), b_of<false>(sm.dy), m0, lane);
      float xs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xs[e >> 1] += get(sm.x, i0 + (e >> 1) * 8, frag_col(nt, lane, e)) * U[nt][e];
        }
      }
      const float d0 = dtc[i0], d1 = dtc[i0 + 8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float qv = quad_sum(qs[half]), xv = quad_sum(xs[half]);
        if ((lane & 3) == 0) {
          sm.q[i0 + 8 * half] = (half ? w1 * d1 : w0 * d0) * qv;
          sm.xdu[i0 + 8 * half] = xv;
        }
      }
      scale_rows(U, d0, d1);
      write_acc(dx + ((static_cast<size_t>(b) * t_len + t0) * heads + h) * p,
                static_cast<size_t>(heads) * p, U, rows, p, m0, lane);
    }
    // dB = w dt (X dS1) + (dM E)^T C: rows j, cols n; the first term now
    float DB[8][4];
    zero(DB);
    product(DB, a_of<true>(sm.x), b_of<false>(sm.s), m0, lane);
    scale_rows(DB, sm.w[i0] * dtc[i0], sm.w[i0 + 8] * dtc[i0 + 8]);
    __syncthreads();   // every read of M and of dS1 is done
    put_acc(sm.m, D, m0, lane);
    {
      float S0[8][4];
      read_acc(S0, ckpt + (bh * nc + c) * pn, p, n, m0, lane);
      double ss = 0.0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ss += static_cast<double>(dS[nt][e]) * S0[nt][e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
      if (lane == 0) sm.ss[warp] = ss;
      put_acc(sm.s, S0, m0, lane);
    }
    __syncthreads();   // sm.m = dM E, sm.s = S0
    product(DB, a_of<false>(sm.m), b_of<false>(sm.c), m0, lane);

    // dC = e^L (dY S0) + dM E B: rows i, cols n; r_i = e^{L_i} dy_i . (S0 C_i)
    float DC[8][4];
    zero(DC);
    product(DC, a_of<true>(sm.dy), b_of<false>(sm.s), m0, lane);
    {
      scale_rows(DC, sm.el[i0], sm.el[i0 + 8]);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rs[e >> 1] += DC[nt][e] * get(sm.c, i0 + (e >> 1) * 8, frag_col(nt, lane, e));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v = quad_sum(rs[half]);
        if ((lane & 3) == 0) sm.r[i0 + 8 * half] = v;
      }
    }
    product(DC, a_of<true>(sm.m), b_of<false>(sm.b), m0, lane);

    // dS0 = e^{L_last} dS1 + (e^L dY)^T C
    {
      const float ell = sm.ell[c & 1];
      scale_rows(dS, ell, ell);
      product(dS, a_scaled<false>(sm.dy, sm.el), b_of<false>(sm.c), m0, lane);
    }
    __syncthreads();   // every tile read is done; the per-token terms are in
    if (c > 0) copy_chunk(c - 1);

    // this head's dB and dC, then their sum over the cluster's heads
    float* rb = red_ptr(sm.m);
    float* rc = red_ptr(sm.s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = frag_row(m0, lane, e), cc = frag_col(nt, lane, e);
        rb[red_at(&sm.m, r, cc)] = DB[nt][e];
        rb[red_at(&sm.m, r, cc + 1)] = DB[nt][e + 1];
        rc[red_at(&sm.s, r, cc)] = DC[nt][e];
        rc[red_at(&sm.s, r, cc + 1)] = DC[nt][e + 1];
      }
    }
    cluster_sync();
    {
      const int per = kChunk / group, r0 = rank * per;
      const size_t out0 = (static_cast<size_t>(b) * t_len + t0) * groups + h / group;
      for (int idx = threadIdx.x; idx < per * kDim; idx += kThreads) {
        const int r = r0 + idx / kDim, cc = idx % kDim;
        if (r >= rows || cc >= n) continue;
        const int ob = red_at(&sm.m, r, cc), oc = red_at(&sm.s, r, cc);
        float sb = 0.f, sc = 0.f;
        for (int g = 0; g < group; ++g) {
          const float* pb = group > 1 ? cluster.map_shared_rank(rb, g) : rb;
          const float* pc = group > 1 ? cluster.map_shared_rank(rc, g) : rc;
          sb += pb[ob];
          sc += pc[oc];
        }
        const size_t o = (out0 + static_cast<size_t>(r) * groups) * n + cc;
        dB_part[o] = sb;
        dC_part[o] = sc;
      }
    }
    cluster_sync();   // the cluster's partials are read; sm.m, sm.s are free
  }
  if (warp == kWarps - 1) {
    scalars(0);
    if (lane == 0) dA_part[bh] = dA_acc;
  }
  write_acc(ds0 + bh * pn, n, dS, p, n, m0, lane);
}

// dB and dC summed over the head groups, dA over the batch rows, in order
template <typename T>
__global__ void ssd_finish_kernel(const float* __restrict__ dB_part,
                                  const float* __restrict__ dC_part,
                                  const double* __restrict__ dA_part, T* __restrict__ dB,
                                  T* __restrict__ dC, float* __restrict__ dA, int bt,
                                  int groups, int n, int batch, int heads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < bt * n) {
    const int row = i / n, col = i % n;
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < groups; ++g) {
      const size_t o = (static_cast<size_t>(row) * groups + g) * n + col;
      sb += dB_part[o];
      sc += dC_part[o];
    }
    store(dB + i, sb);
    store(dC + i, sc);
  }
  if (i < heads) {
    double s = 0.0;
    for (int bb = 0; bb < batch; ++bb) s += dA_part[static_cast<size_t>(bb) * heads + i];
    dA[i] = static_cast<float>(s);
  }
}

// ---------------------------------------------------------------------- //
// launchers
// ---------------------------------------------------------------------- //

bool bad_shape(int b, int t, int h, int p, int n) {
  return b < 1 || t < 1 || h < 1 || p < 1 || n < 1 || p > kDim || n > kDim ||
         b > 65535;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename T>
int fwd(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
        const float* s0, void* y, float* s_out, float* ckpt, int b, int t, int h, int p,
        int n, cudaStream_t stream) {
  auto kernel = ssd_fwd_kernel<T>;
  const int smem = static_cast<int>(sizeof(FwdSmem<T>));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = sizeof(T) == 2 && p % 8 == 0 && aligned16(x);
  const int vec_bc = sizeof(T) == 2 && n % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), s0, static_cast<T*>(y), s_out, ckpt, t, h, p, n, vec_x,
      vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
        const float* ckpt, const void* dy, const float* dstate, void* dx, float* ddt,
        double* dA_part,
        float* dB_part, float* dC_part, float* ds0, void* dB, void* dC, float* dA, int b,
        int t, int h, int p, int n, int group, cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<T>;
  const int smem = static_cast<int>(sizeof(BwdSmem<T>));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = sizeof(T) == 2 && p % 8 == 0 && aligned16(x) && aligned16(dy);
  const int vec_bc = sizeof(T) == 2 && n % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(h, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = group;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), dt, A,
                           static_cast<const T*>(Bm), static_cast<const T*>(Cm), ckpt,
                           static_cast<const T*>(dy), dstate, static_cast<T*>(dx), ddt,
                           dA_part,
                           dB_part, dC_part, ds0, t, h, p, n, group, vec_x, vec_bc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bt = b * t, total = bt * n > h ? bt * n : h;
  ssd_finish_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      dB_part, dC_part, dA_part, static_cast<T*>(dB), static_cast<T*>(dC), dA, bt,
      h / group, n, b, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 for x, B, C, y (and dy, dx, dB,
// dC); dt, A, the states, ddt, dA and the partial sums are float32 (dA's
// per-(b, h) parts float64).  Tensors are contiguous: x, y (B, T, H, P), dt
// (B, T, H), A (H), B, C (B, T, N), states (B, H, P, N) (s0 may be null: a
// zero state), the saved chunk-start states (B, H, ceil(T / 64), P, N) --
// null to save none; the backward's dstate, the gradient on the final state
// (B, H, P, N), may be null: a zero one.  ``group`` heads (a divisor of H,
// at most 8) share a cluster; dB_part and dC_part are (B, T, H / group, N).
extern "C" int repro_ssd_fwd(int dtype, const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* s0, void* y,
                             void* s_out, void* ckpt, int b, int t, int h, int p, int n,
                             void* stream) {
  if (bad_shape(b, t, h, p, n) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  float* ck = static_cast<float*>(ckpt);
  return dtype == 0 ? fwd<float>(x, dtf, af, Bm, Cm, s0f, y, so, ck, b, t, h, p, n, s)
                    : fwd<bf16>(x, dtf, af, Bm, Cm, s0f, y, so, ck, b, t, h, p, n, s);
}

extern "C" int repro_ssd_bwd(int dtype, const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* ckpt,
                             const void* dy, const void* dstate, void* dx, void* ddt,
                             void* dA_part,
                             void* dB_part, void* dC_part, void* ds0, void* dB, void* dC,
                             void* dA, int b, int t, int h, int p, int n, int group,
                             void* stream) {
  if (bad_shape(b, t, h, p, n) || (dtype != 0 && dtype != 1) || group < 1 ||
      group > 8 || h % group != 0 || kChunk % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* ck = static_cast<const float*>(ckpt);
  float* ddtf = static_cast<float*>(ddt);
  double* dap = static_cast<double*>(dA_part);
  float* dbp = static_cast<float*>(dB_part);
  float* dcp = static_cast<float*>(dC_part);
  float* ds = static_cast<float*>(ds0);
  float* da = static_cast<float*>(dA);
  const float* dsf = static_cast<const float*>(dstate);
  return dtype == 0
             ? bwd<float>(x, dtf, af, Bm, Cm, ck, dy, dsf, dx, ddtf, dap, dbp, dcp, ds, dB,
                          dC, da, b, t, h, p, n, group, s)
             : bwd<bf16>(x, dtf, af, Bm, Cm, ck, dy, dsf, dx, ddtf, dap, dbp, dcp, ds, dB,
                         dC, da, b, t, h, p, n, group, s);
}
