// The WKV6 recurrence of RWKV6 ("Finch") for Hopper (sm_90a), forward and a
// deterministic backward, both in the chunked matmul form on tensor cores.
//
// The forward replaces the TPU kernel in src/repro/kernels/rwkv6_scan.py:
//   wkv6_pallas (_wkv6_kernel, pl.pallas_call at :110)
// and computes what its body computes, per batch row b and head h:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T          (D x D, f32)
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)       (written in r's dtype)
// with r, k, v read in their dtype (f32 or bf16), w and u in f32 and the
// state in f32.  Unlike the Pallas kernel, which asserts a zero initial
// state, it starts from a given state s0 (null: zero).  The reference has no
// backward kernel (JAX differentiates the jnp chunked version); this one
// gives dr, dk, dv, dw, du and d(s0), none through the final state.
//
// The chunk form.  A chunk of kChunk = 64 tokens is cut into kNs = 4
// sub-blocks of 16.  Per channel, l_t and lp_t are the inclusive and
// exclusive sums of log w over the token's own sub-block (in f64), tot_I the
// sub-block's total and B_I the sum of the totals before sub-block I, so
// that the decay between tokens j < i is e^{lp_i - l_j} inside one sub-block
// and e^{lp_i} gam[I][J] e^{tot_J - l_j} across sub-blocks J < I, with
// gam[I][J] = e^{B_I - B_{J+1}}.  With a = r e^{lp} and kk = k e^{tot - l}
// (both factors <= 1) and S0 the chunk's start state:
//   A_IJ = (a_I gam[I][J]) kk_J^T      (J < I; the diagonal as below)
//   y    = (A + diag(r . u k)) v + (a_I e^{B_I}) S0
//   S1   : S <- e^{tot_J} S + kk_J^T v_J for J = 0..3, from S = S0
// The diagonal sub-blocks are the one place where the TPU kernel's
// factorisation needs a positive exponent (there e^{-tot}; the TPU kernel
// re-centres at the chunk's end and relies on the model's clip w >= e^-e).
// Here a channel whose sub-block total is at least -kSafe = -60 takes the
// factorised diagonal (a e^{-tot}) kk^T, every factor within e^{+-60};
// any other channel's diagonal entries are taken exactly, as the product of
// the decays between the two tokens, on the CUDA cores (a path that inputs
// under the model's clip never take).  No exponent exceeds 60 anywhere, so
// every w the wrapper takes, down to the plain version's clamp at 1e-30,
// gives finite results.
//
// The backward has G, the gradient on a chunk's end state (0 after the
// last), S0 from the forward's saved states (no decay is ever divided out),
// dA_ij = dy_i . v_j below the diagonal and dbeta_i = dy_i . v_i:
//   dv   = (A + diag(beta))^T dy + (kk e^{Ltot - B_{J+1}}) G
//   drA  : P = dy S0^T, then P <- e^{tot_J} P + dA_IJ kk_J for J = 0..I-1,
//          the diagonal J = I as in the forward; drA = e^{lp} P
//   dkA  : Q <- e^{tot_I} Q + dA_IJ^T a_I for I = 3..J+1, the diagonal;
//          dkA = e^{tot - l} Q
//   dkS  = e^{tot - l} e^{Ltot - B_{J+1}} (v G^T)
//   dr   = drA + u k dbeta,   dk = dkA + dkS + u r dbeta,   du = sum dbeta r k
//   da_t = sum_{s>t} (r drA - k dkA)_s - (k dkA)_t + sum_{s<t} (k dkS)_s
//          + e^{Ltot} <G, S0>_row;   dw = da / w (0 where w <= 1e-30)
//   G    : G_{c-1} = e^{Ltot_c} G_c + dG_c, dG_c = sum_I e^{B_I} a_I^T dy_I
// (drA holds the state term too).  The Horner forms scale an accumulator's
// columns between products, so no operand needs a per-(I, J) factor; the
// factorised diagonal enters as P <- e^{-tot} (e^{tot} P + dA_II kk_I),
// with the channels past kSafe masked out of kk there and added exactly.
// Each per-token sum runs over one chunk, the state terms from the back
// (r drA) or the front (k dkS), so no sum takes the difference of two whole-
// chunk totals.  The log sums and these scans run in f64 on the f32 route,
// in f32 on the bf16 route (16 and 64 terms).  kernels/ref.py mirrors all of
// this plainly (wkv6_chunked_form, wkv6_chunked_form_grads).
//
// Bound: at rwkv6-3b's training shape (B 4, T 512, 40 heads of 64, bf16
// r/k/v, f32 w) the forward must move ~66 MB and the backward ~115 MB,
// ~0.020 and ~0.034 ms at 3.35 TB/s; the chunk form's products take a few
// GFLOP of tensor-core work, so both are bound by bytes on paper.  What
// bounds them is latency: a chain over the chunks of each (b, h), walked in
// order or in reverse, the per-token exponentials, and only 160 (b, h) pairs
// for 132 SMs.  The design answers in two ways.  The forward runs one
// block per (b, h), two of them fitting an SM (cutting the value columns
// across kSplit = 2 or 4 blocks, each recomputing the chunk's decays and A,
// measures slower: tools/wkv6_variants.py).  The backward keeps nothing on a chain of chunks but an elementwise one: a
// kernel with one block per chunk, (nc, H, B) of them at once, computes each
// chunk's dG_c and e^{Ltot_c}; one thread per state element then runs G's
// chain over the chunks (an FMA per chunk), leaving G at every chunk's end;
// a last kernel, again one block per chunk, computes everything else from
// that chunk's S0 and G, so no sum over the value columns crosses a block
// and no chunk waits for another.
//
// Design.  Forward and the backward's dG kernel: one block of 4 warps per
// (b, h) or per (chunk, h, b); warp w owns rows 16w..16w+15
// of every product: tokens of sub-block w, or channels 16w.. for the state,
// whose slice lives in registers in the m16n8 accumulator layout.  The
// backward's chunk kernel: one block of 8 warps per (chunk, h, b); warps w
// and w + 4 own the rows of sub-block w & 3, warp w for dv, warp w + 4 for
// drA, dkA and dkS; then each warp takes 8 channels for the scans, eight
// lanes a channel and eight tokens a lane, the sums kept channel-major so
// that a column read misses few banks.
// Heads under 64 are zero-padded to 64 in shared memory, and the ragged
// last chunk is zero-filled (w = 1 there, so padded tokens add nothing).
// - bf16 route (the training path): every product is mma.sync m16n8k16
//   (bf16 in, f32 accumulate), exact operands (r, k, v, dy) read with
//   ldmatrix from XOR-swizzled 64 x 64 tiles; f32 operands (the decayed
//   r and k, the states, A and dA from accumulator registers) enter as hi +
//   lo bf16 pairs and cost two passes.  The forward reads its decayed
//   operands from f32 tables, scaled as the fragments load; the chunk
//   kernel splits them into hi + lo tiles once per chunk.
// - f32 route: the same chunk form in exact f32 FMAs on the CUDA cores (not
//   on the training path).
// - Forward: r, k of chunk c + 1 and v (double-buffered) are copied with
//   cp.async, and its decays read into registers, under chunk c's
//   products; 3 barriers per chunk.  The chunk-start states (every 64
//   tokens) are written only when asked (save).
// - du per (b, h, chunk), summed over the batch and the chunks in a fixed
//   order by a last small kernel.  No atomics anywhere: the same inputs give the
//   same bits.  CUDA launches per call: forward 1, backward 4.
//
// Instantiations: wkv6_fwd_kernel, wkv6_bwd_state_part_kernel and
// wkv6_bwd_chunk_kernel for bf16 and float; the elementwise
// wkv6_bwd_state_scan and wkv6_bwd_du_sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 64;    // tokens per chunk; the state-save interval
constexpr int kSub = 16;      // tokens per sub-block: one warp's rows
constexpr int kNs = kChunk / kSub;
constexpr int kDim = 64;      // heads are zero-padded to this
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kF32Stride = kDim + 1;
constexpr int kTab = kDim + 8;   // f32 table rows: float2 fragment loads miss no bank
constexpr int kTS = kDim + 1;    // channel-major f32 tables: a column read misses no bank
constexpr float kSafe = 60.f;    // a sub-block total down to -kSafe: factorised diagonal
constexpr double kLog2e = 1.4426950408889634;
constexpr double kSafeLog2 = kSafe * kLog2e;   // the same, in log2 units
constexpr unsigned kFull = 0xffffffffu;
// the lo halves of split operands take their own mma pass (off: f32
// operands rounded once to bf16; tools/wkv6_variants.py times both)
constexpr bool kLoPass = true;
// the bf16 forward's blocks per (b, h), each owning kDim / kSplit value
// columns (1 measures fastest; tools/wkv6_variants.py times 2 and 4 at a
// head of 64, the only size at which a larger split is whole)
constexpr int kSplit = 1;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------- //
// tiles and tables
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

// elements (r, c) and (r, c + 1), c even
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

// elements (o, k) and (o, k + 1) of a logical matrix held in an f32 table
// as [o][k] (KF) or as [k][o]; k even
template <bool KF>
__device__ __forceinline__ float2 tab_pair(const float* t, int stride, int o, int k) {
  if (KF) return *reinterpret_cast<const float2*>(t + o * stride + k);
  return make_float2(t[k * stride + o], t[(k + 1) * stride + o]);
}
template <bool KF>
__device__ __forceinline__ float tab_at(const float* t, int stride, int o, int k) {
  return KF ? t[o * stride + k] : t[k * stride + o];
}

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
// wait for the grid this one was launched behind (programmatic dependent
// launch): its blocks start while that grid ends
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, rows) x cols [0, width) of a strided matrix at src + base, zero
// elsewhere; 16-byte groups when ``vec`` (width % 8 == 0, aligned rows)
__device__ __forceinline__ void stage(TileB& dst, const bf16* src, size_t base,
                                      size_t stride, int rows, int width, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kDim * 8; idx += blockDim.x) {
      const int r = idx >> 3, c = (idx & 7) << 3;
      const bool ok = r < rows && c < width;
      cp16(&dst.v[swz(r, c)], ok ? src + base + r * stride + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kDim * kDim; idx += blockDim.x) {
      const int r = idx >> 6, c = idx & 63;
      dst.v[swz(r, c)] = (r < rows && c < width) ? src[base + r * stride + c]
                                                 : __float2bfloat16(0.f);
    }
  }
}
__device__ __forceinline__ void stage(TileF& dst, const float* src, size_t base,
                                      size_t stride, int rows, int width, bool) {
  for (int idx = threadIdx.x; idx < kDim * kDim; idx += blockDim.x) {
    const int r = idx >> 6, c = idx & 63;
    const bool ok = r < rows && c < width;
    cp4(&dst.v[fidx(r, c)], ok ? src + base + r * stride + c : src, ok);
  }
}

// ---------------------------------------------------------------------- //
// tensor-core fragments (bf16 route)
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
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (rows m0.., cols k0..k0+15) of a tile holding A as [m][k]
// (KF: k is the fast index) or as [k][m]: register r holds (m0 + g + 8 (r &
// 1), k0 + 2q + 8 (r >> 1)) and the next k, g = lane / 4, q = lane % 4.
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
// The B fragments of n-tiles n0 and n0 + 8, rows k0..: register 2t + rr
// holds (k0 + 2q + 8 rr and the next k, n0 + 8t + g), of a tile holding B as
// [n][k] (KF) or as [k][n].
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

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---------------------------------------------------------------------- //
// operands.  Each gives the bf16 route its fragments (frag: hi, and lo where
// kSplit) and the f32 route its elements (rows: A(r0, k), A(r0 + 8, k);
// at: B(k, n)).  Kinds: an exact tile; an f32 table, scaled per k (A) or
// per n (B); a split tile (hi + lo), scaled per k (A) or masked per n (B);
// accumulator registers (A only).
// ---------------------------------------------------------------------- //

template <bool KF> struct ExA {          // exact bf16 tile
  const bf16* t;
  static constexpr bool kSplit = false, kRegs = false;
  __device__ void frag(uint32_t (&hi)[4], uint32_t (&)[4], int m0, int k0, int lane) const {
    load_a<KF>(hi, t, m0, k0, lane);
  }
};
template <bool KF> struct ExB {
  const bf16* t;
  static constexpr bool kSplit = false;
  __device__ void frag(uint32_t (&hi)[4], uint32_t (&)[4], int n0, int k0, int lane) const {
    load_b<KF>(hi, t, n0, k0, lane);
  }
};
template <bool KF> struct ExAF {         // exact f32 tile
  const TileF* t;
  static constexpr bool kRegs = false;
  __device__ void rows(float& a0, float& a1, int r0, int k, int) const {
    a0 = KF ? get(*t, r0, k) : get(*t, k, r0);
    a1 = KF ? get(*t, r0 + 8, k) : get(*t, k, r0 + 8);
  }
};
template <bool KF> struct ExBF {
  const TileF* t;
  __device__ float at(int k, int n) const { return KF ? get(*t, n, k) : get(*t, k, n); }
};

// an f32 table (row stride ``stride``), times s[k] (A) or s[n] (B) if s
template <bool KF> struct TabA {
  const float* t;
  int stride;
  const float* s;
  static constexpr bool kSplit = true, kRegs = false;
  __device__ void frag(uint32_t (&hi)[4], uint32_t (&lo)[4], int m0, int k0, int lane) const {
    const int g = lane >> 2, k = k0 + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = k + (r >> 1) * 8;
      float2 v = tab_pair<KF>(t, stride, m0 + g + (r & 1) * 8, kk);
      if (s != nullptr) {
        v.x *= s[kk];
        v.y *= s[kk + 1];
      }
      split2(v.x, v.y, hi[r], lo[r]);
    }
  }
  __device__ void rows(float& a0, float& a1, int r0, int k, int) const {
    const float sc = s != nullptr ? s[k] : 1.f;
    a0 = tab_at<KF>(t, stride, r0, k) * sc;
    a1 = tab_at<KF>(t, stride, r0 + 8, k) * sc;
  }
};
template <bool KF> struct TabB {
  const float* t;
  int stride;
  const float* s;
  static constexpr bool kSplit = true;
  __device__ void frag(uint32_t (&hi)[4], uint32_t (&lo)[4], int n0, int k0, int lane) const {
    const int g = lane >> 2, k = k0 + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + (r >> 1) * 8 + g, kk = k + (r & 1) * 8;
      float2 v = tab_pair<KF>(t, stride, n, kk);
      if (s != nullptr) {
        v.x *= s[n];
        v.y *= s[n];
      }
      split2(v.x, v.y, hi[r], lo[r]);
    }
  }
  __device__ float at(int k, int n) const {
    return tab_at<KF>(t, stride, n, k) * (s != nullptr ? s[n] : 1.f);
  }
};

// a split tile (hi + lo), as [m][k] (KF) or [k][m], times s[k] if s
template <bool KF> struct SpA {
  const bf16* hi;
  const bf16* lo;
  const float* s;
  static constexpr bool kSplit = true, kRegs = false;
  __device__ void frag(uint32_t (&h)[4], uint32_t (&l)[4], int m0, int k0, int lane) const {
    load_a<KF>(h, hi, m0, k0, lane);
    load_a<KF>(l, lo, m0, k0, lane);
    if (s == nullptr) return;
    const int k = k0 + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = k + (r >> 1) * 8;
      const float2 a = unpack(h[r]), b = unpack(l[r]);
      split2((a.x + b.x) * s[kk], (a.y + b.y) * s[kk + 1], h[r], l[r]);
    }
  }
};
// a split tile as [n][k] (KF) or [k][n]; columns n where mask[n] == 0 read
// as zero (mask: 0 or 1)
template <bool KF> struct SpB {
  const bf16* hi;
  const bf16* lo;
  const float* mask;
  static constexpr bool kSplit = true;
  __device__ void frag(uint32_t (&h)[4], uint32_t (&l)[4], int n0, int k0, int lane) const {
    load_b<KF>(h, hi, n0, k0, lane);
    load_b<KF>(l, lo, n0, k0, lane);
    if (mask == nullptr) return;
    const int g = lane >> 2;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (mask[n0 + (r >> 1) * 8 + g] == 0.f) h[r] = l[r] = 0u;
    }
  }
};
template <bool KF> struct SpAF {
  const TileF* t;
  const float* s;
  static constexpr bool kRegs = false;
  __device__ void rows(float& a0, float& a1, int r0, int k, int) const {
    const float sc = s != nullptr ? s[k] : 1.f;
    a0 = (KF ? get(*t, r0, k) : get(*t, k, r0)) * sc;
    a1 = (KF ? get(*t, r0 + 8, k) : get(*t, k, r0 + 8)) * sc;
  }
};
template <bool KF> struct SpBF {
  const TileF* t;
  const float* mask;
  __device__ float at(int k, int n) const {
    return (KF ? get(*t, n, k) : get(*t, k, n)) * (mask != nullptr ? mask[n] : 1.f);
  }
};

// a 16 x 64 f32 strip in the caller's accumulator registers, as [m][k]
struct Regs {
  const float (*v)[4];
  static constexpr bool kSplit = true, kRegs = true;
  __device__ void frag(uint32_t (&hi)[4], uint32_t (&lo)[4], int, int k0, int) const {
    const int c = k0 >> 3;
    split2(v[c][0], v[c][1], hi[0], lo[0]);
    split2(v[c][2], v[c][3], hi[1], lo[1]);
    split2(v[c + 1][0], v[c + 1][1], hi[2], lo[2]);
    split2(v[c + 1][2], v[c + 1][3], hi[3], lo[3]);
  }
  // A(row, k) lives in lane (lane & ~3) | (k & 7) / 2 of the row's quad (the
  // f32 route indexes the strip at run time, so it lives in local memory)
  __device__ void rows(float& a0, float& a1, int, int k, int lane) const {
    const int src = (lane & ~3) | ((k & 7) >> 1);
    a0 = __shfl_sync(kFull, v[k >> 3][k & 1], src);
    a1 = __shfl_sync(kFull, v[k >> 3][2 + (k & 1)], src);
  }
};

// the operand makers, by route
template <bool KF> __device__ __forceinline__ ExA<KF> ex_a(const TileB& t) { return {t.v}; }
template <bool KF> __device__ __forceinline__ ExAF<KF> ex_a(const TileF& t) { return {&t}; }
template <bool KF> __device__ __forceinline__ ExB<KF> ex_b(const TileB& t) { return {t.v}; }
template <bool KF> __device__ __forceinline__ ExBF<KF> ex_b(const TileF& t) { return {&t}; }
template <bool KF>
__device__ __forceinline__ SpA<KF> sp_a(const SplitB& t, const float* s) {
  return {t.hi.v, t.lo.v, s};
}
template <bool KF>
__device__ __forceinline__ SpAF<KF> sp_a(const TileF& t, const float* s) {
  return {&t, s};
}
template <bool KF>
__device__ __forceinline__ SpB<KF> sp_b(const SplitB& t, const float* mask) {
  return {t.hi.v, t.lo.v, mask};
}
template <bool KF>
__device__ __forceinline__ SpBF<KF> sp_b(const TileF& t, const float* mask) {
  return {&t, mask};
}

// acc (16 x 8 NT, the warp's rows m0.., columns n0..) += A B over the
// 16-wide k blocks inside [k_lo, k_hi)
template <typename T, int NT, class OA, class OB>
__device__ __forceinline__ void product(float (*acc)[4], const OA& A, const OB& B, int m0,
                                        int k_lo, int k_hi, int n0, int lane) {
#pragma unroll
  for (int kb = 0; kb < kDim / 16; ++kb) {
    const int k0 = kb * 16;
    if (k0 < k_lo || k0 >= k_hi) continue;
    if constexpr (std::is_same<T, bf16>::value) {
      // every fragment first, then the passes over all n-tiles in turn, so
      // that the products into one accumulator are NT apart
      uint32_t ah[4], al[4], bh[NT / 2][4], bl[NT / 2][4];
      A.frag(ah, al, m0, k0, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) B.frag(bh[np], bl[np], n0 + 16 * np, k0, lane);
      // n-tile nt's B fragment: registers 2 (nt & 1) and 2 (nt & 1) + 1 of pair nt / 2
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma(acc[nt], ah, bh[nt >> 1][2 * (nt & 1)], bh[nt >> 1][2 * (nt & 1) + 1]);
      }
      if constexpr (OA::kSplit && kLoPass) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma(acc[nt], al, bh[nt >> 1][2 * (nt & 1)], bh[nt >> 1][2 * (nt & 1) + 1]);
        }
      }
      if constexpr (OB::kSplit && kLoPass) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma(acc[nt], ah, bl[nt >> 1][2 * (nt & 1)], bl[nt >> 1][2 * (nt & 1) + 1]);
        }
      }
    } else {
      const int r0 = m0 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll 1
      for (int kk = 0; kk < 16; ++kk) {
        float a0, a1;
        A.rows(a0, a1, r0, k0 + kk, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bv = B.at(k0 + kk, n0 + nt * 8 + c0 + e);
            acc[nt][e] = fmaf(a0, bv, acc[nt][e]);
            acc[nt][2 + e] = fmaf(a1, bv, acc[nt][2 + e]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// shared pieces
// ---------------------------------------------------------------------- //

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
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

template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[NT][4], float s0, float s1) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] *= s0;
    acc[nt][1] *= s0;
    acc[nt][2] *= s1;
    acc[nt][3] *= s1;
  }
}
// acc *= the f32 table's elements (row, col), times s[col] if s
template <int NT>
__device__ __forceinline__ void scale_by(float (&acc)[NT][4], const float* tab,
                                         const float* s, int m0, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = frag_row(m0, lane, e), c = frag_col(nt, lane, e);
      acc[nt][e] *= tab[r * kTab + c] * (s != nullptr ? s[c] : 1.f);
    }
  }
}

template <int NT>
__device__ __forceinline__ void scale_cols(float (&acc)[NT][4], const float* s, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= s[frag_col(nt, lane, e)];
  }
}

// the warp's strip to a channel-major table: element (row, col) at
// tab[col * kTS + row]
template <int NT>
__device__ __forceinline__ void put_tab_t(float* tab, const float (&acc)[NT][4], int m0,
                                          int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tab[frag_col(nt, lane, e) * kTS + frag_row(m0, lane, e)] = acc[nt][e];
    }
  }
}

template <int NT>
__device__ __forceinline__ void put_tab(float* tab, int stride, const float (&acc)[NT][4],
                                        int m0, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = frag_row(m0, lane, e), c = frag_col(nt, lane, e);
      *reinterpret_cast<float2*>(tab + r * stride + c) = make_float2(acc[nt][e], acc[nt][e + 1]);
    }
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
template <typename T, int NT>
__device__ __forceinline__ void write_acc(T* dst, size_t stride, const float (&acc)[NT][4],
                                          int rows, int width, int m0, int lane) {
  const bool pair = ((width | stride) & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
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
template <int NT>
__device__ __forceinline__ void read_acc(float (&acc)[NT][4], const float* src, size_t stride,
                                         int rows, int width, int m0, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = frag_row(m0, lane, e), c = frag_col(nt, lane, e);
      acc[nt][e] = (src != nullptr && r < rows && c < width) ? src[r * stride + c] : 0.f;
    }
  }
}

// what both kernels compute of a chunk's decays, per channel
struct Decays {
  double tot[kNs][kDim];           // sub-block totals of log2 w
  float gam[kNs][kNs][kDim];       // e^{B_I - B_{J+1}} (J < I); [I][I]: e^{-tot_I} or 0
  float eB[kNs][kDim];             // e^{B_I}
  float etot[kNs][kDim];           // e^{tot_I}
  float delta[kNs][kDim];          // e^{Ltot - B_{J+1}}
  float eLtot[kDim];               // e^{Ltot}
  float ad[kNs][kSub][kSub];       // the exact diagonal of channels past kSafe
  float beta[kChunk];
  float u[kDim];
};

// w of token t (of the chunk) and channel ch, 1 past the chunk's rows and
// past the head
__device__ __forceinline__ float w_at(const float* wcol, size_t stride, int t, int rows,
                                      bool live) {
  return (live && t < rows) ? wcol[t * stride] : 1.f;
}
// the decay between tokens j < i of one sub-block, as the product of the
// decays between them (the exact diagonal)
__device__ __forceinline__ float decay_between(const float* wcol, size_t stride, int t0,
                                               int j, int i, int rows) {
  float p = 1.f;
  for (int t = j + 1; t < i; ++t) p *= fmaxf(w_at(wcol, stride, t0 + t, rows, true), 1e-30f);
  return p;
}

// The decays thread (ch, hf) of a block of NTH threads works on: channel ch,
// sub-blocks PER hf.. (PER = 2 for 128 threads, 1 for 256), 1 past the
// chunk's rows and past the head
template <int NTH>
struct WLoad {
  static constexpr int PER = kNs * kDim / NTH;
  float v[PER][kSub];
  __device__ __forceinline__ void load(const float* w, size_t wbase, size_t stride, int rows,
                                       int d) {
    const int ch = threadIdx.x & 63, I0 = PER * (threadIdx.x >> 6);
    const float* wcol = w + wbase + ch;
#pragma unroll
    for (int s = 0; s < PER; ++s) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = (I0 + s) * kSub + j;
        v[s][j] = (I0 + s >= kNs || t >= rows || ch >= d) ? 1.f : wcol[t * stride];
      }
    }
  }
};

// Phase 1 of a chunk, for a block of NTH threads: thread (ch, hf) sums log2
// w over 2 (NTH = 128) or 1 (NTH = 256) sub-blocks of channel ch in f64 (its
// decays are loaded at once) and writes e^{lp} (times r when ``r_tile``)
// and e^{tot - l} (times k; none without ``tk``) to the tables; returns
// whether one of its sub-blocks is past kSafe.  With BONUS also the partial
// sums of the bonus r . (u k) over NTH / 64 slices of the channels.
template <int NTH, bool BONUS, class Tile, class Split = TileF, class DC = Decays>
__device__ __forceinline__ bool decays_tables(DC& dc, float* ta, float* tk,
                                              const Tile* r_tile, const Tile* k_tile,
                                              const Tile& r, const Tile& k,
                                              const WLoad<NTH>& wl, Split* sa = nullptr,
                                              Split* sk = nullptr) {
  constexpr int PER = WLoad<NTH>::PER;
  // the log sums in f64 for the f32 route, in f32 for bf16 (16 tokens,
  // exponents at most ~87 where the factors are not negligible)
  using Acc = typename std::conditional<std::is_same<Tile, TileB>::value, float, double>::type;
  const int ch = threadIdx.x & 63, hf = threadIdx.x >> 6;
  const int I0 = PER * hf;
  const auto& wv = wl.v;
  Acc l[PER], lr[PER][kSub];
#pragma unroll
  for (int s = 0; s < PER; ++s) l[s] = 0;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int t = (I0 + s) * kSub + j;
      const float f = exp2f(static_cast<float>(l[s]));
      if (I0 + s < kNs) {
        if (ta != nullptr) ta[t * kTab + ch] = r_tile != nullptr ? f * get(*r_tile, t, ch) : f;
        if (sa != nullptr) {   // pairs of channels from neighbouring lanes
          const float x = f * get(r, t, ch), y = __shfl_down_sync(kFull, x, 1);
          if (!(ch & 1)) put2(*sa, t, ch, x, y);
        }
      }
      l[s] += __log2f(fmaxf(wv[s][j], 1e-30f));
      lr[s][j] = l[s];
    }
  }
  bool unsafe = false;
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int I = I0 + s;
    if (I >= kNs) continue;
    if (tk != nullptr) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = I * kSub + j;
        const float f = exp2f(static_cast<float>(l[s] - lr[s][j]));
        tk[t * kTab + ch] = k_tile != nullptr ? f * get(*k_tile, t, ch) : f;
        if (sk != nullptr) {
          const float x = f * get(k, t, ch), y = __shfl_down_sync(kFull, x, 1);
          if (!(ch & 1)) put2(*sk, t, ch, x, y);
        }
      }
    }
    dc.tot[I][ch] = l[s];
    unsafe |= l[s] < -kSafeLog2;
  }
  if (BONUS) {   // the bonus r_j . (u k_j): warp w takes tokens w, w + NTH / 32, ...
    const int lane = threadIdx.x & 31;
    const float u0 = dc.u[lane], u1 = dc.u[lane + 32];
    for (int j = threadIdx.x >> 5; j < kChunk; j += NTH / 32) {
      float acc = get(r, j, lane) * u0 * get(k, j, lane) +
                  get(r, j, lane + 32) * u1 * get(k, j, lane + 32);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) dc.beta[j] = acc;
    }
  }
  return unsafe;
}

// Phase 2: threads 0..63 the per-channel factors; then, when a sub-block is
// past kSafe, every thread the exact diagonal
template <int NTH, class Tile>
__device__ __forceinline__ void decays_factors(Decays& dc, const Tile& r, const Tile& k,
                                               const float* w, size_t wbase, size_t stride,
                                               int rows, int d, bool any_unsafe) {
  if (threadIdx.x < kDim) {
    const int ch = threadIdx.x;
    double B[kNs + 1];
    B[0] = 0.0;
#pragma unroll
    for (int I = 0; I < kNs; ++I) B[I + 1] = B[I] + dc.tot[I][ch];
#pragma unroll
    for (int I = 0; I < kNs; ++I) {
      const double tot = dc.tot[I][ch];
      dc.eB[I][ch] = exp2f(static_cast<float>(B[I]));
      dc.etot[I][ch] = exp2f(static_cast<float>(tot));
      dc.delta[I][ch] = exp2f(static_cast<float>(B[kNs] - B[I + 1]));
#pragma unroll
      for (int J = 0; J < I; ++J) dc.gam[I][J][ch] = exp2f(static_cast<float>(B[I] - B[J + 1]));
      dc.gam[I][I][ch] = tot >= -kSafeLog2 ? exp2f(static_cast<float>(-tot)) : 0.f;
    }
    dc.eLtot[ch] = exp2f(static_cast<float>(B[kNs]));
  }
  if (!any_unsafe) return;
  for (int idx = threadIdx.x; idx < kNs * kSub * kSub; idx += NTH) {
    const int I = idx / (kSub * kSub), i = (idx / kSub) % kSub, j = idx % kSub;
    float acc = 0.f;
    if (j < i) {
      for (int ch = 0; ch < d; ++ch) {
        if (dc.tot[I][ch] >= -kSafeLog2) continue;
        acc += get(r, I * kSub + i, ch) * get(k, I * kSub + j, ch) *
               decay_between(w + wbase + ch, stride, I * kSub, j, i, rows);
      }
    }
    dc.ad[I][i][j] = acc;
  }
}

// A's row block I in the warp's registers (columns j < 16 (I + 1) of the
// chunk): the factorised products, the strict lower mask, the exact
// diagonal of channels past kSafe, the bonus on the diagonal
template <typename T, class MakeA, class MakeB>
__device__ __forceinline__ void scores(float (&A)[8][4], const Decays& dc, int I,
                                       bool any_unsafe, MakeA make_a, MakeB make_b,
                                       int lane) {
  const int m0 = I * kSub;
  zero(A);
#pragma unroll
  for (int J = 0; J < kNs; ++J) {
    if (J <= I) {
      product<T, 2>(A + 2 * J, make_a(dc.gam[I][J]), make_b(), m0, 0, kDim, J * kSub, lane);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = frag_row(m0, lane, e), j = frag_col(nt, lane, e);
      float a = 0.f;
      if (j < i) {
        a = A[nt][e];
        if (any_unsafe && j >= m0) a += dc.ad[I][i - m0][j - m0];
      } else if (j == i) {
        a = dc.beta[i];
      }
      A[nt][e] = a;
    }
  }
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

// the forward's blocks per (b, h) and value columns per block
template <typename T>
constexpr int kFwdSplit = std::is_same<T, bf16>::value ? kSplit : 1;
template <typename T>
constexpr int kFwdCols = kDim / kFwdSplit<T>;

template <typename T, int E = kFwdCols<T>>
struct FwdSmem {
  typename Route<T>::Exact r, k, v[2];
  float a[kDim * kTab];    // r e^{lp}
  float kk[kDim * kTab];   // k e^{tot - l}
  float s[kDim * (E + 8)]; // the chunk's start state, this block's columns
  Decays dc;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0,   // or null
                T* __restrict__ y, float* __restrict__ s_out,
                float* __restrict__ ckpt,       // (B, H, nc, D, D) or null
                int t_len, int heads, int d, int vec) {
  constexpr int E = kFwdCols<T>, NT = E / 8, GS = E + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<T>& sm = *reinterpret_cast<FwdSmem<T>*>(smem_raw);
  Decays& dc = sm.dc;
  const int h = blockIdx.x / kFwdSplit<T>, e0 = (blockIdx.x % kFwdSplit<T>) * E;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m0 = warp * 16;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const size_t dd = static_cast<size_t>(d) * d, stride = static_cast<size_t>(heads) * d;
  const int nc = (t_len + kChunk - 1) / kChunk;
  const int ecols = min(E, d - e0);
  if (threadIdx.x < kDim) dc.u[threadIdx.x] = threadIdx.x < d ? u[h * d + threadIdx.x] : 0.f;

  float S[NT][4];   // rows: channels m0.., columns: this block's value columns
  read_acc(S, s0 == nullptr ? nullptr : s0 + bh * dd + e0, d, d, ecols, m0, lane);

  auto base = [&](int c) { return (static_cast<size_t>(b) * t_len + c * kChunk) * stride + h * d; };
  auto rows_of = [&](int c) { return min(kChunk, t_len - c * kChunk); };
  auto copy_rkv = [&](int c) {
    stage(sm.r, r, base(c), stride, rows_of(c), d, vec);
    stage(sm.k, k, base(c), stride, rows_of(c), d, vec);
    stage(sm.v[c & 1], v, base(c) + e0, stride, rows_of(c), ecols, vec);
    cp_commit();
  };
  copy_rkv(0);
  WLoad<kThreads> wl;   // the chunk's decays, loaded a chunk ahead
  wl.load(w, base(0), stride, rows_of(0), d);

  for (int c = 0; c < nc; ++c) {
    const int rows = rows_of(c), buf = c & 1;
    cp_wait<0>();
    __syncthreads();   // chunk c staged; the previous chunk's products are done
    if (ckpt != nullptr) write_acc(ckpt + (bh * nc + c) * dd + e0, d, S, d, ecols, m0, lane);
    put_tab(sm.s, GS, S, m0, lane);
    const bool unsafe = decays_tables<kThreads, true>(dc, sm.a, sm.kk, &sm.r, &sm.k, sm.r,
                                                      sm.k, wl);
    const bool any_unsafe = __syncthreads_or(unsafe);
    decays_factors<kThreads>(dc, sm.r, sm.k, w, base(c), stride, rows, d, any_unsafe);
    __syncthreads();   // the tables are in; r and k are free
    if (c + 1 < nc) {
      copy_rkv(c + 1);
      wl.load(w, base(c + 1), stride, rows_of(c + 1), d);
    }

    // y for the warp's tokens: A v + (a e^{B_I}) S0
    const int I = warp;
    if (I < kNs) {
      float A[8][4];
      scores<T>(A, dc, I, any_unsafe,
                [&](const float* s) { return TabA<true>{sm.a, kTab, s}; },
                [&]() { return TabB<true>{sm.kk, kTab, nullptr}; }, lane);
      float Y[NT][4];
      zero(Y);
      product<T, NT>(Y, TabA<true>{sm.a, kTab, dc.eB[I]}, TabB<false>{sm.s, GS, nullptr}, m0,
                     0, kDim, 0, lane);
      product<T, NT>(Y, Regs{A}, ex_b<false>(sm.v[buf]), m0, 0, (I + 1) * kSub, 0, lane);
      write_acc(y + base(c) + e0, stride, Y, rows, ecols, m0, lane);
    }

    // the state, sub-block by sub-block: S <- e^{tot_J} S + kk_J^T v_J
    const int ch0 = frag_row(m0, lane, 0);
#pragma unroll
    for (int J = 0; J < kNs; ++J) {
      scale_rows(S, dc.etot[J][ch0], dc.etot[J][ch0 + 8]);
      product<T, NT>(S, TabA<false>{sm.kk, kTab, nullptr}, ex_b<false>(sm.v[buf]), m0,
                     J * kSub, (J + 1) * kSub, 0, lane);
    }
  }
  write_acc(s_out + bh * dd + e0, d, S, d, ecols, m0, lane);
}

// ---------------------------------------------------------------------- //
// backward, part 1: the state gradient G at every chunk's end
// ---------------------------------------------------------------------- //

// G obeys G_{c-1} = e^{Ltot_c} G_c + dG_c over the chunks in reverse (G at
// the last chunk's end is 0), with dG_c = sum_I e^{B_I} (r e^{lp})_I^T dy_I
// local to chunk c.  This kernel computes dG_c and e^{Ltot_c} for every
// chunk at once (Horner over the sub-blocks, X <- e^{tot_I} X + a_I^T dy_I
// for I = 3..0); wkv6_bwd_state_scan then runs the chain elementwise.
// the part of Decays that the dG kernel reads
struct Totals {
  double tot[kNs][kDim];
  float beta[kChunk], u[kDim];
};

template <typename T>
struct BwdPartSmem {
  typename Route<T>::Exact r, dy;
  typename Route<T>::Split a;   // r e^{lp}
  Totals dc;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_state_part_kernel(const T* __restrict__ r, const float* __restrict__ w,
                           const T* __restrict__ dy,
                           float* __restrict__ dg,      // (B, H, nc, D, D)
                           float* __restrict__ eltot,   // (B, H, nc, D)
                           int t_len, int heads, int d, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdPartSmem<T>& sm = *reinterpret_cast<BwdPartSmem<T>*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m0 = warp * 16;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const size_t dd = static_cast<size_t>(d) * d, stride = static_cast<size_t>(heads) * d;
  const int nc = gridDim.x;
  const int rows = min(kChunk, t_len - c * kChunk);
  const size_t base = (static_cast<size_t>(b) * t_len + c * kChunk) * stride + h * d;
  stage(sm.r, r, base, stride, rows, d, vec);
  stage(sm.dy, dy, base, stride, rows, d, vec);
  cp_commit();
  WLoad<kThreads> wl;
  wl.load(w, base, stride, rows, d);
  cp_wait<0>();
  __syncthreads();   // staged
  decays_tables<kThreads, false>(sm.dc, nullptr, nullptr,
                                 static_cast<const typename Route<T>::Exact*>(nullptr),
                                 static_cast<const typename Route<T>::Exact*>(nullptr), sm.r,
                                 sm.r, wl, &sm.a);
  __syncthreads();   // the table and the totals are in
  const int ch = frag_row(m0, lane, 0);
  float X[8][4];   // rows: channels m0.., columns: value columns
  zero(X);
#pragma unroll
  for (int I = kNs - 1; I >= 0; --I) {
    scale_rows(X, exp2f(static_cast<float>(sm.dc.tot[I][ch])),
               exp2f(static_cast<float>(sm.dc.tot[I][ch + 8])));
    product<T, 8>(X, sp_a<false>(sm.a, nullptr), ex_b<false>(sm.dy), m0, I * kSub,
                  (I + 1) * kSub, 0, lane);
  }
  write_acc(dg + (bh * nc + c) * dd, d, X, d, d, m0, lane);
  if (threadIdx.x < d) {
    double lt = 0.0;
#pragma unroll
    for (int I = 0; I < kNs; ++I) lt += sm.dc.tot[I][threadIdx.x];
    eltot[(bh * nc + c) * d + threadIdx.x] = exp2f(static_cast<float>(lt));
  }
}

// G_c at every chunk's end, in place of dG_c: one thread per state element
// (b, h, i, e) walking the chunks in reverse from the final state's gradient
// (dstate; null is zero); the last G to ds0
__global__ void wkv6_bwd_state_scan(float* __restrict__ g, const float* __restrict__ eltot,
                                    const float* __restrict__ dstate,
                                    float* __restrict__ ds0, int nc, int d, size_t elems) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  wait_prior_grid();
  if (idx >= elems) return;
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t bh = idx / dd, ie = idx % dd, i = ie / d;
  float acc = dstate != nullptr ? dstate[idx] : 0.f;
  // eight chunks' parts and decays read at once, then the chain through them
  for (int c1 = nc - 1; c1 >= 0; c1 -= 8) {
    float part[8], el[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int c = c1 - o;
      part[o] = c >= 0 ? g[(bh * nc + c) * dd + ie] : 0.f;
      el[o] = c >= 0 ? eltot[(bh * nc + c) * d + i] : 0.f;
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int c = c1 - o;
      if (c < 0) break;
      g[(bh * nc + c) * dd + ie] = acc;
      acc = fmaf(el[o], acc, part[o]);
    }
  }
  ds0[idx] = acc;
}

// du = sum over the batch rows and chunks of du's parts (B, H, nc, D), in
// order, one thread per (head, channel)
__global__ void wkv6_bwd_du_sum(const float* __restrict__ du_part, float* __restrict__ du,
                                int b, int nc, int h, int d) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  wait_prior_grid();
  if (idx >= h * d) return;
  const int hh = idx / d, ch = idx % d;
  float acc = 0.f;
  for (int bb = 0; bb < b; ++bb) {
    const float* part = du_part + (static_cast<size_t>(bb) * h + hh) * nc * d + ch;
    for (int c = 0; c < nc; ++c) acc += part[static_cast<size_t>(c) * d];
  }
  du[idx] = acc;
}

// ---------------------------------------------------------------------- //
// backward, part 2: every chunk at once, from its S0 and its G
// ---------------------------------------------------------------------- //

constexpr int kChunkWarps = 8;   // two warps per sub-block
constexpr int kChunkThreads = 32 * kChunkWarps;

template <typename T>
struct BwdChunkSmem {
  typename Route<T>::Exact r, k, v, dy;
  union Work {
    struct Factors {              // during the products
      typename Route<T>::Split a, kk;   // r e^{lp}, k e^{tot - l}
      typename Route<T>::Split s, g;    // S0 and G
      float ea[kDim * kTab];      // e^{lp}
      float ek[kDim * kTab];      // e^{tot - l}
    } f;
    struct Sums {                 // after, by channel: drA, dkA, then dr, dk; and r, k
      float dr[kDim * kTS], dka[kDim * kTS];
      float r[kDim * kTS], k[kDim * kTS];
    } p;
  } x;
  float dks[kDim * kTS];         // dkS by channel (written after its product), then dw
  Decays dc;
  // the diagonal sub-block's mask (1 where factorised) and, there, e^{tot}
  // and e^{-tot} (1 elsewhere)
  float mdiag[kNs][kDim], mtot[kNs][kDim], ftot[kNs][kDim];
  float dad[kNs][kSub][kSub];    // dA's diagonal blocks (for the exact diagonal)
  float dadt[kNs][kSub][kSub];   // the same, from dA^T
  float dbeta[kChunk], sigma[kDim];
  float wt[kDim * kTS];          // the chunk's decays, channel-major (for dw)
};

// One block of 8 warps per (chunk, head, batch row).  Warps w and w + 4 own
// the rows of sub-block w & 3: warp w dv, warp w + 4 drA, dkA and dkS.
// drA and dkA sum over sub-blocks by Horner's rule on the accumulators'
// columns (S <- e^{tot} S + the next sub-block's product), so every operand
// is a tile split once per chunk.
template <typename T>
__global__ void __maxnreg__(255)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ ckpt,
                      const float* __restrict__ gsave, const T* __restrict__ dy,
                      T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dw,
                      float* __restrict__ du_part,   // (B, H, nc, D)
                      int t_len, int heads, int d, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdChunkSmem<T>& sm = *reinterpret_cast<BwdChunkSmem<T>*>(smem_raw);
  Decays& dc = sm.dc;
  auto& f = sm.x.f;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Iw = warp & 3, m0 = Iw * kSub;
  const bool second = warp >= kNs;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const size_t dd = static_cast<size_t>(d) * d, stride = static_cast<size_t>(heads) * d;
  const int nc = gridDim.x;
  const int rows = min(kChunk, t_len - c * kChunk);
  const size_t base = (static_cast<size_t>(b) * t_len + c * kChunk) * stride + h * d;
  if (threadIdx.x < kDim) dc.u[threadIdx.x] = threadIdx.x < d ? u[h * d + threadIdx.x] : 0.f;
  stage(sm.r, r, base, stride, rows, d, vec);
  stage(sm.k, k, base, stride, rows, d, vec);
  stage(sm.v, v, base, stride, rows, d, vec);
  stage(sm.dy, dy, base, stride, rows, d, vec);
  cp_commit();
  WLoad<kChunkThreads> wl;
  wl.load(w, base, stride, rows, d);
  wait_prior_grid();   // G comes from the state gradient's chain
  {   // S0 and G as split tiles, two elements a lane, a row a warp; and
      // each row's <G, S0> (sigma before its e^{Ltot})
    const float* s0 = ckpt + (bh * nc + c) * dd;
    const float* g0 = gsave + (bh * nc + c) * dd;
    constexpr int kIt = kDim / kChunkWarps;
    float sv[kIt][2], gv[kIt][2];
    const int ln = threadIdx.x & 31;
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = warp + it * kChunkWarps;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int e = 2 * ln + o;
        const bool ok = i < d && e < d;
        sv[it][o] = ok ? s0[i * d + e] : 0.f;
        gv[it][o] = ok ? g0[i * d + e] : 0.f;
      }
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = warp + it * kChunkWarps;
      put2(f.s, i, 2 * ln, sv[it][0], sv[it][1]);
      put2(f.g, i, 2 * ln, gv[it][0], gv[it][1]);
      float sg = gv[it][0] * sv[it][0] + gv[it][1] * sv[it][1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sg += __shfl_xor_sync(kFull, sg, o);
      if (ln == 0) sm.sigma[i] = sg;
    }
  }
  {
    const int ch = threadIdx.x & 63, I = threadIdx.x >> 6;
#pragma unroll
    for (int j = 0; j < kSub; ++j) sm.wt[ch * kTS + I * kSub + j] = wl.v[0][j];
  }
  cp_wait<0>();
  __syncthreads();   // staged
  const bool unsafe = decays_tables<kChunkThreads, false>(
      dc, f.ea, f.ek, static_cast<const typename Route<T>::Exact*>(nullptr),
      static_cast<const typename Route<T>::Exact*>(nullptr), sm.r, sm.k, wl, &f.a, &f.kk);
  {   // the bonus r_j . (u k_j): a token a warp at a time
    const int ln = threadIdx.x & 31;
    const float u0 = dc.u[ln], u1 = dc.u[ln + 32];
    for (int jj = threadIdx.x >> 5; jj < kChunk; jj += kChunkWarps) {
      float acc = get(sm.r, jj, ln) * u0 * get(sm.k, jj, ln) +
                  get(sm.r, jj, ln + 32) * u1 * get(sm.k, jj, ln + 32);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (ln == 0) dc.beta[jj] = acc;
    }
  }
  const bool any = __syncthreads_or(unsafe);
  decays_factors<kChunkThreads>(dc, sm.r, sm.k, w, base, stride, rows, d, any);
  if (threadIdx.x < kDim) {   // sigma = e^{Ltot} <G, S0>, and the diagonal's factors
    const int ch = threadIdx.x;
    sm.sigma[ch] *= dc.eLtot[ch];
#pragma unroll
    for (int I = 0; I < kNs; ++I) {
      const bool safe = dc.tot[I][ch] >= -kSafeLog2;
      sm.mdiag[I][ch] = safe ? 1.f : 0.f;
      sm.mtot[I][ch] = safe ? dc.etot[I][ch] : 1.f;
      sm.ftot[I][ch] = safe ? dc.gam[I][I][ch] : 1.f;
    }
  }
  __syncthreads();   // the factors are in
  float P[8][4], Q[8][4];   // drA and dkA (the second warp)
  zero(P);
  zero(Q);
  if (!second) {
    // dv = (A + diag(beta))^T dy + (k e^{tot - l} e^{Ltot - B_{J+1}}) G, rows j
    {
      float AT[8][4];   // A^T: rows j, columns i
      zero(AT);
#pragma unroll
      for (int I = 0; I < kNs; ++I) {
        if (I >= Iw) product<T, 2>(AT + 2 * I, sp_a<true>(f.kk, dc.gam[I][Iw]),
                                   sp_b<true>(f.a, nullptr), m0, 0, kDim, I * kSub, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = frag_row(m0, lane, e), i = frag_col(nt, lane, e);
          float a = 0.f;
          if (i > j) {
            a = AT[nt][e];
            if (any && i < m0 + kSub) a += dc.ad[Iw][i - m0][j - m0];
          } else if (i == j) {
            a = dc.beta[j];
          }
          AT[nt][e] = a;
        }
      }
      float U[8][4];
      zero(U);
      product<T, 8>(U, Regs{AT}, ex_b<false>(sm.dy), m0, m0, kChunk, 0, lane);
      product<T, 8>(U, sp_a<true>(f.kk, dc.delta[Iw]), sp_b<false>(f.g, nullptr), m0, 0, kDim,
                    0, lane);
      write_acc(dv + base, stride, U, rows, d, m0, lane);
    }
  } else {
    // dA = dy v^T below the diagonal (rows i), dbeta on it
    float DA[8][4];
    zero(DA);
    product<T, 8>(DA, ex_a<true>(sm.dy), ex_b<true>(sm.v), m0, 0, kDim, 0, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = frag_row(m0, lane, e), j = frag_col(nt, lane, e);
        if (j == i) sm.dbeta[i] = DA[nt][e];
        if (j >= i) DA[nt][e] = 0.f;
        if (any && j >= m0 && j < m0 + kSub) sm.dad[Iw][i - m0][j - m0] = DA[nt][e];
      }
    }
    __syncwarp();
    // drA (rows i, columns channels): dy S0^T, then sub-blocks J = 0..Iw by
    // Horner, P <- e^{tot_J} P + dA_IJ (k e^{tot - l})_J, the diagonal one
    // only where factorised, scaled back by e^{-tot}; then times e^{lp}
    product<T, 8>(P, ex_a<true>(sm.dy), sp_b<true>(f.s, nullptr), m0, 0, kDim, 0, lane);
#pragma unroll
    for (int J = 0; J < kNs; ++J) {
      if (J < Iw) {
        scale_cols(P, dc.etot[J], lane);
        product<T, 8>(P, Regs{DA}, sp_b<false>(f.kk, nullptr), m0, J * kSub, (J + 1) * kSub,
                      0, lane);
      }
    }
    scale_cols(P, sm.mtot[Iw], lane);
    product<T, 8>(P, Regs{DA}, sp_b<false>(f.kk, sm.mdiag[Iw]), m0, m0, m0 + kSub, 0, lane);
    scale_cols(P, sm.ftot[Iw], lane);
    scale_by(P, f.ea, nullptr, m0, lane);
    // dkA (rows j, columns channels), from dA^T = v dy^T (columns i > j):
    // sub-blocks I = 3..Iw + 1 by Horner, Q <- e^{tot_I} Q + dA^T_JI (r
    // e^{lp})_I, then the diagonal as for drA; then times e^{tot - l}
    {
      float DAT[8][4];
      zero(DAT);
      product<T, 8>(DAT, ex_a<true>(sm.v), ex_b<true>(sm.dy), m0, 0, kDim, 0, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = frag_row(m0, lane, e), i = frag_col(nt, lane, e);
          if (i <= j) DAT[nt][e] = 0.f;
          if (any && i >= m0 && i < m0 + kSub) sm.dadt[Iw][j - m0][i - m0] = DAT[nt][e];
        }
      }
      __syncwarp();
#pragma unroll
      for (int I = kNs - 1; I >= 0; --I) {
        if (I > Iw) {
          scale_cols(Q, dc.etot[I], lane);
          product<T, 8>(Q, Regs{DAT}, sp_b<false>(f.a, nullptr), m0, I * kSub, (I + 1) * kSub,
                        0, lane);
        }
      }
      scale_cols(Q, sm.mtot[Iw], lane);
      product<T, 8>(Q, Regs{DAT}, sp_b<false>(f.a, sm.mdiag[Iw]), m0, m0, m0 + kSub, 0, lane);
      scale_cols(Q, sm.ftot[Iw], lane);
    }
    scale_by(Q, f.ek, nullptr, m0, lane);
    // dkS: rows j, columns channels, to its own table (outside the union)
    float Z[8][4];
    zero(Z);
    product<T, 8>(Z, ex_a<true>(sm.v), sp_b<true>(f.g, nullptr), m0, 0, kDim, 0, lane);
    scale_by(Z, f.ek, dc.delta[Iw], m0, lane);
    put_tab_t(sm.dks, Z, m0, lane);
  }
  // the exact diagonal of channels past kSafe
  if (any && second) {
    const float* wb = w + base;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = frag_row(m0, lane, e), ch = frag_col(nt, lane, e);
        if (ch >= d || dc.tot[Iw][ch] >= -kSafeLog2) continue;
        const int tl = t - m0;
        for (int o = 0; o < kSub; ++o) {
          if (o < tl) {   // drA: j = o < i = t
            P[nt][e] += sm.dad[Iw][tl][o] * get(sm.k, m0 + o, ch) *
                        decay_between(wb + ch, stride, m0, o, tl, rows);
          } else if (o > tl) {   // dkA: i = o > j = t
            Q[nt][e] += sm.dadt[Iw][tl][o] * get(sm.r, m0 + o, ch) *
                        decay_between(wb + ch, stride, m0, tl, o, rows);
          }
        }
      }
    }
  }
  __syncthreads();   // every product is done: the factor tiles are free
  if (second) {
    put_tab_t(sm.x.p.dr, P, m0, lane);
    put_tab_t(sm.x.p.dka, Q, m0, lane);
  }
  for (int idx = threadIdx.x; idx < kDim * kDim; idx += kChunkThreads) {
    const int t = idx >> 6, ch = idx & 63;
    sm.x.p.r[ch * kTS + t] = get(sm.r, t, ch);
    sm.x.p.k[ch * kTS + t] = get(sm.k, t, ch);
  }
  __syncthreads();   // drA, dkA, dkS are in

  // per channel, eight lanes, each eight tokens (lane 8 q + g: channel
  // 4 j + q of the warp's eight, tokens 8 g .. 8 g + 7): dr, dk, and da =
  // sum_{s>t} (r drA - k dkA)_s - (k dkA)_t + sum_{s<t} (k dkS)_s + sigma
  // from scans within each lane and across its eight; dr, dk and dw = da /
  // w go back over the sums, then out in rows.  du's part of this chunk
  // per channel.  In f32 on the bf16 route (64 terms), f64 on the f32 route.
  using Acc = typename std::conditional<std::is_same<T, bf16>::value, float, double>::type;
  {
    const int q = lane >> 3, g = lane & 7;
#pragma unroll
    for (int j = 0; j < kDim / kChunkWarps / 4; ++j) {
      const int ch = warp * (kDim / kChunkWarps) + 4 * j + q;
      const float uc = dc.u[ch];
      float kdka[8], drv[8], dkv[8], wv[8];
      Acc pv[8], qv[8], psum = 0, qsum = 0, dus = 0;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int t = 8 * g + x, o = ch * kTS + t;
        const float rv = sm.x.p.r[o], kv = sm.x.p.k[o];
        const float dra = sm.x.p.dr[o], dka = sm.x.p.dka[o], dks = sm.dks[o];
        const float db = sm.dbeta[t];
        wv[x] = sm.wt[o];
        pv[x] = static_cast<Acc>(rv) * dra - static_cast<Acc>(kv) * dka;
        qv[x] = static_cast<Acc>(kv) * dks;
        kdka[x] = kv * dka;
        drv[x] = dra + uc * kv * db;
        dkv[x] = dka + dks + uc * rv * db;
        dus += static_cast<Acc>(db) * rv * kv;
        psum += pv[x];
        qsum += qv[x];
      }
      // the lanes' totals: suffix sums (from the back) and prefix sums
      // (from the front) across the channel's eight lanes
      Acc suf = psum, pre = qsum;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        const Acc us = __shfl_down_sync(kFull, suf, o, 8);
        const Acc up = __shfl_up_sync(kFull, pre, o, 8);
        if (g + o < 8) suf += us;
        if (g >= o) pre += up;
        dus += __shfl_xor_sync(kFull, dus, o, 8);
      }
      Acc run_s = __shfl_down_sync(kFull, suf, 1, 8);
      Acc run_p = __shfl_up_sync(kFull, pre, 1, 8);
      if (g == 7) run_s = 0;
      if (g == 0) run_p = 0;
      Acc da[8];
#pragma unroll
      for (int x = 7; x >= 0; --x) {
        da[x] = run_s - kdka[x];
        run_s += pv[x];
      }
      const Acc sig = sm.sigma[ch];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        da[x] += run_p + sig;
        run_p += qv[x];
        const int t = 8 * g + x, o = ch * kTS + t;
        sm.x.p.dr[o] = drv[x];
        sm.x.p.dka[o] = dkv[x];
        sm.dks[o] = (t < rows && wv[x] > 1e-30f) ? static_cast<float>(da[x]) / wv[x] : 0.f;
      }
      if (g == 0 && ch < d) du_part[(bh * nc + c) * d + ch] = static_cast<float>(dus);
    }
  }
  __syncthreads();   // dr, dk and dw are in
  // two channels a thread, in pairs where the head's size is even
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * kDim / 2; idx += kChunkThreads) {
    const int t = idx >> 5, ch = (idx & 31) * 2;
    if (ch >= d) continue;
    const int o = ch * kTS + t;
    const size_t at = base + static_cast<size_t>(t) * stride + ch;
    if ((d & 1) == 0) {
      store2(dr + at, sm.x.p.dr[o], sm.x.p.dr[o + kTS]);
      store2(dk + at, sm.x.p.dka[o], sm.x.p.dka[o + kTS]);
      store2(dw + at, sm.dks[o], sm.dks[o + kTS]);
    } else {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (ch + x >= d) break;
        store(dr + at + x, sm.x.p.dr[o + x * kTS]);
        store(dk + at + x, sm.x.p.dka[o + x * kTS]);
        dw[at + x] = sm.dks[o + x * kTS];
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// launchers
// ---------------------------------------------------------------------- //

bool bad_shape(int b, int t, int h, int d) {
  return b < 1 || t < 1 || h < 1 || d < 1 || d > kDim || b > 65535;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// dynamic shared memory for ``smem`` bytes a block, with the SM's split
// set to the most shared memory (two blocks of ~108 KB need all of it)
template <class K>
cudaError_t set_smem(K kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int fwd(const void* r, const void* k, const void* v, const float* w, const float* u,
        const float* s0, void* y, float* s_out, float* ckpt, int b, int t, int h, int d,
        cudaStream_t stream) {
  auto kernel = wkv6_fwd_kernel<T>;
  const int smem = static_cast<int>(sizeof(FwdSmem<T>));
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = sizeof(T) == 2 && d % 8 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v);
  kernel<<<dim3(h * kFwdSplit<T>, b), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      s0, static_cast<T*>(y), s_out, ckpt, t, h, d, vec);
  return static_cast<int>(cudaGetLastError());
}

// dG and e^{Ltot} per chunk, the chain over the chunks, then every chunk
// at once
template <typename T>
int bwd(const void* r, const void* k, const void* v, const float* w, const float* u,
        const float* ckpt, const void* dy, const float* dstate, void* dr, void* dk, void* dv,
        float* dw, float* du_part, float* du, float* ds0, float* gsave, float* eltot, int b,
        int t, int h, int d, cudaStream_t stream) {
  const int vec = sizeof(T) == 2 && d % 8 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(dy);
  const int nc = (t + kChunk - 1) / kChunk;
  auto part = wkv6_bwd_state_part_kernel<T>;
  const int smem1 = static_cast<int>(sizeof(BwdPartSmem<T>));
  cudaError_t err = set_smem(part, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  part<<<dim3(nc, h, b), kThreads, smem1, stream>>>(static_cast<const T*>(r), w,
                                                     static_cast<const T*>(dy), gsave, eltot,
                                                     t, h, d, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the chain and the chunk kernel each launch behind the grid before them
  // (programmatic dependent launch), reading its results only after
  // wait_prior_grid
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const size_t elems = static_cast<size_t>(b) * h * d * d;
  cfg.gridDim = dim3(static_cast<unsigned>((elems + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_state_scan, gsave, static_cast<const float*>(eltot),
                           dstate, ds0, nc, d, elems);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto chunk = wkv6_bwd_chunk_kernel<T>;
  const int smem2 = static_cast<int>(sizeof(BwdChunkSmem<T>));
  err = set_smem(chunk, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(nc, h, b);
  cfg.blockDim = dim3(kChunkThreads);
  cfg.dynamicSmemBytes = smem2;
  err = cudaLaunchKernelEx(&cfg, chunk, static_cast<const T*>(r), static_cast<const T*>(k),
                           static_cast<const T*>(v), w, u, ckpt,
                           static_cast<const float*>(gsave), static_cast<const T*>(dy),
                           static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw,
                           du_part, t, h, d, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3((h * d + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_du_sum, static_cast<const float*>(du_part), du, b,
                           nc, h, d);
  return static_cast<int>(err);
}

// blocks of one kernel resident per SM (occupancy), after set_smem
template <class K>
int resident(K kernel, int threads, int smem) {
  int n = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 for r, k, v, y (and dy, dr, dk,
// dv); w, u, the states, dw and du's per-(b, h) parts are float32.
// Tensors are contiguous: r, k, v, w, y (B, T, H, D), u (H, D), states (B, H,
// D, D) (s0 may be null: a zero state), the saved chunk-start states (B, H,
// ceil(T / 64), D, D) -- null to save none; the backward's dstate, the
// gradient on the final state (B, H, D, D), may be null: a zero one.
extern "C" int repro_wkv6_fwd(int dtype, const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0, void* y,
                              void* s_out, void* ckpt, int b, int t, int h, int d,
                              void* stream) {
  if (bad_shape(b, t, h, d) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  float* ck = static_cast<float*>(ckpt);
  return dtype == 0 ? fwd<float>(r, k, v, wf, uf, s0f, y, so, ck, b, t, h, d, s)
                    : fwd<bf16>(r, k, v, wf, uf, s0f, y, so, ck, b, t, h, d, s);
}

extern "C" int repro_wkv6_bwd(int dtype, const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* ckpt,
                              const void* dy, const void* dstate, void* dr, void* dk,
                              void* dv, void* dw, void* du_part, void* du, void* ds0,
                              void* gsave, void* eltot, int b, int t, int h, int d,
                              void* stream) {
  if (bad_shape(b, t, h, d) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* ck = static_cast<const float*>(ckpt);
  float* dwf = static_cast<float*>(dw);
  float* dup = static_cast<float*>(du_part);
  float* duf = static_cast<float*>(du);
  float* ds = static_cast<float*>(ds0);
  float* gs = static_cast<float*>(gsave);
  float* el = static_cast<float*>(eltot);
  const float* dsf = static_cast<const float*>(dstate);
  return dtype == 0 ? bwd<float>(r, k, v, wf, uf, ck, dy, dsf, dr, dk, dv, dwf, dup, duf, ds,
                                 gs, el, b, t, h, d, s)
                    : bwd<bf16>(r, k, v, wf, uf, ck, dy, dsf, dr, dk, dv, dwf, dup, duf, ds,
                                gs, el, b, t, h, d, s);
}

// blocks per SM of the bf16 kernels: the forward (kernel 0), the
// backward's state part (1) and its chunk kernel (2); -1 if the query
// fails.  For the build report.
extern "C" int repro_wkv6_blocks_per_sm(int kernel) {
  if (kernel == 1) {
    return resident(wkv6_bwd_state_part_kernel<bf16>, kThreads, sizeof(BwdPartSmem<bf16>));
  }
  if (kernel == 2) {
    return resident(wkv6_bwd_chunk_kernel<bf16>, kChunkThreads, sizeof(BwdChunkSmem<bf16>));
  }
  return resident(wkv6_fwd_kernel<bf16>, kThreads, sizeof(FwdSmem<bf16>));
}
