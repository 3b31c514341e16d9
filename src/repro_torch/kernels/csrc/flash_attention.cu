// Blocked causal GQA flash attention for Hopper (sm_90a): forward, and the
// backward pass recomputed from q, k, v, o, dO and the saved log-sum-exp.
//
// The forward replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (_fa_kernel, pl.pallas_call at :123)
// and computes what its body computes: scores q.k * scale from f32 copies of
// q and k, keys at or past Tk and (causal) keys after q_pos = row + Tk - Tq
// masked with NEG_INF = -0.7 * FLT_MAX, an online softmax whose running max,
// sum and accumulator stay in f32, p rounded to V's dtype before p.V (as the
// reference's p.astype(v.dtype)), V rows past Tk zeroed, GQA reading kv head
// h / g, tiles wholly after the diagonal skipped, and acc / max(l, 1e-30)
// written in q's dtype.  It also writes lse = m + log(l) per query row for
// the backward pass.  Both routes also take the reference model's prefix-LM
// mask (layers.flash_attention's prefix_len, which the TPU kernel's dispatch
// drops): with causal, a key below prefix_len is visible to every row, so
// tile skipping keeps every tile that starts below it (forward and dQ read
// keys up to max(diagonal, prefix_len); dK/dV blocks that hold a prefix key
// read every q tile) and a tile that straddles prefix_len is masked per
// element.  Without causal it changes nothing, as in the reference.  The
// reference has no backward kernel (JAX differentiates the jnp version);
// this one is the standard flash backward in three launches:
//   delta_i = dO_i . O_i                              (delta)
//   p_ij = exp(s_ij - lse_i), ds_ij = p_ij (dO_i . v_j - delta_i)
//   dQ_i = scale sum_j ds_ij k_j                      (dQ: one block per q
//                                                      tile, loops over k tiles)
//   dK_j = scale sum_i ds_ij q_i, dV_j = sum_i p_ij dO_i
//                                                     (dK/dV: one block per k
//                                                      tile and kv head, loops
//                                                      over the group's heads
//                                                      and q tiles)
// Every sum runs in a fixed order inside one block and no atomics are used,
// so both routes are deterministic: the same inputs give the same bits.
//
// Two routes, chosen by dtype:
//
// * bfloat16 (the training path): tensor cores.  Bound: at phi3's training
//   shape (B 4, T 512, 32/32 heads of 96, causal) the forward moves 50.6 MB
//   (q, k, v read once, o and lse written once) for 6.5 GFLOP, and the
//   backward 100.9 MB for 16.1 GFLOP: 15 us and 30 us over 3.35 TB/s against
//   7 us and 16 us at 989 TFLOP/s, so both are bound by bytes on this card
//   once the products run on the tensor cores.  The design keeps every
//   intermediate (S, P, dP, dS, the softmax state) in registers, reads each
//   tile of q/k/v/dO from device memory once per block, and feeds the tensor
//   cores from shared memory without the CUDA cores touching the tiles:
//   - a block is two consumer warpgroups (64 rows each) and a producer; the
//     producer issues TMA copies of 128-byte-swizzled tiles into a ring
//     (2 stages forward, 3 backward) completed on mbarriers, so copies
//     overlap the products.  The dK/dV kernel holds four accumulators per
//     thread, so its producer is a whole warpgroup that gives registers to
//     the consumers (setmaxnreg: 40 / 232); elsewhere it is one warp;
//   - the tensor maps are 4-D over the (B, T, H, D) layout as it is, so
//     nothing is transposed or copied on the host.  D is loaded in boxes of
//     64 columns, the width of one 128-byte swizzle row: D 80 and 96 take a
//     second box whose columns past D the TMA unit fills with zeros, as it
//     fills rows past T (the reference's "V rows past Tk zeroed").  128-byte
//     swizzling keeps wgmma's shared-memory reads free of bank conflicts,
//     and a narrower swizzle for the second box would need a second layout
//     in every product for a few columns.  Products over D stop at D (k
//     steps of 16), and products whose output is D wide run a 64-wide and a
//     (D - 64)-wide wgmma, so the zero columns cost shared memory only;
//   - S = Q K^T (and dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) run as wgmma
//     m64n64k16 with both operands in shared memory; P (and dS) are
//     converted to bf16 in registers and fed as the register A operand of
//     P V, dS K, P^T dO and dS^T Q, whose B operand is the tile as stored
//     (MN-major).  Rounding P to bf16 there is the reference's
//     p.astype(v.dtype); dS is rounded only where it enters a product;
//   - the online softmax runs in f32 registers with exp2 (ex2.approx) and
//     scale * log2 e folded in; lse is written in natural-log units.  The
//     quad of threads that shares a row reduces its max with two shuffles;
//   - the dQ kernel issues dS K of tile i - 1 before it forms dS of tile i,
//     so that product overlaps the CUDA-core work.  The same overlap made
//     the forward (P V under the softmax) and dK/dV slower on the H100, so
//     they wait for each product;
//   - q tiles run longest causal rows first (forward, dQ) and k tiles from
//     the first key (dK/dV), so the blocks with the most tiles start first.
//   V may be narrower than Q and K, as the TPU kernel's V and output blocks
//   have their own width dv: the kernels are templated on (D, DV), and every
//   product over or into V's columns (P V, dO V^T, P^T dO, the delta rows,
//   V's and dO's tiles and tensor maps, O's and dV's stores) runs at DV while
//   Q K^T, dS K and dS^T Q keep D.  (D, DV) = (64, 64), (80, 80), (96, 96),
//   (128, 128), (256, 256) (PaliGemma's heads) and (96, 64) (MiniCPM3's MLA
//   heads) are instantiated.  Any other widths (multiples of 8 up to 256)
//   run at the smallest instantiation that holds them: the tensor maps keep
//   the true widths, so the boxes read the columns past them as zeros (which
//   add nothing to Q K^T and give zero output columns), and the stores stop
//   at them;
//   - at D 256 a row's accumulators do not fit one thread's registers (dK
//     and dV together would be 256 f32 values a thread), so the two consumer
//     warpgroups of a block take the same 64 rows (keys in dK/dV), each
//     computes the scores over all four 64-column boxes, and each keeps and
//     stores half of the output columns (Split<D, DV>): every warpgroup's
//     footprint is D 128's, for scores computed twice.  A block's row tile
//     is then 64 rows, and the backward ring 2 stages (3 do not fit the
//     shared memory).  No sum crosses warpgroups, so the bits stay fixed.
//
// * float32: exact f32 products on the CUDA cores (tensor cores would round
//   to TF32); any D and Dv that are multiples of 8 up to 256.  A block of 4 warps owns 32 query rows (8 per warp); each
//   32-key tile is staged in shared memory in f32, K transposed with a
//   padded stride so that lane j reads key j without bank conflicts.  A lane
//   computes one key's score for its warp's 8 rows; the softmax statistics
//   reduce over the warp with shuffles; for p.V each lane owns columns lane,
//   lane+32, ... of the 8 rows' accumulators and receives p_ij from lane j by
//   shuffle.  Bound by those f32 operations, far from the tensor cores.
//
// * wide heads (D or Dv above 256), a static rule by dtype and width
//   (route_of below; the wrapper's flash_attention.route states it too).
//   Any multiple of 8 runs on either dtype; the wrapper pads the rest.
//   - float32: the float32 route's layout with every contraction streamed
//     in 64-column boxes and the output columns split over blocks of 256
//     (the flash_wide_* kernels), exact f32 on the CUDA cores.
//   - bfloat16: tensor cores (hopper::wide_fwd_kernel, wide_dq_kernel,
//     wide_dkdv_kernel), D 256's layout carried past it.  A 64-row bf16 tile of
//     D 576 is 72 KB, so Q, K and V of one stage leave no room for a second in
//     227 KB: no tile stays resident.  Every contraction (Q K^T over D, dO V^T
//     over Dv; K Q^T and V dO^T in dK/dV) streams through a ring of eight (A
//     box, B box) pairs of 64 rows by 64 columns, 128-byte swizzled and
//     completed on mbarriers as tma_rows loads them, and S (dP) accumulates box
//     after box as m64n64k16 products, each pair handed back as soon as its
//     products are done; the box count is taken at run time, so every width
//     runs without an instantiation of its own, and a box past the true width
//     reads zeros.  Q and dO stream too (re-read from L2 for every key tile): a
//     forward that kept Q resident (72 KB at D 576, K boxes alone in the ring,
//     a single exchange buffer) read 40% fewer bytes a tile and was no faster
//     on the H100 (6-9% slower, in separate runs), so the tiles' time is not
//     L2's but the pairs' latency, which the ring's depth hides.  A block owns
//     64 rows and one slice of at most 256 output columns (Dv forward, D for
//     dQ, D's slices then Dv's for dK/dV in one grid; the forward's slices
//     are 512 columns where V is wider and the grid large, its consumers
//     then holding four boxes each with the producer warpgroup's registers,
//     setmaxnreg, so the scores are computed once per 512); its two consumer
//     warpgroups share the rows, split each contraction's boxes between them
//     and add each other's partial S (dP) through shared memory (a + b == b +
//     a, so both hold the same bits), and each accumulates two 64-column boxes
//     of the slice (D 256's footprint), streamed through a one-stage slice
//     ring, with P (dS) in registers as the A operand.  Causal GQA leaves the
//     first key tiles of dK/dV with every q tile of every head of the group, so
//     the launcher splits a kv head's query heads over blocks (kv_groups, a
//     rule of the shape) until the grid fills the card, and a combine kernel
//     adds their f32 partial sums in group order (the wrapper allocates the
//     workspace that repro_flash_bwd_workspace asks for).  Every sum runs in a
//     fixed order and nothing is atomic: the same bits run after run, at the
//     price of the scores computed once per slice.  Bound: operations at
//     absorbed MLA's MQA prefill (B 1 x T 1024, 16 heads over 1, causal: ~18
//     GFLOP against ~38 MB); at B 2 x T 256 over 8 heads the forward is one
//     thin wave of 128 blocks on 132 SMs, whose causal rows take 1 to 4 key
//     tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                  // query (or key) rows per warp
constexpr int kTile = kWarps * kRows;     // 32 rows per block tile
constexpr int kPad = kTile + 1;           // padded stride of transposed tiles
constexpr float kNegInf = -0.7f * 3.40282347e38f;   // NEG_INF of the reference
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }


__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Stage rows [r0, r0 + kTile) of one head of a (B, T, H, D) tensor into
// shared memory as f32, zero past row t: row-major (dst[r * d + c]) or
// transposed with the padded stride (dst[c * kPad + r]).
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int r0,
                                     int t, int h, int heads, int d) {
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) {
    const int r = i / d;
    const int c = i % d;
    const int row = r0 + r;
    float x = 0.f;
    if (row < t) {
      x = to_float(src[((static_cast<size_t>(b) * t + row) * heads + h) * d + c]);
    }
    if (kTransposed) {
      dst[c * kPad + r] = x;
    } else {
      dst[r * d + c] = x;
    }
  }
}

// acc[i] += x_rows[i] . yt[:, lane] for a warp's kRows rows of a row-major
// tile (broadcast reads, 4 columns at a time) against a transposed tile
__device__ __forceinline__ void row_dots(float (&acc)[kRows], const float* x_rows,
                                         const float* yt, int d, int lane) {
  for (int c = 0; c < d; c += 4) {
    const float y0 = yt[(c + 0) * kPad + lane];
    const float y1 = yt[(c + 1) * kPad + lane];
    const float y2 = yt[(c + 2) * kPad + lane];
    const float y3 = yt[(c + 3) * kPad + lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(x_rows + i * d + c);
      acc[i] += x.x * y0 + x.y * y1 + x.z * y2 + x.w * y3;
    }
  }
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

// NC: 32-column groups of the output (Dv)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q,   // (B, Tq, Hq, D)
                 const T* __restrict__ k,   // (B, Tk, Hkv, D)
                 const T* __restrict__ v,   // (B, Tk, Hkv, Dv)
                 T* __restrict__ o,         // (B, Tq, Hq, Dv)
                 float* __restrict__ lse,   // (B, Hq, Tq)
                 int tq, int tk, int hq, int hkv, int d, int dv, float scale,
                 int causal, int prefix_len) {
  const int tiles = (tq + kTile - 1) / kTile;
  const int q0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int h = static_cast<int>(blockIdx.x / tiles % hq);
  const int b = static_cast<int>(blockIdx.x / tiles / hq);
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // (kTile, d) query rows
  float* kt_s = q_s + kTile * d;     // (d, kPad) keys, transposed
  float* v_s = kt_s + d * kPad;      // (kTile, dv) values

  stage<T, false>(q_s, q, b, q0, tq, h, hq, d);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // tiles wholly after the last query row's diagonal (and past the
  // prefix) are skipped
  const int k_end =
      causal ? min(tk, max(prefix_len, min(q0 + kTile, tq) + q_offset)) : tk;
  const float* my_q = q_s + warp * kRows * d;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    stage<T, true>(kt_s, k, b, k0, tk, hk, hkv, d);
    stage<T, false>(v_s, v, b, k0, tk, hk, hkv, dv);
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    row_dots(s, my_q, kt_s, d, lane);

    const int k_pos = k0 + lane;
    float p[kRows], corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + warp * kRows + i + q_offset;
      const bool valid = k_pos < tk && (!causal || k_pos <= q_pos || k_pos < prefix_len);
      const float si = valid ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float e = expf(si - m_new);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(e);
      m[i] = m_new;
      p[i] = e;
    }

    // acc = acc * corr + p.V, with this tile's p.V summed on its own
    float pv[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) pv[i][c] = 0.f;
    }
    for (int j = 0; j < kTile; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < dv ? v_s[j * dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pij = __shfl_sync(kFull, p[i], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) pv[i][c] += pij * vj[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] * corr[i] + pv[i][c];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row >= tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<size_t>(b) * tq + row) * hq + h) * dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) store(orow + col, acc[i][c] * inv);
    }
    if (lane == 0) lse[(static_cast<size_t>(b) * hq + h) * tq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------- //
// backward
// ---------------------------------------------------------------------- //

// delta[b, h, t] = dO[b, t, h] . O[b, t, h]: one warp per row of d (= Dv)
// columns
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int b_n, int tq, int hq, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(b_n) * tq * hq) return;
  const T* orow = o + row * d;
  const T* grow = dout + row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += to_float(orow[c]) * to_float(grow[c]);
  sum = warp_sum(sum);
  if (lane == 0) {
    const int h = static_cast<int>(row % hq);
    const long long bt = row / hq;
    const int t = static_cast<int>(bt % tq);
    const int b = static_cast<int>(bt / tq);
    delta[(static_cast<size_t>(b) * hq + h) * tq + t] = sum;
  }
}

// NC: 32-column groups of max(D, Dv)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int tq, int tk, int hq, int hkv, int d,
                    int dv, float scale, int causal, int prefix_len) {
  const int tiles = (tq + kTile - 1) / kTile;
  const int q0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int h = static_cast<int>(blockIdx.x / tiles % hq);
  const int b = static_cast<int>(blockIdx.x / tiles / hq);
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // (kTile, d)
  float* do_s = q_s + kTile * d;     // (kTile, dv)
  float* kt_s = do_s + kTile * dv;   // (d, kPad)
  float* vt_s = kt_s + d * kPad;     // (dv, kPad)

  stage<T, false>(q_s, q, b, q0, tq, h, hq, d);
  stage<T, false>(do_s, dout, b, q0, tq, h, hq, dv);

  float row_lse[kRows], row_delta[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = min(q0 + warp * kRows + i, tq - 1);
    row_lse[i] = lse[(static_cast<size_t>(b) * hq + h) * tq + row];
    row_delta[i] = delta[(static_cast<size_t>(b) * hq + h) * tq + row];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end =
      causal ? min(tk, max(prefix_len, min(q0 + kTile, tq) + q_offset)) : tk;
  const float* my_q = q_s + warp * kRows * d;
  const float* my_do = do_s + warp * kRows * dv;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage<T, true>(kt_s, k, b, k0, tk, hk, hkv, d);
    stage<T, true>(vt_s, v, b, k0, tk, hk, hkv, dv);
    __syncthreads();

    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
    row_dots(s, my_q, kt_s, d, lane);
    row_dots(dp, my_do, vt_s, dv, lane);

    const int k_pos = k0 + lane;
    float ds[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + warp * kRows + i + q_offset;
      const bool valid = k_pos < tk && (!causal || k_pos <= q_pos || k_pos < prefix_len);
      const float p = valid ? expf(s[i] * scale - row_lse[i]) : 0.f;
      ds[i] = p * (dp[i] - row_delta[i]);
    }

    // this tile's sum first, then into the running sum: shorter chains
    // of additions than one running sum over every key
    float part[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) part[i][c] = 0.f;
    }
    for (int j = 0; j < kTile; ++j) {
      float kj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        kj[c] = col < d ? kt_s[col * kPad + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float dsij = __shfl_sync(kFull, ds[i], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) part[i][c] += dsij * kj[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] += part[i][c];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row >= tq) continue;
    T* out = dq + ((static_cast<size_t>(b) * tq + row) * hq + h) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(out + col, acc[i][c] * scale);
    }
  }
}

// NC: 32-column groups of max(D, Dv)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
                      int hq, int hkv, int d, int d_v, float scale, int causal,
                      int prefix_len) {
  const int tiles = (tk + kTile - 1) / kTile;
  const int k0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int hk = static_cast<int>(blockIdx.x / tiles % hkv);
  const int b = static_cast<int>(blockIdx.x / tiles / hkv);
  const int g = hq / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // (kTile, d) key rows
  float* v_s = k_s + kTile * d;      // (kTile, d_v) value rows
  float* qt_s = v_s + kTile * d_v;   // (d, kPad) query tile, transposed
  float* dot_s = qt_s + d * kPad;    // (d_v, kPad) dO tile, transposed

  stage<T, false>(k_s, k, b, k0, tk, hk, hkv, d);
  stage<T, false>(v_s, v, b, k0, tk, hk, hkv, d_v);

  float dk_acc[kRows][NC], dv_acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  // the first query tile that sees any of these keys (every tile sees a
  // prefix key)
  const int q_begin =
      causal && k0 >= prefix_len ? max(0, k0 - q_offset) / kTile * kTile : 0;
  const float* my_k = k_s + warp * kRows * d;
  const float* my_v = v_s + warp * kRows * d_v;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    for (int qt0 = q_begin; qt0 < tq; qt0 += kTile) {
      __syncthreads();
      stage<T, true>(qt_s, q, b, qt0, tq, h, hq, d);
      stage<T, true>(dot_s, dout, b, qt0, tq, h, hq, d_v);
      __syncthreads();

      const int q_row = qt0 + lane;
      const int q_pos = q_row + q_offset;
      const size_t stat = (static_cast<size_t>(b) * hq + h) * tq + min(q_row, tq - 1);
      const float my_lse = lse[stat];
      const float my_delta = delta[stat];

      float s[kRows], dp[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
      row_dots(s, my_k, qt_s, d, lane);
      row_dots(dp, my_v, dot_s, d_v, lane);

      float p[kRows], ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k_pos = k0 + warp * kRows + i;
        const bool valid = q_row < tq && k_pos < tk &&
                           (!causal || k_pos <= q_pos || k_pos < prefix_len);
        p[i] = valid ? expf(s[i] * scale - my_lse) : 0.f;
        ds[i] = p[i] * (dp[i] - my_delta);
      }

      // this tile's sums first, then into the running sums
      float dk_part[kRows][NC], dv_part[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) dk_part[i][c] = dv_part[i][c] = 0.f;
      }
      for (int j = 0; j < kTile; ++j) {
        float qj[NC], gj[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          qj[c] = col < d ? qt_s[col * kPad + j] : 0.f;
          gj[c] = col < d_v ? dot_s[col * kPad + j] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pij = __shfl_sync(kFull, p[i], j);
          const float dsij = __shfl_sync(kFull, ds[i], j);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_part[i][c] += pij * gj[c];
            dk_part[i][c] += dsij * qj[c];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dk_acc[i][c] += dk_part[i][c];
          dv_acc[i][c] += dv_part[i][c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + warp * kRows + i;
    if (row >= tk) continue;
    const size_t off = (static_cast<size_t>(b) * tk + row) * hkv + hk;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(dk + off * d + col, dk_acc[i][c] * scale);
      if (col < d_v) store(dv + off * d_v + col, dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------- //
// wide heads: D or Dv above 256, float32, on the CUDA cores
// ---------------------------------------------------------------------- //
//
// Above 256 columns a block can hold neither its rows' accumulators in
// registers nor a whole row tile in shared memory (a 64-row bf16 Q tile of D
// 576 is 72 KB, and each K stage as much).  These kernels keep the float32
// route's layout (32 rows a block, 8 a warp, a lane a key or a query) and
// change two things:
// - every contraction (Q K^T over D, dO V^T over Dv) streams through shared
//   memory in boxes of kBoxW columns, its sum accumulating in f32 registers
//   box after box in a fixed order;
// - the output columns are split over blocks, kSliceW a block (dK's and
//   dV's slices are blocks of one grid).  Every block of a row tile
//   recomputes the same scores in the same order, so the bits stay fixed;
//   dO V^T runs over all of Dv inside each block; no sum crosses blocks and
//   nothing is atomic.
// bfloat16 calls past 256 run the tensor-core wide kernels (hopper::wide_*).

constexpr int kBoxW = 64;                 // columns of a streamed box
constexpr int kSliceW = 256;              // output columns a block owns
constexpr int kSliceNC = kSliceW / 32;    // 32-column groups of a slice

// Stage columns [c0, c0 + w) of rows [r0, r0 + kTile) of one head of a (B,
// T, H, ld) tensor into shared memory as f32, zero past row t: row-major with
// row stride `stride`, or transposed with the padded stride (dst[c * kPad +
// r]).
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage_box(float* dst, int stride, const T* src, int b,
                                         int r0, int t, int h, int heads, int ld,
                                         int c0, int w) {
  for (int i = threadIdx.x; i < kTile * w; i += kThreads) {
    const int r = i / w;
    const int c = i - r * w;
    const int row = r0 + r;
    float x = 0.f;
    if (row < t) {
      x = to_float(src[((static_cast<size_t>(b) * t + row) * heads + h) * ld + c0 + c]);
    }
    if (kTransposed) {
      dst[c * kPad + r] = x;
    } else {
      dst[r * stride + c] = x;
    }
  }
}

// acc[i] += x_rows[i * stride, + w) . yt[:w, lane], w a multiple of 4
__device__ __forceinline__ void box_dots(float (&acc)[kRows], const float* x_rows,
                                         int stride, const float* yt, int w, int lane) {
  for (int c = 0; c < w; c += 4) {
    const float y0 = yt[(c + 0) * kPad + lane];
    const float y1 = yt[(c + 1) * kPad + lane];
    const float y2 = yt[(c + 2) * kPad + lane];
    const float y3 = yt[(c + 3) * kPad + lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(x_rows + i * stride + c);
      acc[i] += x.x * y0 + x.y * y1 + x.z * y2 + x.w * y3;
    }
  }
}

// acc[i] += x_rows(i) . y(lane) over all `width` columns, box by box: rows
// r0x.. of head hx of x, rows r0y.. of head hy of y, both (B, T, H, width)
template <typename T>
__device__ __forceinline__ void wide_dots(float (&acc)[kRows], float* x_s, float* yt_s,
                                          const T* x, int r0x, int tx, int hx, int hxn,
                                          const T* y, int r0y, int ty, int hy, int hyn,
                                          int b, int width, int warp, int lane) {
  for (int c0 = 0; c0 < width; c0 += kBoxW) {
    const int w = min(kBoxW, width - c0);
    __syncthreads();   // the last box's readers are done
    stage_box<T, false>(x_s, kBoxW, x, b, r0x, tx, hx, hxn, width, c0, w);
    stage_box<T, true>(yt_s, 0, y, b, r0y, ty, hy, hyn, width, c0, w);
    __syncthreads();
    box_dots(acc, x_s + warp * kRows * kBoxW, kBoxW, yt_s, w, lane);
  }
}

// the wide kernels' shared memory: a row box, a transposed box and a slice
constexpr size_t kWideSmem = sizeof(float) * (kTile * kBoxW + kBoxW * kPad + kTile * kSliceW);

// grid y: head y / slices, slice y % slices of the Dv output columns
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                      int tq, int tk, int hq, int hkv, int d, int dv, float scale,
                      int causal, int prefix_len, int slices) {
  const int tiles = (tq + kTile - 1) / kTile;
  const int q0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int y = static_cast<int>(blockIdx.x / tiles % (static_cast<unsigned>(hq) * slices));
  const int h = y / slices;
  const int b = static_cast<int>(blockIdx.x / tiles / (static_cast<unsigned>(hq) * slices));
  const int c_lo = (y % slices) * kSliceW;
  const int c_n = min(kSliceW, dv - c_lo);
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                   // (kTile, kBoxW) a box of query rows
  float* yt_s = x_s + kTile * kBoxW;   // (kBoxW, kPad) a box of keys, transposed
  float* v_s = yt_s + kBoxW * kPad;    // (kTile, kSliceW) the slice of value rows

  float m[kRows], l[kRows], acc[kRows][kSliceNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kSliceNC; ++c) acc[i][c] = 0.f;
  }

  const int k_end =
      causal ? min(tk, max(prefix_len, min(q0 + kTile, tq) + q_offset)) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    wide_dots<T>(s, x_s, yt_s, q, q0, tq, h, hq, k, k0, tk, hk, hkv, b, d, warp, lane);
    // the boxes' syncs leave the last tile's p.V readers of v_s done
    stage_box<T, false>(v_s, kSliceW, v, b, k0, tk, hk, hkv, dv, c_lo, c_n);
    __syncthreads();

    const int k_pos = k0 + lane;
    float p[kRows], corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + warp * kRows + i + q_offset;
      const bool valid = k_pos < tk && (!causal || k_pos <= q_pos || k_pos < prefix_len);
      const float si = valid ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float e = expf(si - m_new);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(e);
      m[i] = m_new;
      p[i] = e;
    }

    float pv[kRows][kSliceNC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < kSliceNC; ++c) pv[i][c] = 0.f;
    }
    for (int j = 0; j < kTile; ++j) {
      float vj[kSliceNC];
#pragma unroll
      for (int c = 0; c < kSliceNC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < c_n ? v_s[j * kSliceW + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pij = __shfl_sync(kFull, p[i], j);
#pragma unroll
        for (int c = 0; c < kSliceNC; ++c) pv[i][c] += pij * vj[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < kSliceNC; ++c) acc[i][c] = acc[i][c] * corr[i] + pv[i][c];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row >= tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<size_t>(b) * tq + row) * hq + h) * dv + c_lo;
#pragma unroll
    for (int c = 0; c < kSliceNC; ++c) {
      const int col = lane + 32 * c;
      if (col < c_n) store(orow + col, acc[i][c] * inv);
    }
    if (lane == 0 && c_lo == 0) {
      lse[(static_cast<size_t>(b) * hq + h) * tq + row] = m[i] + logf(l[i]);
    }
  }
}

// dQ, grid y: head y / slices, slice y % slices of dQ's D columns
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, int tq, int tk, int hq, int hkv, int d, int dv,
                     float scale, int causal, int prefix_len, int slices) {
  const int tiles = (tq + kTile - 1) / kTile;
  const int q0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int y = static_cast<int>(blockIdx.x / tiles % (static_cast<unsigned>(hq) * slices));
  const int h = y / slices;
  const int b = static_cast<int>(blockIdx.x / tiles / (static_cast<unsigned>(hq) * slices));
  const int c_lo = (y % slices) * kSliceW;
  const int c_n = min(kSliceW, d - c_lo);
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                   // (kTile, kBoxW) a box of q or dO rows
  float* yt_s = x_s + kTile * kBoxW;   // (kBoxW, kPad) a box of k or v, transposed
  float* k_s = yt_s + kBoxW * kPad;    // (kTile, kSliceW) the slice of key rows

  float row_lse[kRows], row_delta[kRows], acc[kRows][kSliceNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = min(q0 + warp * kRows + i, tq - 1);
    row_lse[i] = lse[(static_cast<size_t>(b) * hq + h) * tq + row];
    row_delta[i] = delta[(static_cast<size_t>(b) * hq + h) * tq + row];
#pragma unroll
    for (int c = 0; c < kSliceNC; ++c) acc[i][c] = 0.f;
  }

  const int k_end =
      causal ? min(tk, max(prefix_len, min(q0 + kTile, tq) + q_offset)) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
    wide_dots<T>(s, x_s, yt_s, q, q0, tq, h, hq, k, k0, tk, hk, hkv, b, d, warp, lane);
    wide_dots<T>(dp, x_s, yt_s, dout, q0, tq, h, hq, v, k0, tk, hk, hkv, b, dv, warp,
                 lane);
    stage_box<T, false>(k_s, kSliceW, k, b, k0, tk, hk, hkv, d, c_lo, c_n);
    __syncthreads();

    const int k_pos = k0 + lane;
    float ds[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + warp * kRows + i + q_offset;
      const bool valid = k_pos < tk && (!causal || k_pos <= q_pos || k_pos < prefix_len);
      const float p = valid ? expf(s[i] * scale - row_lse[i]) : 0.f;
      ds[i] = p * (dp[i] - row_delta[i]);
    }

    float part[kRows][kSliceNC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < kSliceNC; ++c) part[i][c] = 0.f;
    }
    for (int j = 0; j < kTile; ++j) {
      float kj[kSliceNC];
#pragma unroll
      for (int c = 0; c < kSliceNC; ++c) {
        const int col = lane + 32 * c;
        kj[c] = col < c_n ? k_s[j * kSliceW + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float dsij = __shfl_sync(kFull, ds[i], j);
#pragma unroll
        for (int c = 0; c < kSliceNC; ++c) part[i][c] += dsij * kj[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < kSliceNC; ++c) acc[i][c] += part[i][c];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row >= tq) continue;
    T* out = dq + ((static_cast<size_t>(b) * tq + row) * hq + h) * d + c_lo;
#pragma unroll
    for (int c = 0; c < kSliceNC; ++c) {
      const int col = lane + 32 * c;
      if (col < c_n) store(out + col, acc[i][c] * scale);
    }
  }
}

// dK and dV, grid y: kv head y / slices, slice y % slices (slices =
// dk_slices + dv_slices): the first dk_slices own dK's D columns, the rest
// dV's Dv columns
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int hq,
                       int hkv, int d, int d_v, float scale, int causal, int prefix_len,
                       int dk_slices, int dv_slices) {
  const int tiles = (tk + kTile - 1) / kTile;
  const int k0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int slices = dk_slices + dv_slices;
  const unsigned hs = static_cast<unsigned>(hkv) * slices;
  const int y = static_cast<int>(blockIdx.x / tiles % hs);
  const int hk = y / slices;
  const int b = static_cast<int>(blockIdx.x / tiles / hs);
  const int sl = y % slices;
  const bool is_dk = sl < dk_slices;
  const int width = is_dk ? d : d_v;
  const int c_lo = (is_dk ? sl : sl - dk_slices) * kSliceW;
  const int c_n = min(kSliceW, width - c_lo);
  const int g = hq / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                   // (kTile, kBoxW) a box of k or v rows
  float* yt_s = x_s + kTile * kBoxW;   // (kBoxW, kPad) a box of q or dO, transposed
  float* o_s = yt_s + kBoxW * kPad;    // (kTile, kSliceW) the slice of q (dK) or dO (dV)

  float acc[kRows][kSliceNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < kSliceNC; ++c) acc[i][c] = 0.f;
  }

  const int q_begin =
      causal && k0 >= prefix_len ? max(0, k0 - q_offset) / kTile * kTile : 0;
  const T* slice_src = is_dk ? q : dout;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    for (int qt0 = q_begin; qt0 < tq; qt0 += kTile) {
      const int q_row = qt0 + lane;
      const int q_pos = q_row + q_offset;
      const size_t stat = (static_cast<size_t>(b) * hq + h) * tq + min(q_row, tq - 1);
      const float my_lse = lse[stat];
      const float my_delta = delta[stat];

      float s[kRows], dp[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
      wide_dots<T>(s, x_s, yt_s, k, k0, tk, hk, hkv, q, qt0, tq, h, hq, b, d, warp, lane);
      if (is_dk) {   // dV needs p alone
        wide_dots<T>(dp, x_s, yt_s, v, k0, tk, hk, hkv, dout, qt0, tq, h, hq, b, d_v,
                     warp, lane);
      }
      stage_box<T, false>(o_s, kSliceW, slice_src, b, qt0, tq, h, hq, width, c_lo, c_n);
      __syncthreads();

      float wgt[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k_pos = k0 + warp * kRows + i;
        const bool valid = q_row < tq && k_pos < tk &&
                           (!causal || k_pos <= q_pos || k_pos < prefix_len);
        const float p = valid ? expf(s[i] * scale - my_lse) : 0.f;
        wgt[i] = is_dk ? p * (dp[i] - my_delta) : p;
      }

      float part[kRows][kSliceNC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kSliceNC; ++c) part[i][c] = 0.f;
      }
      for (int j = 0; j < kTile; ++j) {
        float xj[kSliceNC];
#pragma unroll
        for (int c = 0; c < kSliceNC; ++c) {
          const int col = lane + 32 * c;
          xj[c] = col < c_n ? o_s[j * kSliceW + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float wij = __shfl_sync(kFull, wgt[i], j);
#pragma unroll
          for (int c = 0; c < kSliceNC; ++c) part[i][c] += wij * xj[c];
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kSliceNC; ++c) acc[i][c] += part[i][c];
      }
    }
  }

  T* out = is_dk ? dk : dv;
  const float mul = is_dk ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + warp * kRows + i;
    if (row >= tk) continue;
    T* orow = out + ((static_cast<size_t>(b) * tk + row) * hkv + hk) * width + c_lo;
#pragma unroll
    for (int c = 0; c < kSliceNC; ++c) {
      const int col = lane + 32 * c;
      if (col < c_n) store(orow + col, acc[i][c] * mul);
    }
  }
}

// ---------------------------------------------------------------------- //
// bfloat16 route: wgmma fed by TMA
// ---------------------------------------------------------------------- //

namespace hopper {

constexpr int kWG = 128;                     // threads of a warpgroup
constexpr int kThreadsH = 2 * kWG + 32;      // two consumer warpgroups + producer warp
// dK/dV holds four accumulators per thread: its producer is a whole
// warpgroup that hands registers to the consumers (3 x 128 threads, 40 +
// 2 x 232 registers each of the SM's 65,536)
constexpr int kThreadsKV = 3 * kWG;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTile = 64;                    // rows of a streamed tile
constexpr int kStages = 3;     // backward ring: a tile in each of two products, one loading
constexpr int kFwdStages = 2;  // forward ring: its products take one tile at a time
constexpr int kBox = 64;                     // bf16 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr uint32_t kTileBox = kTile * kRowBytes;         // 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Dims {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128 || D == 256, "head dim");
  static constexpr int kBoxes = (D + kBox - 1) / kBox;   // 64-column boxes per row
  // output columns of the second box, for a warpgroup's accumulator (at
  // most 128 columns wide, two boxes)
  static constexpr int kN1 = D - kBox;
  static constexpr int kKSteps = D / 16;                 // k steps of a product over D
};

// How a block's two consumer warpgroups share its work at head dims (D,
// DV).  Up to 128 columns each warpgroup owns 64 rows (a block 128) and
// keeps their accumulators whole, two 64-column boxes at most.  At 256 a
// warpgroup could not hold them (dK and dV alone would be 256 f32 registers
// a thread), so both warpgroups take the same 64 rows, each computes their
// scores over the whole head, and each accumulates and stores its own half
// of the output columns: the footprint of D 128, the scores computed twice.
template <int D, int DV>
struct Split {
  static constexpr int kWays = (D > 128 || DV > 128) ? 2 : 1;  // warpgroups per row
  static_assert(kWays == 1 || (D == 256 && DV == 256), "split head dims");
  static constexpr int kRows = 128 / kWays;                     // rows of a block
  static constexpr int kW = D / kWays, kWV = DV / kWays;        // a warpgroup's columns
  static constexpr uint32_t kBlockBox = kRows * kRowBytes;      // one box of the block's rows
  // the backward's ring: three stages, two where three do not fit
  static constexpr int kBwdStages = kWays == 1 ? kStages : 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box {64 columns, 1 head, rows, 1 batch row} of a (B, T, H, D) tensor
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// every 64-column box of rows [row, row + rows) of one head
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, uint32_t box_bytes,
                                         const CUtensorMap* map, uint32_t bar,
                                         int head, int row, int batch) {
#pragma unroll
  for (int c = 0; c < Dims<D>::kBoxes; ++c) {
    tma_load(dst + c * box_bytes, map, bar, c * kBox, head, row, batch);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose 8-row
// groups lie 1024 bytes apart.  K-major operands use only the stride byte
// offset; MN-major ones (N <= 64, one swizzle atom wide) use the same 1024
// bytes between 8-row groups along K, so both offsets carry it.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t kOff = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kOff << 16) | (kOff << 32) |
         (1ull << 62);
}

// move registers between warpgroups: the producer gives, consumers take
template <int kRegs>
__device__ __forceinline__ void regs_give() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most `kPending` committed wgmma groups are in flight
template <int kPending = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

#define WG_D8(d, o)                                                            \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),              \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (+)= A B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16), WG_D8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64nNk16, A (bf16 pairs) in registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t db);

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16), WG_D8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(d, 0), WG_D8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64n64 f32 accumulator as the A operands of four k16 steps: the
// accumulator's (row, column) layout per thread is the register A layout
// with columns as k, so each step packs eight consecutive values.
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// Accumulator layout of m64nN per thread t of a warpgroup: value i sits at
// row 16 (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and column
// 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}
__device__ __forceinline__ int acc_half(int i) { return (i / 2) % 2; }

// d += A(registers) x D columns of a tile from its box at `tile` on
// (MN-major, k = tile rows): a 64-wide product on the first box and a
// (D - 64)-wide one on the second
template <int D>
__device__ __forceinline__ void mma_rows(float (&d0)[32],
                                         float (&d1)[Dims<D>::kN1 > 0 ? Dims<D>::kN1 / 2 : 1],
                                         const uint32_t (&a)[4][4], uint32_t tile,
                                         uint32_t box_bytes) {
  static_assert(D <= 128, "a warpgroup accumulates at most two boxes");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_rs<64>(d0, a[kk], desc(tile + kk * 16 * kRowBytes));
    if constexpr (Dims<D>::kN1 > 0) {
      mma_rs<Dims<D>::kN1>(d1, a[kk], desc(tile + box_bytes + kk * 16 * kRowBytes));
    }
  }
}

// d = A B^T over D for A's 64 rows at `a_rows` and B's 64 rows at `b_rows`,
// both K-major (D contiguous) in 64-column boxes
template <int D>
__device__ __forceinline__ void mma_dots(float (&d)[32], uint32_t a_rows,
                                         uint32_t a_box, uint32_t b_rows,
                                         uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < Dims<D>::kKSteps; ++kk) {
    const uint32_t c = kk / 4, off = (kk % 4) * 32;
    mma_ss(d, desc(a_rows + c * a_box + off), desc(b_rows + c * b_box + off), kk > 0);
  }
}

// write a warpgroup's 64 x D accumulator rows (scaled) to columns [col0,
// col0 + D) of a (B, T, H, width) tensor, stopping at column `width`: a head
// narrower than the instantiation (a multiple of 8, so no column pair
// straddles it) keeps its accumulators' extra columns, which hold zeros
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&d0)[32],
                                           const float (&d1)[Dims<D>::kN1 > 0 ? Dims<D>::kN1 / 2 : 1],
                                           const float (&mul)[2], int row0, int t,
                                           int b, int heads, int h, int lane,
                                           int width, int col0 = 0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= t) continue;
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * t + row) * heads + h) * width + col0;
    const int cols = width - col0;   // the columns of this warpgroup's share
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * half;
      if (acc_col(i, lane) < cols) {
        *reinterpret_cast<__nv_bfloat162*>(dst + acc_col(i, lane)) =
            __floats2bfloat162_rn(d0[i] * mul[half], d0[i + 1] * mul[half]);
      }
    }
    if constexpr (Dims<D>::kN1 > 0) {
#pragma unroll
      for (int j = 0; j < Dims<D>::kN1 / 8; ++j) {
        const int i = 4 * j + 2 * half;
        if (kBox + acc_col(i, lane) < cols) {
          *reinterpret_cast<__nv_bfloat162*>(dst + kBox + acc_col(i, lane)) =
              __floats2bfloat162_rn(d1[i] * mul[half], d1[i + 1] * mul[half]);
        }
      }
    }
  }
}

// 2^x on the special-function unit (flushes subnormal results to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the quad of threads that shares an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory: 1024-byte-aligned tiles (the 128-byte swizzle repeats every
// 8 rows of 128 bytes), then the mbarriers.
__device__ __forceinline__ uint32_t aligned_base(uint8_t* raw) {
  return (smem_addr(raw) + 1023u) & ~1023u;
}

// The last key each of a thread's two accumulator rows (row0, row0 + 8)
// sees: the last below Tk, and with causal the row's diagonal (q_pos = row
// + Tk - Tq) or the last prefix key, whichever is later.  One comparison
// per score then masks an edge tile.
__device__ __forceinline__ void visible_keys(int (&last_key)[2], int row0, int q_off,
                                             int tk, int causal, int prefix_len) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    last_key[r] = causal ? min(tk - 1, max(row0 + 8 * r + q_off, prefix_len - 1)) : tk - 1;
  }
}

template <int D, int DV>
constexpr size_t fwd_smem() {
  return 1024 + Dims<D>::kBoxes * Split<D, DV>::kBlockBox +
         kFwdStages * (Dims<D>::kBoxes + Dims<DV>::kBoxes) * kTileBox + 8 * 8;
}

// Forward.  Grid (Hq, B, q tiles), the last q tile (the longest causal rows)
// first.  Warpgroup wg owns rows q0 + 64 (wg / kWays) ... and output columns
// (wg % kWays) kWV ...; the producer warp loads Q once and streams K and V
// tiles through the ring.  S = Q K^T runs over D, O += P V and the output
// over the warpgroup's columns of DV.
template <int D, int DV>
__global__ void __launch_bounds__(kThreadsH, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int tq, int tk,
           int hq, int hkv, int dv, float scale_log2, int causal, int prefix_len) {
  using G = Dims<D>;
  using GV = Dims<DV>;
  using S = Split<D, DV>;
  using GW = Dims<S::kWV>;   // the output columns of one warpgroup
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t k_stage = G::kBoxes * kTileBox, v_stage = GV::kBoxes * kTileBox;
  const uint32_t q_s = aligned_base(smem_raw);
  const uint32_t k_s = q_s + G::kBoxes * S::kBlockBox;
  const uint32_t v_s = k_s + kFwdStages * k_stage;
  const uint32_t bars = v_s + kFwdStages * v_stage;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kFwdStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kFwdStages + s); };

  const int n_blocks = (tq + S::kRows - 1) / S::kRows;
  const int h = static_cast<int>(blockIdx.x % hq);
  const unsigned hb = static_cast<unsigned>(hq) * (gridDim.x / (static_cast<unsigned>(hq) * n_blocks));
  const int b = static_cast<int>(blockIdx.x % hb / hq);
  const int q0 = (n_blocks - 1 - static_cast<int>(blockIdx.x / hb)) * S::kRows;
  const int hk = h / (hq / hkv);
  const int q_off = tk - tq;
  // causal: the keys up to the last row's diagonal, and the prefix
  const int k_end = causal ? min(tk, max(prefix_len, min(q0 + S::kRows, tq) + q_off)) : tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {   // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, G::kBoxes * S::kBlockBox);
      tma_rows<D>(q_s, S::kBlockBox, &q_map, q_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kFwdStages;
        if (i >= kFwdStages) mbar_wait(empty(s), ((i / kFwdStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), k_stage);
        tma_rows<D>(k_s + s * k_stage, kTileBox, &k_map, k_full(s), hk, i * kTile, b);
        mbar_expect_tx(v_full(s), v_stage);
        tma_rows<DV>(v_s + s * v_stage, kTileBox, &v_map, v_full(s), hk, i * kTile, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int part = wg % S::kWays;                       // the warpgroup's share of DV
  const int first = q0 + 64 * (wg / S::kWays);          // the warpgroup's first row
  const int row0 = first + 16 * (warp % 4) + lane / 4;  // this thread's rows: row0, row0 + 8
  int last_key[2];
  visible_keys(last_key, row0, q_off, tk, causal, prefix_len);
  float o0[32], o1[GW::kN1 > 0 ? GW::kN1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GW::kN1 > 0 ? GW::kN1 / 2 : 1); ++i) o1[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kFwdStages;
    const uint32_t ph = (i / kFwdStages) & 1;
    const int k0 = i * kTile;
    // a tile wholly after this warpgroup's last diagonal and past the
    // prefix adds nothing
    const bool live = !causal || k0 <= first + 63 + q_off || k0 < prefix_len;
    mbar_wait(k_full(s), ph);
    if (live) {
      float sc[32];
      wg_fence();
      mma_dots<D>(sc, q_s + 64 * (wg / S::kWays) * kRowBytes, S::kBlockBox,
                  k_s + s * k_stage, kTileBox);
      wg_commit();
      wg_wait();
      hold(sc);

      // a key is hidden from a row past Tk, or (causal) after the row's
      // diagonal and past the prefix
      const bool edge = k0 + kTile > tk ||
                        (causal && k0 + kTile - 1 > first + q_off && k0 + kTile > prefix_len);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * scale_log2;
        if (edge && k0 + acc_col(j, lane) > last_key[acc_half(j)]) x = kNegInf;
        sc[j] = x;
        mx[acc_half(j)] = fmaxf(mx[acc_half(j)], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = ex2(sc[j] - m[acc_half(j)]);
        l[acc_half(j)] += p;
        sc[j] = p;
        o0[j] *= corr[acc_half(j)];
      }
#pragma unroll
      for (int j = 0; j < (GW::kN1 > 0 ? GW::kN1 / 2 : 0); ++j) o1[j] *= corr[acc_half(j)];
      uint32_t a[4][4];
      to_a(sc, a);

      mbar_wait(v_full(s), ph);
      wg_fence();
      hold(o0);
      hold(o1);
      mma_rows<S::kWV>(o0, o1, a, v_s + s * v_stage + part * (S::kWV / kBox) * kTileBox,
                       kTileBox);
      wg_commit();
      wg_wait();
      hold(o0);
      hold(o1);
      hold(a);
    }
    mbar_arrive(empty(s));
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  store_rows<S::kWV>(o, o0, o1, inv, row0, tq, b, hq, h, lane, dv, part * S::kWV);
  if (lane % 4 == 0 && part == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < tq) {
        lse[(static_cast<size_t>(b) * hq + h) * tq + row] = m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

// delta[b, h, t] = dO[b, t, h] . O[b, t, h].  Rows of (B, T, H, D) are
// contiguous, so a warp reads its 8 rows as one span of 16-byte loads,
// keeps each load's dot product in shared memory, and lane r < 8 sums row
// r's in order.  A row of d <= 256 columns is at most 32 loads.
constexpr int kDeltaWarps = 8, kDeltaRows = 8, kDeltaLoads = 256 / 8;

__global__ void __launch_bounds__(kDeltaWarps * 32)
delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, long long rows, int tq, int hq, int d) {
  __shared__ float part[kDeltaWarps][kDeltaRows * kDeltaLoads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kDeltaWarps + warp) * kDeltaRows;
  if (row0 >= rows) return;
  const int per_row = d / 8;
  const int n = static_cast<int>(min(static_cast<long long>(kDeltaRows), rows - row0));
  const uint4* op = reinterpret_cast<const uint4*>(o + row0 * d);
  const uint4* gp = reinterpret_cast<const uint4*>(dout + row0 * d);
  for (int u = lane; u < n * per_row; u += 32) {
    const uint4 x = op[u], y = gp[u];
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(xs[e]), c = __bfloat1622float2(ys[e]);
      sum += a.x * c.x + a.y * c.y;
    }
    part[warp][u] = sum;
  }
  __syncwarp();
  if (lane < n) {
    float sum = 0.f;
    for (int c = 0; c < per_row; ++c) sum += part[warp][lane * per_row + c];
    const long long row = row0 + lane;
    const int h = static_cast<int>(row % hq);
    const long long bt = row / hq;
    delta[(bt / tq * hq + h) * tq + bt % tq] = sum;
  }
}

template <int D, int DV>
constexpr size_t dq_smem() {
  using S = Split<D, DV>;
  return 1024 + (Dims<D>::kBoxes + Dims<DV>::kBoxes) *
                    (S::kBlockBox + S::kBwdStages * kTileBox) +
         8 * 8;
}

// dQ.  Grid (Hq, B, q tiles), longest causal rows first; the producer loads
// Q and dO once and streams K and V tiles up to the diagonal (and over the
// prefix).  S = Q K^T runs over D and dP = dO V^T over DV; dQ = dS K over
// the warpgroup's columns of D.
template <int D, int DV>
__global__ void __launch_bounds__(kThreadsH, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map,
          const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map,
          const __grid_constant__ CUtensorMap do_map,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int tq, int tk, int hq, int hkv, int d,
          float scale, float scale_log2, int causal, int prefix_len) {
  using G = Dims<D>;
  using GV = Dims<DV>;
  using S = Split<D, DV>;
  using GW = Dims<S::kW>;   // the dQ columns of one warpgroup
  constexpr int kSt = S::kBwdStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t k_stage = G::kBoxes * kTileBox, v_stage = GV::kBoxes * kTileBox;
  const uint32_t q_s = aligned_base(smem_raw);
  const uint32_t do_s = q_s + G::kBoxes * S::kBlockBox;
  const uint32_t k_s = do_s + GV::kBoxes * S::kBlockBox;
  const uint32_t v_s = k_s + kSt * k_stage;
  const uint32_t bars = v_s + kSt * v_stage;
  const uint32_t qd_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kSt + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kSt + s); };

  const int n_blocks = (tq + S::kRows - 1) / S::kRows;
  const int h = static_cast<int>(blockIdx.x % hq);
  const unsigned hb = static_cast<unsigned>(hq) * (gridDim.x / (static_cast<unsigned>(hq) * n_blocks));
  const int b = static_cast<int>(blockIdx.x % hb / hq);
  const int q0 = (n_blocks - 1 - static_cast<int>(blockIdx.x / hb)) * S::kRows;
  const int hk = h / (hq / hkv);
  const int q_off = tk - tq;
  const int k_end = causal ? min(tk, max(prefix_len, min(q0 + S::kRows, tq) + q_off)) : tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {   // producer
    if (lane == 0) {
      mbar_expect_tx(qd_full, (G::kBoxes + GV::kBoxes) * S::kBlockBox);
      tma_rows<D>(q_s, S::kBlockBox, &q_map, qd_full, h, q0, b);
      tma_rows<DV>(do_s, S::kBlockBox, &do_map, qd_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kSt;
        if (i >= kSt) mbar_wait(empty(s), ((i / kSt) & 1) ^ 1);
        mbar_expect_tx(k_full(s), k_stage);
        tma_rows<D>(k_s + s * k_stage, kTileBox, &k_map, k_full(s), hk, i * kTile, b);
        mbar_expect_tx(v_full(s), v_stage);
        tma_rows<DV>(v_s + s * v_stage, kTileBox, &v_map, v_full(s), hk, i * kTile, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int part = wg % S::kWays;                       // the warpgroup's share of D
  const int first = q0 + 64 * (wg / S::kWays);
  const int row0 = first + 16 * (warp % 4) + lane / 4;
  int last_key[2];
  visible_keys(last_key, row0, q_off, tk, causal, prefix_len);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (static_cast<size_t>(b) * hq + h) * tq + min(row0 + 8 * r, tq - 1);
    lse2[r] = lse[at] * kLog2e;
    dlt[r] = delta[at];
  }
  float g0[32], g1[GW::kN1 > 0 ? GW::kN1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) g0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GW::kN1 > 0 ? GW::kN1 / 2 : 1); ++i) g1[i] = 0.f;

  // Only the tiles up to this warpgroup's last diagonal or over the prefix
  // (the first n_live) are computed, and dS K of tile i - 1 runs on the
  // tensor cores while dS of tile i is formed.
  const int n_live =
      causal ? min(n_tiles, max((first + 63 + q_off) / kTile + 1, (prefix_len + kTile - 1) / kTile))
             : n_tiles;
  const uint32_t my_q = q_s + 64 * (wg / S::kWays) * kRowBytes;
  const uint32_t my_do = do_s + 64 * (wg / S::kWays) * kRowBytes;
  const uint32_t my_cols = part * (S::kW / kBox) * kTileBox;   // K's columns of my dQ
  auto dots = [&](float (&sc)[32], float (&dp)[32], int i) {
    const int s = i % kSt;
    mbar_wait(k_full(s), (i / kSt) & 1);
    mbar_wait(v_full(s), (i / kSt) & 1);
    wg_fence();
    mma_dots<D>(sc, my_q, S::kBlockBox, k_s + s * k_stage, kTileBox);
    mma_dots<DV>(dp, my_do, S::kBlockBox, v_s + s * v_stage, kTileBox);
    wg_commit();
  };
  auto grad = [&](const uint32_t (&a)[4][4], int i) {
    wg_fence();
    hold(g0);
    hold(g1);
    mma_rows<S::kW>(g0, g1, a, k_s + (i % kSt) * k_stage + my_cols, kTileBox);
    wg_commit();
  };
  // sc (scores) -> dS = P (dP - delta) in place
  auto dscores = [&](float (&sc)[32], const float (&dp)[32], int i) {
    const int k0 = i * kTile;
    const bool edge = k0 + kTile > tk ||
                      (causal && k0 + kTile - 1 > first + q_off && k0 + kTile > prefix_len);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = acc_half(j);
      float p = ex2(sc[j] * scale_log2 - lse2[r]);
      if (edge && k0 + acc_col(j, lane) > last_key[r]) p = 0.f;
      sc[j] = p * (dp[j] - dlt[r]);
    }
  };

  mbar_wait(qd_full, 0);
  float sc[32], dp[32];
  uint32_t a[4][4];
  dots(sc, dp, 0);
  wg_wait();
  hold(sc);
  hold(dp);
  dscores(sc, dp, 0);
  to_a(sc, a);
  for (int i = 1; i < n_live; ++i) {
    dots(sc, dp, i);
    grad(a, i - 1);
    wg_wait<1>();   // S and dP of tile i; dS K of tile i - 1 still runs
    hold(sc);
    hold(dp);
    dscores(sc, dp, i);
    wg_wait();
    hold(g0);
    hold(g1);
    hold(a);
    mbar_arrive(empty((i - 1) % kSt));
    to_a(sc, a);
  }
  grad(a, n_live - 1);
  wg_wait();
  hold(g0);
  hold(g1);
  hold(a);
  mbar_arrive(empty((n_live - 1) % kSt));
  for (int i = n_live; i < n_tiles; ++i) {
    mbar_wait(k_full(i % kSt), (i / kSt) & 1);
    mbar_arrive(empty(i % kSt));
  }
  const float mul[2] = {scale, scale};
  store_rows<S::kW>(dq, g0, g1, mul, row0, tq, b, hq, h, lane, d, part * S::kW);
}

template <int D, int DV>
constexpr size_t dkdv_smem() {
  using S = Split<D, DV>;
  return 1024 + (Dims<D>::kBoxes + Dims<DV>::kBoxes) *
                    (S::kBlockBox + S::kBwdStages * kTileBox) +
         S::kBwdStages * 2 * kTile * sizeof(float) + 8 * 8;
}

// dK and dV.  Grid (Hkv, B, k tiles), the first keys (the most q tiles)
// first.  Warpgroup wg owns keys k0 + 64 (wg / kWays) ... and its share
// (wg % kWays) of the columns; the producer loads K and V once and streams,
// for each head of the group in turn, the Q and dO tiles from the diagonal
// on (from the first, where the block holds prefix keys) with their rows'
// lse and delta.  S^T = K Q^T runs over D and dP^T = V dO^T over DV; dK =
// dS^T Q and dV = P^T dO over the warpgroup's columns of D and DV.
template <int D, int DV>
__global__ void __launch_bounds__(kThreadsKV, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            const __grid_constant__ CUtensorMap do_map,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int tq,
            int tk, int hq, int hkv, int d, int d_v, float scale, float scale_log2,
            int causal, int prefix_len) {
  using G = Dims<D>;
  using GV = Dims<DV>;
  using S = Split<D, DV>;
  using GW = Dims<S::kW>;     // the dK columns of one warpgroup
  using GWV = Dims<S::kWV>;   // and its dV columns
  constexpr int kSt = S::kBwdStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_stage = G::kBoxes * kTileBox, do_stage = GV::kBoxes * kTileBox;
  const uint32_t k_s = aligned_base(smem_raw);
  const uint32_t v_s = k_s + G::kBoxes * S::kBlockBox;
  const uint32_t q_s = v_s + GV::kBoxes * S::kBlockBox;
  const uint32_t do_s = q_s + kSt * q_stage;
  const uint32_t stats = do_s + kSt * do_stage;   // (lse2, delta) per stage
  const uint32_t bars = stats + kSt * 2 * kTile * sizeof(float);
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kSt + s); };
  // generic pointer to the stats, for plain loads and stores
  float* stats_p = reinterpret_cast<float*>(smem_raw + (stats - smem_addr(smem_raw)));

  const int hk = static_cast<int>(blockIdx.x % hkv);
  const unsigned hb = gridDim.x / ((tk + S::kRows - 1) / S::kRows);
  const int b = static_cast<int>(blockIdx.x % hb / hkv);
  const int k0 = static_cast<int>(blockIdx.x / hb) * S::kRows;
  const int g = hq / hkv;
  const int q_off = tk - tq;
  // the first q tile with a row that sees any of these keys (every row
  // sees a prefix key)
  const int q_begin = causal && k0 >= prefix_len ? max(0, k0 - q_off) / kTile * kTile : 0;
  const int per_head = (tq - q_begin + kTile - 1) / kTile;
  const int n_steps = g * max(per_head, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {   // producer: lse and delta by warp 8, tiles by its lane 0
    regs_give<kProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, (G::kBoxes + GV::kBoxes) * S::kBlockBox);
      tma_rows<D>(k_s, S::kBlockBox, &k_map, kv_full, hk, k0, b);
      tma_rows<DV>(v_s, S::kBlockBox, &v_map, kv_full, hk, k0, b);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kSt;
      const int h = hk * g + i / per_head;
      const int qs = q_begin + (i % per_head) * kTile;
      if (i >= kSt) mbar_wait(empty(s), ((i / kSt) & 1) ^ 1);
      float* st = stats_p + s * 2 * kTile;
      for (int r = lane; r < kTile; r += 32) {
        const int row = qs + r;
        const size_t at = (static_cast<size_t>(b) * hq + h) * tq + row;
        st[r] = row < tq ? lse[at] * kLog2e : 0.f;
        st[kTile + r] = row < tq ? delta[at] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full(s), q_stage + do_stage);
        tma_rows<D>(q_s + s * q_stage, kTileBox, &q_map, full(s), h, qs, b);
        tma_rows<DV>(do_s + s * do_stage, kTileBox, &do_map, full(s), h, qs, b);
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  regs_take<kConsumerRegs>();
  const int wg = warp / 4;
  const int part = wg % S::kWays;                       // the warpgroup's share of D, DV
  const int first = k0 + 64 * (wg / S::kWays);          // the warpgroup's first key
  const int key0 = first + 16 * (warp % 4) + lane / 4;  // this thread's keys: key0, key0 + 8
  // the first row that sees each of this thread's keys (none past Tk;
  // causal: the key's diagonal, unless it is in the prefix)
  int first_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    first_row[h] = key >= tk ? INT_MAX : causal && key >= prefix_len ? key - q_off : 0;
  }
  float dk0[32], dk1[GW::kN1 > 0 ? GW::kN1 / 2 : 1];
  float dv0[32], dv1[GWV::kN1 > 0 ? GWV::kN1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk0[i] = dv0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GW::kN1 > 0 ? GW::kN1 / 2 : 1); ++i) dk1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GWV::kN1 > 0 ? GWV::kN1 / 2 : 1); ++i) dv1[i] = 0.f;

  mbar_wait(kv_full, 0);
  const uint32_t my_k = k_s + 64 * (wg / S::kWays) * kRowBytes;
  const uint32_t my_v = v_s + 64 * (wg / S::kWays) * kRowBytes;
  // the columns of the streamed Q and dO tiles that my dK and dV take
  const uint32_t q_cols = part * (S::kW / kBox) * kTileBox;
  const uint32_t do_cols = part * (S::kWV / kBox) * kTileBox;
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kSt;
    const uint32_t ph = (i / kSt) & 1;
    const int qs = q_begin + (i % per_head) * kTile;
    // a q tile whose last row is before this warpgroup's first key adds
    // nothing, unless that key is in the prefix
    const bool live = !causal || qs + kTile - 1 + q_off >= first || first < prefix_len;
    mbar_wait(full(s), ph);
    if (live) {
      const float* st = stats_p + s * 2 * kTile;
      const bool edge = qs + kTile > tq || first + 64 > tk ||
                        (causal && first + 63 > qs + q_off && first + 64 > prefix_len);
      float sc[32], dp[32];
      wg_fence();
      mma_dots<D>(sc, my_k, S::kBlockBox, q_s + s * q_stage, kTileBox);
      mma_dots<DV>(dp, my_v, S::kBlockBox, do_s + s * do_stage, kTileBox);
      wg_commit();
      wg_wait();
      hold(sc);
      hold(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = acc_col(j, lane);
        float p = ex2(sc[j] * scale_log2 - st[col]);
        if (edge && (qs + col < first_row[acc_half(j)] || qs + col >= tq)) p = 0.f;
        sc[j] = p;
        dp[j] = p * (dp[j] - st[kTile + col]);
      }
      uint32_t ap[4][4], ads[4][4];
      to_a(sc, ap);
      to_a(dp, ads);
      wg_fence();
      hold(dv0);
      hold(dv1);
      hold(dk0);
      hold(dk1);
      mma_rows<S::kWV>(dv0, dv1, ap, do_s + s * do_stage + do_cols, kTileBox);
      mma_rows<S::kW>(dk0, dk1, ads, q_s + s * q_stage + q_cols, kTileBox);
      wg_commit();
      wg_wait();
      hold(dv0);
      hold(dv1);
      hold(dk0);
      hold(dk1);
      hold(ap);
      hold(ads);
    }
    mbar_arrive(empty(s));
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows<S::kWV>(dv, dv0, dv1, one, key0, tk, b, hkv, hk, lane, d_v, part * S::kWV);
  store_rows<S::kW>(dk, dk0, dk1, mul, key0, tk, b, hkv, hk, lane, d, part * S::kW);
}


// ---------------------------------------------------------------------- //
// bfloat16 past 256 columns: the same skeleton, every operand streamed
// ---------------------------------------------------------------------- //

// A block owns 64 rows and one slice of at most kSliceW output columns;
// its two consumer warpgroups take two 64-column boxes of the slice each
// (D 256's Split footprint: 64 accumulator registers a thread per
// output).  The contractions (Q K^T over D, dO V^T over Dv) stream
// through a ring of (A box, B box) pairs, 64 rows by 64 columns each, so
// shared memory does not grow with the width; the slice's operand (V, K,
// Q or dO, 64 rows by up to four boxes) streams through a second ring.
// The two warpgroups split each contraction's boxes (pair i to warpgroup
// i % 2) and add each other's partial sums through shared memory, so the
// scores are computed once per block; a + b == b + a in IEEE arithmetic,
// so both hold the same bits.  The tiles wait on the pairs' latency more
// than on any bandwidth, so the pair ring takes the room (8 stages) and
// the slice ring one stage, whose next tile loads under the next scores
// (4 / 6 pair stages and two slice stages, or 10 with one exchange buffer,
// measured slower on the H100).  Where V is wider than 256 and the grid
// large (fwd_wide_bf16) the forward's slices are 512 columns, four boxes
// a warpgroup (Wide512): the scores are then computed once for twice the
// columns, the slice tile takes the room of two pair stages, and the
// producer's warpgroup hands its registers to the consumers (at 168 a
// thread their 128 accumulators spilled and ptxas serialised the wgmma).
constexpr int kSliceStages = 1;
constexpr uint32_t kPairBytes = 2 * kTileBox;             // 16 KB
// a partial accumulator of each warpgroup, double-buffered
constexpr uint32_t kXchBytes = 2 * 2 * 32 * kWG * sizeof(float);   // 64 KB

// the rings in shared memory: 1024-byte-aligned pairs (kPairs stages) and
// slice tiles (kBoxes boxes), the exchange buffers, the slice rows' (lse2,
// delta) beside each slice stage, then the barriers
template <int kPairs, int kBoxes>
struct WideSmem {
  static constexpr int kPairStages = kPairs;
  static constexpr int kSliceBoxes = kBoxes;
  static constexpr uint32_t kSliceBytes = kBoxes * kTileBox;
  static constexpr size_t bytes() {
    return 1024 + kPairs * kPairBytes + kSliceStages * kSliceBytes + kXchBytes +
           kSliceStages * 2 * kTile * sizeof(float) + 2 * (kPairs + kSliceStages) * 8;
  }
  uint32_t pairs, slices, bars;
  float* xch;     // generic pointers, for plain loads and stores
  float* stats;
  __device__ explicit WideSmem(uint8_t* raw) {
    pairs = aligned_base(raw);
    slices = pairs + kPairStages * kPairBytes;
    const uint32_t x = slices + kSliceStages * kSliceBytes;
    const uint32_t st = x + kXchBytes;
    xch = reinterpret_cast<float*>(raw + (x - smem_addr(raw)));
    stats = reinterpret_cast<float*>(raw + (st - smem_addr(raw)));
    bars = st + kSliceStages * 2 * kTile * sizeof(float);
  }
  __device__ uint32_t pair_full(int s) const { return bars + 8 * s; }
  __device__ uint32_t pair_empty(int s) const { return bars + 8 * (kPairStages + s); }
  __device__ uint32_t slice_full(int s) const { return bars + 8 * (2 * kPairStages + s); }
  __device__ uint32_t slice_empty(int s) const {
    return bars + 8 * (2 * kPairStages + kSliceStages + s);
  }
  // thread 0, before the block's first __syncthreads: a pair is filled by
  // the producer's lane 0 and emptied by the warpgroup that takes it; a
  // slice stage is filled by the producer's 32 lanes (lane 0's TMA, the
  // others' stats) and emptied by both consumer warpgroups
  __device__ void init() const {
    for (int s = 0; s < kPairStages; ++s) {
      mbar_init(pair_full(s), 1);
      mbar_init(pair_empty(s), kWG);
    }
    for (int s = 0; s < kSliceStages; ++s) {
      mbar_init(slice_full(s), 32);
      mbar_init(slice_empty(s), 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
};
// slices of 256 columns, two boxes a warpgroup: the backward, and the
// forward where V is at most 256 wide; the forward's slices of 512
using Wide256 = WideSmem<8, 4>;
using Wide512 = WideSmem<6, 8>;
static_assert(Wide256::bytes() <= 232448 && Wide512::bytes() <= 232448,
              "the wide kernels' shared memory");

// producer, lane 0: pair `pi` of the ring, box `col` of rows [ra, ra + 64)
// of head ha of A and of rows [rb, rb + 64) of head hb of B
template <typename SM>
__device__ __forceinline__ void put_pair(const SM& sm, int& pi, const CUtensorMap* ma,
                                         int ha, int ra, const CUtensorMap* mb, int hb,
                                         int rb, int col, int batch) {
  constexpr int kPairStages = SM::kPairStages;
  const int s = pi % kPairStages;
  if (pi >= kPairStages) mbar_wait(sm.pair_empty(s), ((pi / kPairStages) & 1) ^ 1);
  const uint32_t dst = sm.pairs + s * kPairBytes;
  mbar_expect_tx(sm.pair_full(s), kPairBytes);
  tma_load(dst, ma, sm.pair_full(s), col, ha, ra, batch);
  tma_load(dst + kTileBox, mb, sm.pair_full(s), col, hb, rb, batch);
  ++pi;
}

// producer warp: slice stage of step t, `boxes` boxes from column c_lo of
// rows [row, row + 64) of one head; each lane first writes its share of
// the stats (`stats(stage's stats)`)
template <typename SM, typename F>
__device__ __forceinline__ void put_slice(const SM& sm, int t, const CUtensorMap* map,
                                          int head, int row, int batch, int c_lo,
                                          int boxes, int lane, F&& stats) {
  constexpr uint32_t kSliceBytes = SM::kSliceBytes;
  const int s = t % kSliceStages;
  if (t >= kSliceStages) mbar_wait(sm.slice_empty(s), ((t / kSliceStages) & 1) ^ 1);
  stats(sm.stats + s * 2 * kTile);
  if (lane == 0) {
    mbar_expect_tx(sm.slice_full(s), boxes * kTileBox);
    for (int j = 0; j < boxes; ++j) {
      tma_load(sm.slices + s * kSliceBytes + j * kTileBox, map, sm.slice_full(s),
               c_lo + j * kBox, head, row, batch);
    }
  } else {
    mbar_arrive(sm.slice_full(s));
  }
}

// one box of a contraction: d (+)= A B^T over its 64 columns (zero past the
// true width, from the TMA fill), four k steps, fenced as a batch of its own
// (the wait on its pair spins while the last box's products run)
template <typename SM>
__device__ __forceinline__ void box_dots(const SM& sm, float (&d)[32], int pi, bool first) {
  constexpr int kPairStages = SM::kPairStages;
  const int s = pi % kPairStages;
  mbar_wait(sm.pair_full(s), (pi / kPairStages) & 1);
  const uint32_t a = sm.pairs + s * kPairBytes;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_ss(d, desc(a + kk * 32), desc(a + kTileBox + kk * 32), !first || kk > 0);
  }
  wg_commit();
}

// consumer warpgroup wg: its part of d = A B^T over the `boxes` pairs of
// the ring from pair pi on (pair i is warpgroup i % 2's), box after box
// into one accumulator, each pair handed back once its products are done
// while the next box's run; zero where it has no box.  pi moves past all
// of them.
template <typename SM>
__device__ __forceinline__ void ring_dots(const SM& sm, float (&d)[32], int& pi, int boxes,
                                          int wg) {
  constexpr int kPairStages = SM::kPairStages;
  int c = (wg ^ pi) & 1;
  if (c < boxes) {
    box_dots(sm, d, pi + c, true);
    for (c += 2; c < boxes; c += 2) {
      box_dots(sm, d, pi + c, false);
      wg_wait<1>();
      mbar_arrive(sm.pair_empty((pi + c - 2) % kPairStages));
    }
    wg_wait();
    hold(d);
    mbar_arrive(sm.pair_empty((pi + c - 2) % kPairStages));
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
  }
  pi += boxes;
}

// both consumer warpgroups: d = my partial + the other's (exchange n of
// the block, buffer n % 2; the barrier of exchange n + 1 keeps buffer n % 2
// from being rewritten before it is read)
template <typename SM>
__device__ __forceinline__ void exchange(const SM& sm, float (&d)[32], int& n, int wg) {
  const int t = threadIdx.x % kWG;
  float* buf = sm.xch + (n & 1) * 2 * 32 * kWG;
#pragma unroll
  for (int i = 0; i < 32; ++i) buf[(wg * 32 + i) * kWG + t] = d[i];
  asm volatile("bar.sync 1, %0;" ::"n"(2 * kWG) : "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += buf[((1 - wg) * 32 + i) * kWG + t];
  ++n;
}

// consumer warpgroup: acc[w] += A x box first + w of step t's slice tile,
// w < kW, then the stage is handed back.  A box past the slice's live
// ones holds stale data: it feeds only accumulator columns past the true
// width, which are never stored.
template <int kW, typename SM>
__device__ __forceinline__ void slice_product(const SM& sm, float (&acc)[kW][32],
                                              uint32_t (&a)[4][4], int t, int first) {
  const int s = t % kSliceStages;
  const uint32_t tile = sm.slices + s * SM::kSliceBytes + first * kTileBox;
  wg_fence();
#pragma unroll
  for (int w = 0; w < kW; ++w) hold(acc[w]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      mma_rs<64>(acc[w], a[kk], desc(tile + w * kTileBox + kk * 16 * kRowBytes));
    }
  }
  wg_commit();
  wg_wait();
#pragma unroll
  for (int w = 0; w < kW; ++w) hold(acc[w]);
  hold(a);
  mbar_arrive(sm.slice_empty(s));
}

template <typename SM>
__device__ __forceinline__ void slice_wait(const SM& sm, int t) {
  mbar_wait(sm.slice_full(t % kSliceStages), (t / kSliceStages) & 1);
}

// Forward past 256.  Grid (Dv slices x Hq, B, 64-row q tiles), the last q
// tile (the longest causal rows) first.  Both consumer warpgroups take
// the block's 64 rows and compute S = Q K^T over all of D, streamed in
// (Q box, K box) pairs; each adds P V over its kW boxes of the slice
// (slices of 2 kW boxes: 256 columns, or 512 where V is wider than 256).
template <int kW>
__global__ void __launch_bounds__(kW == 4 ? kThreadsKV : kThreadsH, 1)
wide_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int batch,
                int tq, int tk, int hq, int hkv, int d, int dv, int slices,
                float scale_log2, int causal, int prefix_len) {
  using SM = std::conditional_t<kW == 2, Wide256, Wide512>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const SM sm(smem_raw);
  const unsigned x = blockIdx.x, hs = static_cast<unsigned>(hq) * slices;
  const int sl = static_cast<int>(x % slices);
  const int h = static_cast<int>(x / slices % hq);
  const int b = static_cast<int>(x / hs % batch);
  const int n_rt = (tq + kTile - 1) / kTile;
  const int q0 = (n_rt - 1 - static_cast<int>(x / hs / batch)) * kTile;
  const int hk = h / (hq / hkv);
  const int q_off = tk - tq;
  const int c_lo = sl * SM::kSliceBoxes * kBox;
  const int k_end = causal ? min(tk, max(prefix_len, min(q0 + kTile, tq) + q_off)) : tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int n_d = (d + kBox - 1) / kBox;
  const int n_sb = min(SM::kSliceBoxes, (dv - c_lo + kBox - 1) / kBox);

  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {   // producer: warp 8 (with four boxes a warpgroup, its
                     // warpgroup gives its registers to the consumers)
    if (kW == 4) {
      regs_give<kProducerRegs>();
      if (warp > 8) return;
    }
    int pi = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (lane == 0) {
        for (int c = 0; c < n_d; ++c) {
          put_pair(sm, pi, &q_map, h, q0, &k_map, hk, t * kTile, c * kBox, b);
        }
      }
      __syncwarp();
      put_slice(sm, t, &v_map, hk, t * kTile, b, c_lo, n_sb, lane, [](float*) {});
    }
    return;
  }

  if (kW == 4) regs_take<kConsumerRegs>();
  const int wg = warp / 4;
  const int row0 = q0 + 16 * (warp % 4) + lane / 4;
  int last_key[2];
  visible_keys(last_key, row0, q_off, tk, causal, prefix_len);
  float o[kW][32];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[w][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int pi = 0, n_x = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    float sc[32];
    ring_dots(sm, sc, pi, n_d, wg);
    exchange(sm, sc, n_x, wg);
    const bool edge = k0 + kTile > tk ||
                      (causal && k0 + kTile - 1 > q0 + q_off && k0 + kTile > prefix_len);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float s = sc[j] * scale_log2;
      if (edge && k0 + acc_col(j, lane) > last_key[acc_half(j)]) s = kNegInf;
      sc[j] = s;
      mx[acc_half(j)] = fmaxf(mx[acc_half(j)], s);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = ex2(sc[j] - m[acc_half(j)]);
      l[acc_half(j)] += p;
      sc[j] = p;
#pragma unroll
      for (int w = 0; w < kW; ++w) o[w][j] *= corr[acc_half(j)];
    }
    uint32_t a[4][4];
    to_a(sc, a);
    slice_wait(sm, t);
    slice_product(sm, o, a, t, kW * wg);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int w = 0; w < kW; w += 2) {
    store_rows<128>(out, o[w], o[w + 1], inv, row0, tq, b, hq, h, lane, dv,
                    c_lo + (kW * wg + w) * kBox);
  }
  if (lane % 4 == 0 && wg == 0 && sl == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < tq) {
        lse[(static_cast<size_t>(b) * hq + h) * tq + row] = m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

// dQ past 256.  Grid (D slices x Hq, B, 64-row q tiles), longest causal
// rows first.  Per k tile both warpgroups compute S = Q K^T over D and dP
// = dO V^T over Dv, streamed in pairs; each adds dS K over its two boxes
// of the slice of K's columns.
__global__ void __launch_bounds__(kThreadsH, 1)
wide_dq_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int batch, int tq, int tk, int hq,
               int hkv, int d, int dv, int slices, float scale, float scale_log2,
               int causal, int prefix_len) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Wide256 sm(smem_raw);
  const unsigned x = blockIdx.x, hs = static_cast<unsigned>(hq) * slices;
  const int sl = static_cast<int>(x % slices);
  const int h = static_cast<int>(x / slices % hq);
  const int b = static_cast<int>(x / hs % batch);
  const int n_rt = (tq + kTile - 1) / kTile;
  const int q0 = (n_rt - 1 - static_cast<int>(x / hs / batch)) * kTile;
  const int hk = h / (hq / hkv);
  const int q_off = tk - tq;
  const int c_lo = sl * kSliceW;
  const int k_end = causal ? min(tk, max(prefix_len, min(q0 + kTile, tq) + q_off)) : tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int n_d = (d + kBox - 1) / kBox, n_dv = (dv + kBox - 1) / kBox;
  const int n_sb = min(Wide256::kSliceBoxes, (d - c_lo + kBox - 1) / kBox);

  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {   // producer
    int pi = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (lane == 0) {
        for (int c = 0; c < n_d; ++c) {
          put_pair(sm, pi, &q_map, h, q0, &k_map, hk, t * kTile, c * kBox, b);
        }
        for (int c = 0; c < n_dv; ++c) {
          put_pair(sm, pi, &do_map, h, q0, &v_map, hk, t * kTile, c * kBox, b);
        }
      }
      __syncwarp();
      put_slice(sm, t, &k_map, hk, t * kTile, b, c_lo, n_sb, lane, [](float*) {});
    }
    return;
  }

  const int wg = warp / 4;
  const int row0 = q0 + 16 * (warp % 4) + lane / 4;
  int last_key[2];
  visible_keys(last_key, row0, q_off, tk, causal, prefix_len);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (static_cast<size_t>(b) * hq + h) * tq + min(row0 + 8 * r, tq - 1);
    lse2[r] = lse[at] * kLog2e;
    dlt[r] = delta[at];
  }
  float g[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) g[0][i] = g[1][i] = 0.f;

  int pi = 0, n_x = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    float sc[32], dp[32];
    ring_dots(sm, sc, pi, n_d, wg);
    ring_dots(sm, dp, pi, n_dv, wg);
    exchange(sm, sc, n_x, wg);
    exchange(sm, dp, n_x, wg);
    const bool edge = k0 + kTile > tk ||
                      (causal && k0 + kTile - 1 > q0 + q_off && k0 + kTile > prefix_len);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = acc_half(j);
      float p = ex2(sc[j] * scale_log2 - lse2[r]);
      if (edge && k0 + acc_col(j, lane) > last_key[r]) p = 0.f;
      sc[j] = p * (dp[j] - dlt[r]);
    }
    uint32_t a[4][4];
    to_a(sc, a);
    slice_wait(sm, t);
    slice_product(sm, g, a, t, 2 * wg);
  }
  const float mul[2] = {scale, scale};
  store_rows<128>(dq, g[0], g[1], mul, row0, tq, b, hq, h, lane, d, c_lo + 2 * wg * kBox);
}

// dK and dV past 256.  Grid (slices x head groups x Hkv, B, 64-key tiles),
// the first keys (the most q tiles) first; slices = D's slices (dK) then
// Dv's (dV).  For each query head of its group and each q tile from the
// diagonal on, both warpgroups compute S^T = K Q^T over D (and, for dK,
// dP^T = V dO^T over Dv), streamed in pairs; each adds dS^T Q (dK) or P^T
// dO (dV) over its two boxes of the slice.  The producer's lanes write the
// q tile's lse and delta beside its slice stage.  With one group a block
// stores dK (times scale) or dV; with more (a kv head's query heads split
// over `groups` blocks, so that a long causal GQA run fills the card),
// each stores its f32 partial sums in `part` and wide_dkdv_combine adds
// them in group order.
__global__ void __launch_bounds__(kThreadsH, 1)
wide_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 float* __restrict__ part, int batch, int tq, int tk, int hq, int hkv,
                 int d, int d_v, int dk_slices, int dv_slices, int groups, float scale,
                 float scale_log2, int causal, int prefix_len) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Wide256 sm(smem_raw);
  const int slices = dk_slices + dv_slices;
  const unsigned x = blockIdx.x, sg = static_cast<unsigned>(slices) * groups;
  const unsigned hs = sg * static_cast<unsigned>(hkv);
  const int sl = static_cast<int>(x % slices);
  const int grp = static_cast<int>(x / slices % groups);
  const int hk = static_cast<int>(x / sg % hkv);
  const int b = static_cast<int>(x / hs % batch);
  const int k0 = static_cast<int>(x / hs / batch) * kTile;
  const bool is_dk = sl < dk_slices;
  const int width = is_dk ? d : d_v;
  const int c_lo = (is_dk ? sl : sl - dk_slices) * kSliceW;
  const int gs = hq / hkv / groups;   // the query heads of this block's group
  const int h0 = hk * (hq / hkv) + grp * gs;
  const int q_off = tk - tq;
  const int q_begin = causal && k0 >= prefix_len ? max(0, k0 - q_off) / kTile * kTile : 0;
  const int per_head = (tq - q_begin + kTile - 1) / kTile;
  const int n_steps = gs * per_head;
  const int n_d = (d + kBox - 1) / kBox, n_dv = (d_v + kBox - 1) / kBox;
  const int n_sb = min(Wide256::kSliceBoxes, (width - c_lo + kBox - 1) / kBox);

  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {   // producer
    int pi = 0;
    for (int i = 0; i < n_steps; ++i) {
      const int h = h0 + i / per_head;
      const int qs = q_begin + (i % per_head) * kTile;
      if (lane == 0) {
        for (int c = 0; c < n_d; ++c) {
          put_pair(sm, pi, &k_map, hk, k0, &q_map, h, qs, c * kBox, b);
        }
        if (is_dk) {
          for (int c = 0; c < n_dv; ++c) {
            put_pair(sm, pi, &v_map, hk, k0, &do_map, h, qs, c * kBox, b);
          }
        }
      }
      __syncwarp();
      put_slice(sm, i, is_dk ? &q_map : &do_map, h, qs, b, c_lo, n_sb, lane,
                [&](float* st) {
                  for (int r = lane; r < kTile; r += 32) {
                    const int row = qs + r;
                    const size_t at = (static_cast<size_t>(b) * hq + h) * tq + row;
                    st[r] = row < tq ? lse[at] * kLog2e : 0.f;
                    st[kTile + r] = row < tq ? delta[at] : 0.f;
                  }
                });
    }
    return;
  }

  const int wg = warp / 4;
  const int key0 = k0 + 16 * (warp % 4) + lane / 4;   // this thread's keys: key0, key0 + 8
  // the first row that sees each of this thread's keys (none past Tk;
  // causal: the key's diagonal, unless it is in the prefix)
  int first_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    first_row[r] = key >= tk ? INT_MAX : causal && key >= prefix_len ? key - q_off : 0;
  }
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;

  int pi = 0, n_x = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int qs = q_begin + (i % per_head) * kTile;
    float sc[32], dp[32];
    ring_dots(sm, sc, pi, n_d, wg);
    if (is_dk) ring_dots(sm, dp, pi, n_dv, wg);
    exchange(sm, sc, n_x, wg);
    if (is_dk) exchange(sm, dp, n_x, wg);
    slice_wait(sm, i);
    const float* st = sm.stats + (i % kSliceStages) * 2 * kTile;
    const bool edge = qs + kTile > tq || k0 + kTile > tk ||
                      (causal && k0 + kTile - 1 > qs + q_off && k0 + kTile > prefix_len);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = acc_col(j, lane);
      float p = ex2(sc[j] * scale_log2 - st[col]);
      if (edge && (qs + col < first_row[acc_half(j)] || qs + col >= tq)) p = 0.f;
      sc[j] = is_dk ? p * (dp[j] - st[kTile + col]) : p;
    }
    uint32_t a[4][4];
    to_a(sc, a);
    slice_product(sm, acc, a, i, 2 * wg);
  }
  if (groups == 1) {
    const float mul[2] = {is_dk ? scale : 1.f, is_dk ? scale : 1.f};
    store_rows<128>(is_dk ? dk : dv, acc[0], acc[1], mul, key0, tk, b, hkv, hk, lane,
                    width, c_lo + 2 * wg * kBox);
    return;
  }
  // part: dK's groups (groups, B, Tk, Hkv, D), then dV's (groups, B, Tk,
  // Hkv, Dv)
  const size_t rows = static_cast<size_t>(batch) * tk * hkv;
  float* out = part + (is_dk ? grp * rows * d : groups * rows * d + grp * rows * d_v);
  const int col0 = c_lo + 2 * wg * kBox;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = key0 + 8 * half;
    if (row >= tk) continue;
    float* dst = out + ((static_cast<size_t>(b) * tk + row) * hkv + hk) * width + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * half, c = acc_col(i, lane);
      if (c < width - col0) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(acc[0][i], acc[0][i + 1]);
      }
      if (kBox + c < width - col0) {
        *reinterpret_cast<float2*>(dst + kBox + c) = make_float2(acc[1][i], acc[1][i + 1]);
      }
    }
  }
}

// dK and dV from the head groups' partial sums: each pair of elements sums
// its groups' in group order (a fixed order: the same bits run after run),
// dK times scale, and is written in bf16
__global__ void __launch_bounds__(256)
wide_dkdv_combine(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, long long n_dk, long long n_dv,
                  int groups, float scale) {
  const long long e = 2 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (e >= n_dk + n_dv) return;
  const bool is_dk = e < n_dk;
  const long long n = is_dk ? n_dk : n_dv;
  const float* src = is_dk ? part + e : part + groups * n_dk + (e - n_dk);
  float2 sum = make_float2(0.f, 0.f);
  for (int g = 0; g < groups; ++g) {
    const float2 x = *reinterpret_cast<const float2*>(src + g * n);
    sum.x += x.x;
    sum.y += x.y;
  }
  const float mul = is_dk ? scale : 1.f;
  *reinterpret_cast<__nv_bfloat162*>(is_dk ? dk + e : dv + (e - n_dk)) =
      __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
}

}  // namespace hopper

// ---------------------------------------------------------------------- //
// launchers
// ---------------------------------------------------------------------- //

// Tq > Tk is refused only when causal: the causal offset Tk - Tq must be >= 0
bool bad_shape(int b, int tq, int tk, int hq, int hkv, int d, int dv, int causal,
               int prefix_len) {
  return b < 1 || tq < 1 || tk < 1 || (causal && tk < tq) || hkv < 1 || hq % hkv != 0 ||
         d % 8 != 0 || d < 8 || dv % 8 != 0 || dv < 8 || prefix_len < 0;
}

// heads past 256 columns run the wide kernels
bool wide(int d, int dv) { return d > kSliceW || dv > kSliceW; }

constexpr int kSmCount = 132;   // the H100's SMs

// The kernels a call launches, a static rule by dtype and width (the
// wrapper's flash_attention.route states the same): float32 on the CUDA
// cores, exact (flash_* up to 256, flash_wide_* past it); bfloat16 on the
// tensor cores (hopper::fwd/dq/dkdv_kernel up to 256, hopper::wide_* past
// it).  -1 for a dtype neither route takes.
enum Route { kF32 = 0, kBf16 = 1, kF32Wide = 2, kBf16Wide = 3 };

int route_of(int dtype, int d, int dv) {
  if (dtype != 0 && dtype != 1) return -1;
  return wide(d, dv) ? (dtype == 1 ? kBf16Wide : kF32Wide) : (dtype == 1 ? kBf16 : kF32);
}

int slices_of(int width) { return (width + kSliceW - 1) / kSliceW; }

// Every launcher folds its blocks (row tiles, heads or column slices, batch)
// into grid x, whose limit is 2^31 - 1 (y and z stop at 65,535): the grid's
// block count, or 0 past that limit.  Grid x runs fastest, so the blocks
// keep the order the three-dimensional grid gave them.
unsigned grid_x(long long a, long long b, long long c) {
  const long long n = a * b * c;
  return n > 2147483647LL ? 0u : static_cast<unsigned>(n);
}

// opt in to more than 48 KB of dynamic shared memory where needed
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// the float32 route's shared memory: a (kTile, d) and a (kTile, dv) row
// tile, and transposed (d, kPad) and (dv, kPad) tiles where `transposed`
size_t f32_smem(int d, int dv, bool dv_transposed) {
  return sizeof(float) * (kTile * d + kTile * dv + d * kPad + (dv_transposed ? dv * kPad : 0));
}

template <typename T, int NC>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int b,
        int tq, int tk, int hq, int hkv, int d, int dv, float scale, int causal,
        int prefix_len, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, NC>;
  const size_t smem = f32_smem(d, dv, false);
  const unsigned grid = grid_x((tq + kTile - 1) / kTile, hq, b);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, tq, tk, hq, hkv, d, dv, scale, causal, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int b, int tq, int tk, int hq, int hkv, int d, int d_v, float scale,
        int causal, int prefix_len, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* got = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(b) * tq * hq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                              kThreads, 0, stream>>>(static_cast<const T*>(o), got,
                                                     delta, b, tq, hq, d_v);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto dq_kernel = flash_bwd_dq_kernel<T, NC>;
  const size_t dq_smem = f32_smem(d, d_v, true);
  const unsigned dq_grid = grid_x((tq + kTile - 1) / kTile, hq, b);
  const unsigned kv_grid = grid_x((tk + kTile - 1) / kTile, hkv, b);
  if (dq_grid == 0 || kv_grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(dq_kernel, dq_smem);
  if (err) return err;
  dq_kernel<<<dq_grid, kThreads, dq_smem, stream>>>(
      qt, kt, vt, got, lse, delta, static_cast<T*>(dq), tq, tk, hq, hkv, d, d_v,
      scale, causal, prefix_len);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto kv_kernel = flash_bwd_dkdv_kernel<T, NC>;
  const size_t kv_smem = f32_smem(d, d_v, true);
  err = allow_smem(kv_kernel, kv_smem);
  if (err) return err;
  kv_kernel<<<kv_grid, kThreads, kv_smem, stream>>>(
      qt, kt, vt, got, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), tq, tk,
      hq, hkv, d, d_v, scale, causal, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_wide(const void* q, const void* k, const void* v, void* o, float* lse, int b,
             int tq, int tk, int hq, int hkv, int d, int dv, float scale, int causal,
             int prefix_len, cudaStream_t stream) {
  const int slices = slices_of(dv);
  const unsigned grid = grid_x((tq + kTile - 1) / kTile, static_cast<long long>(hq) * slices, b);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_wide_fwd_kernel<T>;
  const int err = allow_smem(kernel, kWideSmem);
  if (err) return err;
  kernel<<<grid, kThreads, kWideSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, tq, tk, hq, hkv, d, dv, scale, causal, prefix_len, slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_wide(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk,
             void* dv, int b, int tq, int tk, int hq, int hkv, int d, int d_v,
             float scale, int causal, int prefix_len, cudaStream_t stream) {
  const int dq_slices = slices_of(d);
  const int kv_slices = slices_of(d) + slices_of(d_v);
  const unsigned dq_grid =
      grid_x((tq + kTile - 1) / kTile, static_cast<long long>(hq) * dq_slices, b);
  const unsigned kv_grid =
      grid_x((tk + kTile - 1) / kTile, static_cast<long long>(hkv) * kv_slices, b);
  if (dq_grid == 0 || kv_grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* got = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(b) * tq * hq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                              kThreads, 0, stream>>>(static_cast<const T*>(o), got,
                                                     delta, b, tq, hq, d_v);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto dq_kernel = flash_wide_dq_kernel<T>;
  err = allow_smem(dq_kernel, kWideSmem);
  if (err) return err;
  dq_kernel<<<dq_grid, kThreads, kWideSmem, stream>>>(qt, kt, vt, got, lse, delta, static_cast<T*>(dq), tq, tk, hq,
                        hkv, d, d_v, scale, causal, prefix_len, dq_slices);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto kv_kernel = flash_wide_dkdv_kernel<T>;
  err = allow_smem(kv_kernel, kWideSmem);
  if (err) return err;
  kv_kernel<<<kv_grid, kThreads, kWideSmem, stream>>>(qt, kt, vt, got, lse, delta, static_cast<T*>(dk),
                        static_cast<T*>(dv), tq, tk, hq, hkv, d, d_v, scale, causal,
                        prefix_len, slices_of(d), slices_of(d_v));
  return static_cast<int>(cudaGetLastError());
}

// f(NC) for the count of 32-column groups NC = ceil(d / 32), one
// instantiation each
template <typename F>
int with_nc(int d, F&& f) {
  switch ((d + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------- //
// bfloat16 launchers
// ---------------------------------------------------------------------- //

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D map over a contiguous (B, T, H, D) bf16 tensor, dims innermost first
// (D, H, T, B), whose box is 64 columns of `rows` rows of one head, 128-byte
// swizzled; columns past D and rows past T read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int b, int t, int h, int d,
                int rows) {
  const EncodeTiled encode = encoder();
  // the encoder fails on a thread with no current context (autograd's
  // backward thread before any launch there): cudaFree(nullptr) binds the
  // device's primary context, once a thread, and does nothing else
  thread_local bool bound = false;
  if (!bound) bound = cudaFree(nullptr) == cudaSuccess;
  if (encode == nullptr || !bound) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(h) * d * 2,
                                 static_cast<cuuint64_t>(t) * h * d * 2};
  const cuuint32_t box[4] = {hopper::kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int blocks_of(int n, int rows) { return (n + rows - 1) / rows; }

// The tensors are (d, dv) wide, at most the instantiation's (D, DV): the
// maps keep the true widths, so the boxes read the columns past them as
// zeros, and the stores stop at them.
template <int D, int DV>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b,
             int tq, int tk, int hq, int hkv, int d, int dv, float scale, int causal,
             int prefix_len, cudaStream_t stream) {
  constexpr int kRows = hopper::Split<D, DV>::kRows;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, b, tq, hq, d, kRows) ||
      !tensor_map(&mk, k, b, tk, hkv, d, hopper::kTile) ||
      !tensor_map(&mv, v, b, tk, hkv, dv, hopper::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = grid_x(hq, b, blocks_of(tq, kRows));
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = hopper::fwd_kernel<D, DV>;
  const size_t smem = hopper::fwd_smem<D, DV>();
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, hopper::kThreadsH, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, tq, tk, hq, hkv, dv,
      scale * hopper::kLog2e, causal, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int bwd_bf16(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk,
             void* dv, int b, int tq, int tk, int hq, int hkv, int d, int d_v,
             float scale, int causal, int prefix_len, cudaStream_t stream) {
  constexpr int kRows = hopper::Split<D, DV>::kRows;
  const unsigned dq_grid = grid_x(hq, b, blocks_of(tq, kRows));
  const unsigned kv_grid = grid_x(hkv, b, blocks_of(tk, kRows));
  if (dq_grid == 0 || kv_grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(b) * tq * hq;
  const long long per_block = hopper::kDeltaWarps * hopper::kDeltaRows;
  hopper::delta_kernel<<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                 hopper::kDeltaWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      delta, rows, tq, hq, d_v);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map(&mq, q, b, tq, hq, d, kRows) ||
      !tensor_map(&mdo, dout, b, tq, hq, d_v, kRows) ||
      !tensor_map(&mk, k, b, tk, hkv, d, hopper::kTile) ||
      !tensor_map(&mv, v, b, tk, hkv, d_v, hopper::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto dq_k = hopper::dq_kernel<D, DV>;
  err = allow_smem(dq_k, hopper::dq_smem<D, DV>());
  if (err) return err;
  dq_k<<<dq_grid, hopper::kThreadsH,
         hopper::dq_smem<D, DV>(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), tq, tk, hq, hkv, d,
      scale, scale * hopper::kLog2e, causal, prefix_len);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  // the dK/dV kernel holds a block of keys and streams 64-row q and dO tiles
  if (!tensor_map(&mq, q, b, tq, hq, d, hopper::kTile) ||
      !tensor_map(&mdo, dout, b, tq, hq, d_v, hopper::kTile) ||
      !tensor_map(&mk, k, b, tk, hkv, d, kRows) ||
      !tensor_map(&mv, v, b, tk, hkv, d_v, kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kv_k = hopper::dkdv_kernel<D, DV>;
  err = allow_smem(kv_k, hopper::dkdv_smem<D, DV>());
  if (err) return err;
  kv_k<<<kv_grid, hopper::kThreadsKV,
         hopper::dkdv_smem<D, DV>(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, hq, hkv, d, d_v, scale,
      scale * hopper::kLog2e, causal, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 past 256: every tensor map boxes 64 rows, at the true widths
int fwd_wide_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                  int b, int tq, int tk, int hq, int hkv, int d, int dv, float scale,
                  int causal, int prefix_len, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, b, tq, hq, d, hopper::kTile) ||
      !tensor_map(&mk, k, b, tk, hkv, d, hopper::kTile) ||
      !tensor_map(&mv, v, b, tk, hkv, dv, hopper::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Slices of 512 columns where V is wider than 256 and the grid of
  // 256-column slices fills two waves of the H100's SMs: the scores are
  // then computed once for twice the columns (absorbed MLA's MQA prefill:
  // 0.071 against 0.107 ms), while a thinner grid would leave SMs idle
  // ((576, 512) at B 2 x T 256: 0.020 against 0.017).  Both give the same
  // bits; the choice moves time only.
  const long long blocks256 = static_cast<long long>(hq) * slices_of(dv) * b *
                              blocks_of(tq, hopper::kTile);
  const bool v512 = dv > kSliceW && blocks256 >= 2 * kSmCount;
  const int slices = (dv + (v512 ? 2 : 1) * kSliceW - 1) / ((v512 ? 2 : 1) * kSliceW);
  const unsigned grid =
      grid_x(static_cast<long long>(hq) * slices, b, blocks_of(tq, hopper::kTile));
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = v512 ? hopper::wide_fwd_kernel<4> : hopper::wide_fwd_kernel<2>;
  const size_t smem = v512 ? hopper::Wide512::bytes() : hopper::Wide256::bytes();
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, v512 ? hopper::kThreadsKV : hopper::kThreadsH, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, b, tq, tk, hq, hkv, d, dv, slices,
      scale * hopper::kLog2e, causal, prefix_len);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 wide dK/dV kernel splits each kv head's query heads over blocks
// until its grid has this many (four waves of the H100's SMs)
constexpr long long kKvSplitBlocks = 4LL * kSmCount;

// Over how many dK/dV blocks the bf16 wide backward splits each kv head's
// group of hq / hkv query heads: the smallest divisor of the group that
// brings the grid (64-key tiles x kv heads x column slices of d and d_v x
// batch) to kKvSplitBlocks, or the whole group.  Causal GQA gives the first
// key tiles the most work (every q tile of every head), so without the split
// a few blocks run long while most SMs idle.  A function of the shape alone,
// so the bits stay fixed.
int kv_groups(int b, int tk, int hq, int hkv, int d, int d_v) {
  const int g = hq / hkv;
  const long long blocks = static_cast<long long>(b) * hkv *
                           blocks_of(tk, hopper::kTile) * (slices_of(d) + slices_of(d_v));
  for (int n = 1; n < g; ++n) {
    if (g % n == 0 && blocks * n >= kKvSplitBlocks) return n;
  }
  return g;
}

// Bytes of the f32 workspace the backward takes: the split's partial sums,
// (groups, B, Tk, Hkv, d) then (groups, B, Tk, Hkv, d_v); 0 where it does not
// split (every route but the bf16 wide one, or a group of one block).
long long bwd_workspace_bytes(int dtype, int b, int tk, int hq, int hkv, int d, int d_v) {
  if (route_of(dtype, d, d_v) != kBf16Wide) return 0;
  const int groups = kv_groups(b, tk, hq, hkv, d, d_v);
  return groups == 1 ? 0
                     : 4LL * groups * b * tk * hkv * (static_cast<long long>(d) + d_v);
}

// The split's f32 partial sums go to `part` (bwd_workspace_bytes) and the
// combine kernel adds them in group order.
int bwd_wide_bf16(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk,
                  void* dv, int b, int tq, int tk, int hq, int hkv, int d, int d_v,
                  float scale, int causal, int prefix_len, float* part,
                  cudaStream_t stream) {
  const int groups = kv_groups(b, tk, hq, hkv, d, d_v);
  if (groups > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int dq_slices = slices_of(d);
  const unsigned dq_grid =
      grid_x(static_cast<long long>(hq) * dq_slices, b, blocks_of(tq, hopper::kTile));
  const unsigned kv_grid =
      grid_x(static_cast<long long>(hkv) * groups * (dq_slices + slices_of(d_v)), b,
             blocks_of(tk, hopper::kTile));
  if (dq_grid == 0 || kv_grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map(&mq, q, b, tq, hq, d, hopper::kTile) ||
      !tensor_map(&mdo, dout, b, tq, hq, d_v, hopper::kTile) ||
      !tensor_map(&mk, k, b, tk, hkv, d, hopper::kTile) ||
      !tensor_map(&mv, v, b, tk, hkv, d_v, hopper::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf16 = __nv_bfloat16;
  const long long rows = static_cast<long long>(b) * tq * hq;
  flash_bwd_delta_kernel<bf16><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                                 kThreads, 0, stream>>>(static_cast<const bf16*>(o),
                                                        static_cast<const bf16*>(dout),
                                                        delta, b, tq, hq, d_v);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto dq_k = hopper::wide_dq_kernel;
  err = allow_smem(dq_k, hopper::Wide256::bytes());
  if (err) return err;
  dq_k<<<dq_grid, hopper::kThreadsH, hopper::Wide256::bytes(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), b, tq, tk, hq, hkv, d, d_v,
      dq_slices, scale, scale * hopper::kLog2e, causal, prefix_len);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto kv_k = hopper::wide_dkdv_kernel;
  err = allow_smem(kv_k, hopper::Wide256::bytes());
  if (err) return err;
  kv_k<<<kv_grid, hopper::kThreadsH, hopper::Wide256::bytes(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part,
      b, tq, tk, hq, hkv, d, d_v, dq_slices, slices_of(d_v), groups, scale,
      scale * hopper::kLog2e, causal, prefix_len);
  err = static_cast<int>(cudaGetLastError());
  if (err || groups == 1) return err;
  const long long keys = static_cast<long long>(b) * tk * hkv;
  const long long pairs = keys * (d + d_v) / 2;
  hopper::wide_dkdv_combine<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), keys * d, keys * d_v, groups,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// f(D, DV) for the smallest (qk, v) head-dim pair the bfloat16 route
// instantiates that holds (d, dv) (by D + DV, then D): the square 64, 80, 96,
// 128 and 256 (PaliGemma's heads), and (96, 64), MiniCPM3's MLA heads
template <typename F>
int with_head_dims(int d, int dv, F&& f) {
  using std::integral_constant;
  if (d <= 64 && dv <= 64) {
    return f(integral_constant<int, 64>{}, integral_constant<int, 64>{});
  }
  if (d <= 80 && dv <= 80) {
    return f(integral_constant<int, 80>{}, integral_constant<int, 80>{});
  }
  if (d <= 96 && dv <= 64) {
    return f(integral_constant<int, 96>{}, integral_constant<int, 64>{});
  }
  if (d <= 96 && dv <= 96) {
    return f(integral_constant<int, 96>{}, integral_constant<int, 96>{});
  }
  if (d <= 128 && dv <= 128) {
    return f(integral_constant<int, 128>{}, integral_constant<int, 128>{});
  }
  if (d <= 256 && dv <= 256) {
    return f(integral_constant<int, 256>{}, integral_constant<int, 256>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core
// route, at the instantiation with_head_dims picks); both take any d and dv
// that are multiples of 8, and past 256 (either of them) each runs its wide
// kernels (route_of).  q, k, v, o and the gradients share the dtype, lse
// and delta are f32.  The backward's workspace holds
// repro_flash_bwd_workspace's bytes (null where that is 0): on the bfloat16
// wide route, the f32 partial sums of the dK/dV blocks over which it splits
// each kv head's query heads.  Tensors are contiguous: q, dq (B, Tq, Hq, d), k, dk (B, Tk, Hkv, d),
// v, dv (B, Tk, Hkv, dv), o, dO (B, Tq, Hq, dv); the bfloat16 route's are
// 16-byte aligned.  prefix_len >= 0: with causal, the first prefix_len keys
// are visible to every row (prefix-LM); without, it changes nothing.
extern "C" int repro_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int b, int tq,
                               int tk, int hq, int hkv, int d, int dv, float scale,
                               int causal, int prefix_len, void* stream) {
  const int r = route_of(dtype, d, dv);
  if (bad_shape(b, tq, tk, hq, hkv, d, dv, causal, prefix_len) || r < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (r) {
    case kBf16Wide:
      return fwd_wide_bf16(q, k, v, o, l, b, tq, tk, hq, hkv, d, dv, scale, causal,
                           prefix_len, s);
    case kF32Wide:
      return fwd_wide<float>(q, k, v, o, l, b, tq, tk, hq, hkv, d, dv, scale, causal,
                             prefix_len, s);
    case kBf16:
      return with_head_dims(d, dv, [&](auto dim, auto dim_v) {
        return fwd_bf16<decltype(dim)::value, decltype(dim_v)::value>(
            q, k, v, o, l, b, tq, tk, hq, hkv, d, dv, scale, causal, prefix_len, s);
      });
    default:
      // the forward's accumulators are the output's dv columns
      return with_nc(dv, [&](auto nc) {
        return fwd<float, decltype(nc)::value>(q, k, v, o, l, b, tq, tk, hq, hkv, d, dv,
                                               scale, causal, prefix_len, s);
      });
  }
}

extern "C" int repro_flash_bwd(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* dq, void* dk,
                               void* dv, int b, int tq, int tk, int hq, int hkv,
                               int d, int d_v, float scale, int causal, int prefix_len,
                               void* workspace, void* stream) {
  const int r = route_of(dtype, d, d_v);
  if (bad_shape(b, tq, tk, hq, hkv, d, d_v, causal, prefix_len) || r < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (r) {
    case kBf16Wide:
      return bwd_wide_bf16(q, k, v, o, dout, l, dl, dq, dk, dv, b, tq, tk, hq, hkv, d,
                           d_v, scale, causal, prefix_len,
                           static_cast<float*>(workspace), s);
    case kF32Wide:
      return bwd_wide<float>(q, k, v, o, dout, l, dl, dq, dk, dv, b, tq, tk, hq, hkv, d,
                             d_v, scale, causal, prefix_len, s);
    case kBf16:
      return with_head_dims(d, d_v, [&](auto dim, auto dim_v) {
        return bwd_bf16<decltype(dim)::value, decltype(dim_v)::value>(
            q, k, v, o, dout, l, dl, dq, dk, dv, b, tq, tk, hq, hkv, d, d_v, scale,
            causal, prefix_len, s);
      });
    default:
      // dQ's accumulators are d wide, dK's d and dV's d_v: one count for both
      return with_nc(d > d_v ? d : d_v, [&](auto nc) {
        return bwd<float, decltype(nc)::value>(q, k, v, o, dout, l, dl, dq, dk, dv, b,
                                               tq, tk, hq, hkv, d, d_v, scale, causal,
                                               prefix_len, s);
      });
  }
}

// Bytes of f32 workspace repro_flash_bwd takes for this call (0: none; -1
// for a shape it refuses), the widths those the wrapper passes.
extern "C" long long repro_flash_bwd_workspace(int dtype, int b, int tk, int hq, int hkv,
                                               int d, int d_v) {
  if (bad_shape(b, 1, tk, hq, hkv, d, d_v, 0, 0) || route_of(dtype, d, d_v) < 0) return -1;
  return bwd_workspace_bytes(dtype, b, tk, hq, hkv, d, d_v);
}

// The kernels a (d, dv) call in dtype code `dtype` launches (route_of: 0
// float32, 1 bfloat16, 2 float32 past 256, 3 bfloat16 past 256; -1 for an
// unknown dtype).
extern "C" int repro_flash_route(int dtype, int d, int dv) { return route_of(dtype, d, dv); }

// The head dims (D, DV) the bfloat16 route runs a (d, dv) call at, as D *
// 65536 + DV: up to 256 the instantiation with_head_dims picks; past 256
// (the wide kernels, whose box counts are taken at run time) d and dv
// themselves.  d and dv are the widths the wrapper passes (multiples of 8).
extern "C" int repro_flash_bf16_dims(int d, int dv) {
  if (wide(d, dv)) return d * 65536 + dv;
  int dims = -1;
  with_head_dims(d, dv, [&](auto dim, auto dim_v) {
    dims = decltype(dim)::value * 65536 + decltype(dim_v)::value;
    return 0;
  });
  return dims;
}

// Dynamic shared memory of the bfloat16 route's kernels at head dims (d, dv)
// (kernel 0 forward, 1 dQ, 2 dK/dV; the delta and combine kernels' is
// static), for the build report: past 256 the wide kernels' (kernel 0
// with dv past 256: the 512-column forward's, which such a call takes
// where its grid is large).
extern "C" int repro_flash_bf16_smem(int kernel, int d, int dv) {
  if (kernel < 0 || kernel > 2) return -1;
  if (wide(d, dv)) {
    return static_cast<int>(kernel == 0 && dv > kSliceW ? hopper::Wide512::bytes()
                                                        : hopper::Wide256::bytes());
  }
  int bytes = -1;
  with_head_dims(d, dv, [&](auto dim, auto dim_v) {
    constexpr int D = decltype(dim)::value, DV = decltype(dim_v)::value;
    const size_t sizes[3] = {hopper::fwd_smem<D, DV>(), hopper::dq_smem<D, DV>(),
                             hopper::dkdv_smem<D, DV>()};
    bytes = static_cast<int>(sizes[kernel]);
    return 0;
  });
  return bytes;
}
