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
// the backward pass.  The reference has no backward kernel (JAX
// differentiates the jnp version); this one is the standard flash backward
// in three launches:
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
//   Head dims 64, 80, 96 and 128 are instantiated; others are refused.
//
// * float32: exact f32 products on the CUDA cores (tensor cores would round
//   to TF32).  A block of 4 warps owns 32 query rows (8 per warp); each
//   32-key tile is staged in shared memory in f32, K transposed with a
//   padded stride so that lane j reads key j without bank conflicts.  A lane
//   computes one key's score for its warp's 8 rows; the softmax statistics
//   reduce over the warp with shuffles; for p.V each lane owns columns lane,
//   lane+32, ... of the 8 rows' accumulators and receives p_ij from lane j by
//   shuffle.  Bound by those f32 operations, far from the tensor cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }


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

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q,   // (B, Tq, Hq, D)
                 const T* __restrict__ k,   // (B, Tk, Hkv, D)
                 const T* __restrict__ v,   // (B, Tk, Hkv, D)
                 T* __restrict__ o,         // (B, Tq, Hq, D)
                 float* __restrict__ lse,   // (B, Hq, Tq)
                 int tq, int tk, int hq, int hkv, int d, float scale,
                 int causal) {
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // (kTile, d) query rows
  float* kt_s = q_s + kTile * d;     // (d, kPad) keys, transposed
  float* v_s = kt_s + d * kPad;      // (kTile, d) values

  stage<T, false>(q_s, q, b, q0, tq, h, hq, d);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // tiles wholly after the last query row's diagonal are skipped
  const int k_end = causal ? min(tk, min(q0 + kTile, tq) + q_offset) : tk;
  const float* my_q = q_s + warp * kRows * d;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    stage<T, true>(kt_s, k, b, k0, tk, hk, hkv, d);
    stage<T, false>(v_s, v, b, k0, tk, hk, hkv, d);
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
      const bool valid = k_pos < tk && (!causal || k_pos <= q_pos);
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
        vj[c] = col < d ? v_s[j * d + col] : 0.f;
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
    T* orow = o + ((static_cast<size_t>(b) * tq + row) * hq + h) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(orow + col, acc[i][c] * inv);
    }
    if (lane == 0) lse[(static_cast<size_t>(b) * hq + h) * tq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------- //
// backward
// ---------------------------------------------------------------------- //

// delta[b, h, t] = dO[b, t, h] . O[b, t, h]: one warp per row
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

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int tq, int tk, int hq, int hkv, int d,
                    float scale, int causal) {
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // (kTile, d)
  float* do_s = q_s + kTile * d;     // (kTile, d)
  float* kt_s = do_s + kTile * d;    // (d, kPad)
  float* vt_s = kt_s + d * kPad;     // (d, kPad)

  stage<T, false>(q_s, q, b, q0, tq, h, hq, d);
  stage<T, false>(do_s, dout, b, q0, tq, h, hq, d);

  float row_lse[kRows], row_delta[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = min(q0 + warp * kRows + i, tq - 1);
    row_lse[i] = lse[(static_cast<size_t>(b) * hq + h) * tq + row];
    row_delta[i] = delta[(static_cast<size_t>(b) * hq + h) * tq + row];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(tk, min(q0 + kTile, tq) + q_offset) : tk;
  const float* my_q = q_s + warp * kRows * d;
  const float* my_do = do_s + warp * kRows * d;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage<T, true>(kt_s, k, b, k0, tk, hk, hkv, d);
    stage<T, true>(vt_s, v, b, k0, tk, hk, hkv, d);
    __syncthreads();

    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
    row_dots(s, my_q, kt_s, d, lane);
    row_dots(dp, my_do, vt_s, d, lane);

    const int k_pos = k0 + lane;
    float ds[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + warp * kRows + i + q_offset;
      const bool valid = k_pos < tk && (!causal || k_pos <= q_pos);
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

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
                      int hq, int hkv, int d, float scale, int causal) {
  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_offset = tk - tq;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // (kTile, d) key rows
  float* v_s = k_s + kTile * d;      // (kTile, d) value rows
  float* qt_s = v_s + kTile * d;     // (d, kPad) query tile, transposed
  float* dot_s = qt_s + d * kPad;    // (d, kPad) dO tile, transposed

  stage<T, false>(k_s, k, b, k0, tk, hk, hkv, d);
  stage<T, false>(v_s, v, b, k0, tk, hk, hkv, d);

  float dk_acc[kRows][NC], dv_acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  // the first query tile that sees any of these keys
  const int q_begin = causal ? max(0, k0 - q_offset) / kTile * kTile : 0;
  const float* my_k = k_s + warp * kRows * d;
  const float* my_v = v_s + warp * kRows * d;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    for (int qt0 = q_begin; qt0 < tq; qt0 += kTile) {
      __syncthreads();
      stage<T, true>(qt_s, q, b, qt0, tq, h, hq, d);
      stage<T, true>(dot_s, dout, b, qt0, tq, h, hq, d);
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
      row_dots(dp, my_v, dot_s, d, lane);

      float p[kRows], ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k_pos = k0 + warp * kRows + i;
        const bool valid = q_row < tq && k_pos < tk && (!causal || k_pos <= q_pos);
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
          gj[c] = col < d ? dot_s[col * kPad + j] : 0.f;
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
    const size_t off = ((static_cast<size_t>(b) * tk + row) * hkv + hk) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        store(dk + off + col, dk_acc[i][c] * scale);
        store(dv + off + col, dv_acc[i][c]);
      }
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
constexpr int kBlockRows = 2 * 64;           // rows a block owns (64 per warpgroup)
constexpr int kTile = 64;                    // rows of a streamed tile
constexpr int kStages = 3;     // backward ring: a tile in each of two products, one loading
constexpr int kFwdStages = 2;  // forward ring: its products take one tile at a time
constexpr int kBox = 64;                     // bf16 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr uint32_t kBlockBox = kBlockRows * kRowBytes;   // 16 KB
constexpr uint32_t kTileBox = kTile * kRowBytes;         // 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Dims {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128, "head dim");
  static constexpr int kBoxes = D > kBox ? 2 : 1;   // 64-column boxes per row
  static constexpr int kN1 = D - kBox;              // output columns of the second box
  static constexpr int kKSteps = D / 16;            // k steps of a product over D
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

// d += A(registers) x the tile's first D columns (MN-major, k = tile rows):
// a 64-wide product on the first box and a (D - 64)-wide one on the second
template <int D>
__device__ __forceinline__ void mma_rows(float (&d0)[32],
                                         float (&d1)[Dims<D>::kN1 > 0 ? Dims<D>::kN1 / 2 : 1],
                                         const uint32_t (&a)[4][4], uint32_t tile,
                                         uint32_t box_bytes) {
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

// write a warpgroup's 64 x D accumulator rows (scaled) to a (B, T, H, D) tensor
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&d0)[32],
                                           const float (&d1)[Dims<D>::kN1 > 0 ? Dims<D>::kN1 / 2 : 1],
                                           const float (&mul)[2], int row0, int t,
                                           int b, int heads, int h, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= t) continue;
    __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * t + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(dst + acc_col(i, lane)) =
          __floats2bfloat162_rn(d0[i] * mul[half], d0[i + 1] * mul[half]);
    }
    if constexpr (Dims<D>::kN1 > 0) {
#pragma unroll
      for (int j = 0; j < Dims<D>::kN1 / 8; ++j) {
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dst + kBox + acc_col(i, lane)) =
            __floats2bfloat162_rn(d1[i] * mul[half], d1[i + 1] * mul[half]);
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

template <int D>
constexpr size_t fwd_smem() {
  return 1024 + Dims<D>::kBoxes * (kBlockBox + 2 * kFwdStages * kTileBox) + 8 * 8;
}

// Forward.  Grid (Hq, B, q tiles), the last q tile (the longest causal rows)
// first.  Warpgroup wg owns rows q0 + 64 wg ...; the producer warp loads Q
// once and streams K and V tiles through the ring.
template <int D>
__global__ void __launch_bounds__(kThreadsH, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int tq, int tk,
           int hq, int hkv, float scale_log2, int causal) {
  using G = Dims<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = aligned_base(smem_raw);
  const uint32_t k_s = q_s + G::kBoxes * kBlockBox;
  const uint32_t v_s = k_s + kFwdStages * G::kBoxes * kTileBox;
  const uint32_t bars = v_s + kFwdStages * G::kBoxes * kTileBox;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kFwdStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kFwdStages + s); };
  const uint32_t stage_bytes = G::kBoxes * kTileBox;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;
  const int hk = h / (hq / hkv);
  const int q_off = tk - tq;
  const int k_end = causal ? min(tk, min(q0 + kBlockRows, tq) + q_off) : tk;
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
      mbar_expect_tx(q_full, G::kBoxes * kBlockBox);
      tma_rows<D>(q_s, kBlockBox, &q_map, q_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kFwdStages;
        if (i >= kFwdStages) mbar_wait(empty(s), ((i / kFwdStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), stage_bytes);
        tma_rows<D>(k_s + s * stage_bytes, kTileBox, &k_map, k_full(s), hk, i * kTile, b);
        mbar_expect_tx(v_full(s), stage_bytes);
        tma_rows<D>(v_s + s * stage_bytes, kTileBox, &v_map, v_full(s), hk, i * kTile, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int first = q0 + 64 * wg;                       // the warpgroup's first row
  const int row0 = first + 16 * (warp % 4) + lane / 4;  // this thread's rows: row0, row0 + 8
  float o0[32], o1[G::kN1 > 0 ? G::kN1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (G::kN1 > 0 ? G::kN1 / 2 : 1); ++i) o1[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kFwdStages;
    const uint32_t ph = (i / kFwdStages) & 1;
    const int k0 = i * kTile;
    // a tile wholly after this warpgroup's last diagonal adds nothing
    const bool live = !causal || k0 <= first + 63 + q_off;
    mbar_wait(k_full(s), ph);
    if (live) {
      float sc[32];
      wg_fence();
      mma_dots<D>(sc, q_s + 64 * wg * kRowBytes, kBlockBox, k_s + s * stage_bytes, kTileBox);
      wg_commit();
      wg_wait();
      hold(sc);

      const bool edge = k0 + kTile > tk || (causal && k0 + kTile - 1 > first + q_off);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * scale_log2;
        if (edge) {
          const int key = k0 + acc_col(j, lane);
          const int q_pos = row0 + 8 * acc_half(j) + q_off;
          if (key >= tk || (causal && key > q_pos)) x = kNegInf;
        }
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
      for (int j = 0; j < (G::kN1 > 0 ? G::kN1 / 2 : 0); ++j) o1[j] *= corr[acc_half(j)];
      uint32_t a[4][4];
      to_a(sc, a);

      mbar_wait(v_full(s), ph);
      wg_fence();
      hold(o0);
      hold(o1);
      mma_rows<D>(o0, o1, a, v_s + s * stage_bytes, kTileBox);
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
  store_rows<D>(o, o0, o1, inv, row0, tq, b, hq, h, lane);
  if (lane % 4 == 0) {
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
// r's in order.
constexpr int kDeltaWarps = 8, kDeltaRows = 8;

__global__ void __launch_bounds__(kDeltaWarps * 32)
delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, long long rows, int tq, int hq, int d) {
  __shared__ float part[kDeltaWarps][kDeltaRows * 16];
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

template <int D>
constexpr size_t dq_smem() {
  return 1024 + Dims<D>::kBoxes * (2 * kBlockBox + 2 * kStages * kTileBox) + 8 * 8;
}

// dQ.  Grid (Hq, B, q tiles), longest causal rows first; the producer loads
// Q and dO once and streams K and V tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreadsH, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map,
          const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map,
          const __grid_constant__ CUtensorMap do_map,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int tq, int tk, int hq, int hkv,
          float scale, float scale_log2, int causal) {
  using G = Dims<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = aligned_base(smem_raw);
  const uint32_t do_s = q_s + G::kBoxes * kBlockBox;
  const uint32_t k_s = do_s + G::kBoxes * kBlockBox;
  const uint32_t v_s = k_s + kStages * G::kBoxes * kTileBox;
  const uint32_t bars = v_s + kStages * G::kBoxes * kTileBox;
  const uint32_t qd_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  const uint32_t stage_bytes = G::kBoxes * kTileBox;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;
  const int hk = h / (hq / hkv);
  const int q_off = tk - tq;
  const int k_end = causal ? min(tk, min(q0 + kBlockRows, tq) + q_off) : tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
      mbar_expect_tx(qd_full, 2 * G::kBoxes * kBlockBox);
      tma_rows<D>(q_s, kBlockBox, &q_map, qd_full, h, q0, b);
      tma_rows<D>(do_s, kBlockBox, &do_map, qd_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), stage_bytes);
        tma_rows<D>(k_s + s * stage_bytes, kTileBox, &k_map, k_full(s), hk, i * kTile, b);
        mbar_expect_tx(v_full(s), stage_bytes);
        tma_rows<D>(v_s + s * stage_bytes, kTileBox, &v_map, v_full(s), hk, i * kTile, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int first = q0 + 64 * wg;
  const int row0 = first + 16 * (warp % 4) + lane / 4;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (static_cast<size_t>(b) * hq + h) * tq + min(row0 + 8 * r, tq - 1);
    lse2[r] = lse[at] * kLog2e;
    dlt[r] = delta[at];
  }
  float g0[32], g1[G::kN1 > 0 ? G::kN1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) g0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (G::kN1 > 0 ? G::kN1 / 2 : 1); ++i) g1[i] = 0.f;

  // Only the tiles up to this warpgroup's last diagonal (the first n_live)
  // are computed, and dS K of tile i - 1 runs on the tensor cores while dS
  // of tile i is formed.
  const int n_live = causal ? min(n_tiles, (first + 63 + q_off) / kTile + 1) : n_tiles;
  const uint32_t my_q = q_s + 64 * wg * kRowBytes, my_do = do_s + 64 * wg * kRowBytes;
  auto dots = [&](float (&sc)[32], float (&dp)[32], int i) {
    const int s = i % kStages;
    mbar_wait(k_full(s), (i / kStages) & 1);
    mbar_wait(v_full(s), (i / kStages) & 1);
    wg_fence();
    mma_dots<D>(sc, my_q, kBlockBox, k_s + s * stage_bytes, kTileBox);
    mma_dots<D>(dp, my_do, kBlockBox, v_s + s * stage_bytes, kTileBox);
    wg_commit();
  };
  auto grad = [&](const uint32_t (&a)[4][4], int i) {
    wg_fence();
    hold(g0);
    hold(g1);
    mma_rows<D>(g0, g1, a, k_s + (i % kStages) * stage_bytes, kTileBox);
    wg_commit();
  };
  // sc (scores) -> dS = P (dP - delta) in place
  auto dscores = [&](float (&sc)[32], const float (&dp)[32], int i) {
    const int k0 = i * kTile;
    const bool edge = k0 + kTile > tk || (causal && k0 + kTile - 1 > first + q_off);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = acc_half(j);
      float p = ex2(sc[j] * scale_log2 - lse2[r]);
      if (edge) {
        const int key = k0 + acc_col(j, lane);
        if (key >= tk || (causal && key > row0 + 8 * r + q_off)) p = 0.f;
      }
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
    mbar_arrive(empty((i - 1) % kStages));
    to_a(sc, a);
  }
  grad(a, n_live - 1);
  wg_wait();
  hold(g0);
  hold(g1);
  hold(a);
  mbar_arrive(empty((n_live - 1) % kStages));
  for (int i = n_live; i < n_tiles; ++i) {
    mbar_wait(k_full(i % kStages), (i / kStages) & 1);
    mbar_arrive(empty(i % kStages));
  }
  const float mul[2] = {scale, scale};
  store_rows<D>(dq, g0, g1, mul, row0, tq, b, hq, h, lane);
}

template <int D>
constexpr size_t dkdv_smem() {
  return 1024 + Dims<D>::kBoxes * (2 * kBlockBox + 2 * kStages * kTileBox) +
         kStages * 2 * kTile * sizeof(float) + 8 * 8;
}

// dK and dV.  Grid (Hkv, B, k tiles), the first keys (the most q tiles)
// first.  Warpgroup wg owns keys k0 + 64 wg ...; the producer loads K and V
// once and streams, for each head of the group in turn, the Q and dO tiles
// from the diagonal on with their rows' lse and delta.
template <int D>
__global__ void __launch_bounds__(kThreadsKV, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            const __grid_constant__ CUtensorMap do_map,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int tq,
            int tk, int hq, int hkv, float scale, float scale_log2, int causal) {
  using G = Dims<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t k_s = aligned_base(smem_raw);
  const uint32_t v_s = k_s + G::kBoxes * kBlockBox;
  const uint32_t q_s = v_s + G::kBoxes * kBlockBox;
  const uint32_t do_s = q_s + kStages * G::kBoxes * kTileBox;
  const uint32_t stats = do_s + kStages * G::kBoxes * kTileBox;   // (lse2, delta) per stage
  const uint32_t bars = stats + kStages * 2 * kTile * sizeof(float);
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  const uint32_t stage_bytes = G::kBoxes * kTileBox;
  // generic pointer to the stats, for plain loads and stores
  float* stats_p = reinterpret_cast<float*>(smem_raw + (stats - smem_addr(smem_raw)));

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockRows;
  const int g = hq / hkv;
  const int q_off = tk - tq;
  // the first q tile with a row that sees any of these keys
  const int q_begin = causal ? max(0, k0 - q_off) / kTile * kTile : 0;
  const int per_head = (tq - q_begin + kTile - 1) / kTile;
  const int n_steps = g * max(per_head, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
      mbar_expect_tx(kv_full, 2 * G::kBoxes * kBlockBox);
      tma_rows<D>(k_s, kBlockBox, &k_map, kv_full, hk, k0, b);
      tma_rows<D>(v_s, kBlockBox, &v_map, kv_full, hk, k0, b);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      const int h = hk * g + i / per_head;
      const int qs = q_begin + (i % per_head) * kTile;
      if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
      float* st = stats_p + s * 2 * kTile;
      for (int r = lane; r < kTile; r += 32) {
        const int row = qs + r;
        const size_t at = (static_cast<size_t>(b) * hq + h) * tq + row;
        st[r] = row < tq ? lse[at] * kLog2e : 0.f;
        st[kTile + r] = row < tq ? delta[at] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * stage_bytes);
        tma_rows<D>(q_s + s * stage_bytes, kTileBox, &q_map, full(s), h, qs, b);
        tma_rows<D>(do_s + s * stage_bytes, kTileBox, &do_map, full(s), h, qs, b);
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  regs_take<kConsumerRegs>();
  const int wg = warp / 4;
  const int first = k0 + 64 * wg;                       // the warpgroup's first key
  const int key0 = first + 16 * (warp % 4) + lane / 4;  // this thread's keys: key0, key0 + 8
  float dk0[32], dk1[G::kN1 > 0 ? G::kN1 / 2 : 1];
  float dv0[32], dv1[G::kN1 > 0 ? G::kN1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk0[i] = dv0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (G::kN1 > 0 ? G::kN1 / 2 : 1); ++i) dk1[i] = dv1[i] = 0.f;

  mbar_wait(kv_full, 0);
  const uint32_t my_k = k_s + 64 * wg * kRowBytes, my_v = v_s + 64 * wg * kRowBytes;
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int qs = q_begin + (i % per_head) * kTile;
    // a q tile whose last row is before this warpgroup's first key adds nothing
    const bool live = !causal || qs + kTile - 1 + q_off >= first;
    mbar_wait(full(s), ph);
    if (live) {
      const float* st = stats_p + s * 2 * kTile;
      const bool edge = qs + kTile > tq || first + 64 > tk ||
                        (causal && first + 63 > qs + q_off);
      float sc[32], dp[32];
      wg_fence();
      mma_dots<D>(sc, my_k, kBlockBox, q_s + s * stage_bytes, kTileBox);
      mma_dots<D>(dp, my_v, kBlockBox, do_s + s * stage_bytes, kTileBox);
      wg_commit();
      wg_wait();
      hold(sc);
      hold(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = acc_col(j, lane);
        float p = ex2(sc[j] * scale_log2 - st[col]);
        if (edge) {
          const int key = key0 + 8 * acc_half(j), row = qs + col;
          if (row >= tq || key >= tk || (causal && key > row + q_off)) p = 0.f;
        }
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
      mma_rows<D>(dv0, dv1, ap, do_s + s * stage_bytes, kTileBox);
      mma_rows<D>(dk0, dk1, ads, q_s + s * stage_bytes, kTileBox);
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
  store_rows<D>(dv, dv0, dv1, one, key0, tk, b, hkv, hk, lane);
  store_rows<D>(dk, dk0, dk1, mul, key0, tk, b, hkv, hk, lane);
}

}  // namespace hopper

// ---------------------------------------------------------------------- //
// launchers
// ---------------------------------------------------------------------- //

// Tq > Tk is refused only when causal: the causal offset Tk - Tq must be >= 0
bool bad_shape(int b, int tq, int tk, int hq, int hkv, int d, int causal) {
  return b < 1 || tq < 1 || tk < 1 || (causal && tk < tq) || hkv < 1 || hq % hkv != 0 ||
         d % 8 != 0 || d < 8 || d > 256;
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

template <typename T, int NC>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int b,
        int tq, int tk, int hq, int hkv, int d, float scale, int causal,
        cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, NC>;
  const size_t smem = sizeof(float) * (2 * kTile * d + d * kPad);
  const dim3 grid((tq + kTile - 1) / kTile, hq, b);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, tq, tk, hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int b, int tq, int tk, int hq, int hkv, int d, float scale,
        int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* got = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(b) * tq * hq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                              kThreads, 0, stream>>>(static_cast<const T*>(o), got,
                                                     delta, b, tq, hq, d);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto dq_kernel = flash_bwd_dq_kernel<T, NC>;
  const size_t dq_smem = sizeof(float) * (2 * kTile * d + 2 * d * kPad);
  const dim3 dq_grid((tq + kTile - 1) / kTile, hq, b);
  err = allow_smem(dq_kernel, dq_smem);
  if (err) return err;
  dq_kernel<<<dq_grid, kThreads, dq_smem, stream>>>(
      qt, kt, vt, got, lse, delta, static_cast<T*>(dq), tq, tk, hq, hkv, d, scale,
      causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto kv_kernel = flash_bwd_dkdv_kernel<T, NC>;
  const size_t kv_smem = sizeof(float) * (2 * kTile * d + 2 * d * kPad);
  const dim3 kv_grid((tk + kTile - 1) / kTile, hkv, b);
  err = allow_smem(kv_kernel, kv_smem);
  if (err) return err;
  kv_kernel<<<kv_grid, kThreads, kv_smem, stream>>>(
      qt, kt, vt, got, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), tq, tk,
      hq, hkv, d, scale, causal);
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
  if (encode == nullptr) return false;
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

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b,
             int tq, int tk, int hq, int hkv, float scale, int causal,
             cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, b, tq, hq, D, hopper::kBlockRows) ||
      !tensor_map(&mk, k, b, tk, hkv, D, hopper::kTile) ||
      !tensor_map(&mv, v, b, tk, hkv, D, hopper::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = hopper::fwd_kernel<D>;
  const size_t smem = hopper::fwd_smem<D>();
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(hq, b, blocks_of(tq, hopper::kBlockRows)), hopper::kThreadsH, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, tq, tk, hq, hkv,
      scale * hopper::kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk,
             void* dv, int b, int tq, int tk, int hq, int hkv, float scale, int causal,
             cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * tq * hq;
  const long long per_block = hopper::kDeltaWarps * hopper::kDeltaRows;
  hopper::delta_kernel<<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                 hopper::kDeltaWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      delta, rows, tq, hq, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map(&mq, q, b, tq, hq, D, hopper::kBlockRows) ||
      !tensor_map(&mdo, dout, b, tq, hq, D, hopper::kBlockRows) ||
      !tensor_map(&mk, k, b, tk, hkv, D, hopper::kTile) ||
      !tensor_map(&mv, v, b, tk, hkv, D, hopper::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto dq_k = hopper::dq_kernel<D>;
  err = allow_smem(dq_k, hopper::dq_smem<D>());
  if (err) return err;
  dq_k<<<dim3(hq, b, blocks_of(tq, hopper::kBlockRows)), hopper::kThreadsH, hopper::dq_smem<D>(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), tq, tk, hq, hkv,
      scale, scale * hopper::kLog2e, causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  // the dK/dV kernel holds 128 keys and streams 64-row q and dO tiles
  if (!tensor_map(&mq, q, b, tq, hq, D, hopper::kTile) ||
      !tensor_map(&mdo, dout, b, tq, hq, D, hopper::kTile) ||
      !tensor_map(&mk, k, b, tk, hkv, D, hopper::kBlockRows) ||
      !tensor_map(&mv, v, b, tk, hkv, D, hopper::kBlockRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kv_k = hopper::dkdv_kernel<D>;
  err = allow_smem(kv_k, hopper::dkdv_smem<D>());
  if (err) return err;
  kv_k<<<dim3(hkv, b, blocks_of(tk, hopper::kBlockRows)), hopper::kThreadsKV, hopper::dkdv_smem<D>(), stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, hq, hkv, scale, scale * hopper::kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// f(D) for the head dims the bfloat16 route instantiates
template <typename F>
int with_head_dim(int d, F&& f) {
  switch (d) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core
// route, head dims 64, 80, 96 and 128); q, k, v, o and the gradients share
// it, lse and delta are f32.  Tensors are contiguous (B, T, H, D), and the
// bfloat16 route's are 16-byte aligned.
extern "C" int repro_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int b, int tq,
                               int tk, int hq, int hkv, int d, float scale,
                               int causal, void* stream) {
  if (bad_shape(b, tq, tk, hq, hkv, d, causal) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    return with_head_dim(d, [&](auto dim) {
      return fwd_bf16<decltype(dim)::value>(q, k, v, o, l, b, tq, tk, hq, hkv, scale,
                                            causal, s);
    });
  }
  return with_nc(d, [&](auto nc) {
    return fwd<float, decltype(nc)::value>(q, k, v, o, l, b, tq, tk, hq, hkv, d, scale,
                                           causal, s);
  });
}

extern "C" int repro_flash_bwd(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* dq, void* dk,
                               void* dv, int b, int tq, int tk, int hq, int hkv,
                               int d, float scale, int causal, void* stream) {
  if (bad_shape(b, tq, tk, hq, hkv, d, causal) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 1) {
    return with_head_dim(d, [&](auto dim) {
      return bwd_bf16<decltype(dim)::value>(q, k, v, o, dout, l, dl, dq, dk, dv, b, tq,
                                            tk, hq, hkv, scale, causal, s);
    });
  }
  return with_nc(d, [&](auto nc) {
    return bwd<float, decltype(nc)::value>(q, k, v, o, dout, l, dl, dq, dk, dv, b, tq,
                                           tk, hq, hkv, d, scale, causal, s);
  });
}

// Dynamic shared memory of the bfloat16 route's kernels at head dim d
// (kernel 0 forward, 1 dQ, 2 dK/dV; the delta kernel's is static), for the
// build report; -1 for a head dim the route does not take.
extern "C" int repro_flash_bf16_smem(int kernel, int d) {
  if (kernel < 0 || kernel > 2) return -1;
  int bytes = -1;
  with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const size_t sizes[3] = {hopper::fwd_smem<D>(), hopper::dq_smem<D>(),
                             hopper::dkdv_smem<D>()};
    bytes = static_cast<int>(sizes[kernel]);
    return 0;
  });
  return bytes;
}
