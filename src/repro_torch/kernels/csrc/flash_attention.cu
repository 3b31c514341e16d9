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
// differentiates the jnp version); this one is the standard flash backward:
//   delta_i = dO_i . O_i                       (flash_bwd_delta)
//   p_ij = exp(s_ij - lse_i), ds_ij = p_ij (dO_i . v_j - delta_i)
//   dQ_i = scale sum_j ds_ij k_j               (flash_bwd_dq: one block per
//                                               q tile, loops over k tiles)
//   dK_j = scale sum_i ds_ij q_i, dV_j = sum_i p_ij dO_i
//                                              (flash_bwd_dkdv: one block per
//                                               k tile and kv head, loops over
//                                               the group's heads and q tiles)
// Every sum runs in a fixed order in one block and no atomics are used, so
// the backward is deterministic: the same inputs give the same bits.
//
// Bound: at the training shape (B 4, T 512, 32 heads of 96) the causal
// forward does ~6.4 GFLOP against ~50 MB of bf16 q/k/v/o, so on the tensor
// cores it would be bound by bytes; this first kernel does its products on
// the f32 CUDA cores (exact f32 for float32 inputs), so it is bound by those
// operations, far from the tensor-core rate.  Making it fast (wgmma, TMA,
// warp specialisation) is later work.
//
// Design: the TPU grid axis over k blocks, which ran in order with the
// softmax state in VMEM scratch, becomes a loop inside the block.  A block
// of 4 warps owns 32 query rows (8 per warp); each 32-key tile is staged in
// shared memory in f32, K transposed with a padded stride so that lane j
// reads key j without bank conflicts.  A lane computes one key's score for
// its warp's 8 rows; the softmax statistics reduce over the warp with
// shuffles; for p.V each lane owns columns lane, lane+32, ... of the 8 rows'
// accumulators and receives p_ij from lane j by shuffle.

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// p.astype(v.dtype): bf16 V rounds p to bf16 first; f32 keeps it
__device__ __forceinline__ float in_dtype(float x, const float*) { return x; }
__device__ __forceinline__ float in_dtype(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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
      p[i] = in_dtype(e, v);
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
// launchers
// ---------------------------------------------------------------------- //

bool bad_shape(int b, int tq, int tk, int hq, int hkv, int d) {
  return b < 1 || tq < 1 || tk < tq || hkv < 1 || hq % hkv != 0 || d % 8 != 0 ||
         d < 8 || d > 256;
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

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o and the gradients share
// it; lse and delta are f32).  Tensors are contiguous (B, T, H, D).
extern "C" int repro_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int b, int tq,
                               int tk, int hq, int hkv, int d, float scale,
                               int causal, void* stream) {
  if (bad_shape(b, tq, tk, hq, hkv, d) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return with_nc(d, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    return dtype == 0
        ? fwd<float, NC>(q, k, v, o, l, b, tq, tk, hq, hkv, d, scale, causal, s)
        : fwd<__nv_bfloat16, NC>(q, k, v, o, l, b, tq, tk, hq, hkv, d, scale,
                                 causal, s);
  });
}

extern "C" int repro_flash_bwd(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* dq, void* dk,
                               void* dv, int b, int tq, int tk, int hq, int hkv,
                               int d, float scale, int causal, void* stream) {
  if (bad_shape(b, tq, tk, hq, hkv, d) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  return with_nc(d, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    return dtype == 0
        ? bwd<float, NC>(q, k, v, o, dout, l, dl, dq, dk, dv, b, tq, tk, hq, hkv,
                         d, scale, causal, s)
        : bwd<__nv_bfloat16, NC>(q, k, v, o, dout, l, dl, dq, dk, dv, b, tq, tk,
                                 hq, hkv, d, scale, causal, s);
  });
}
