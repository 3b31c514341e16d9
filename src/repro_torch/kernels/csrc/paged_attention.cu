// Paged decode attention for Hopper (sm_90a): one query row per (row, head)
// over that row's pages of a shared physical KV pool.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attention_pallas       (_pa_kernel, pl.pallas_call at :130)
//   paged_attention_pallas_quant (_pa_quant_kernel, pl.pallas_call at :341)
// and computes what their bodies compute: scores q.k * scale in f32, an
// online softmax whose running max, sum and accumulator stay in f32,
// positions at or past lengths[b] masked out (their V rows never reach
// the sum), table entries clamped to [0, N-1], GQA reading kv head h for
// query heads h*g .. h*g+g-1, and acc / max(l, 1e-30) written in q's dtype
// (so lengths[b] <= 0 gives zeros, as _pa_kernel's _fin does).  The quant
// variant dequantizes every int8 K/V row by its f32 scale as it stages it.
//
// Bound: the bytes of the valid K/V rows (plus their scales) read once,
// over the card's 3.35 TB/s; the arithmetic is ~4 flops per byte, far
// below the tensor-core ridge, so the kernel is memory-bound.
//
// Design: the TPU grid axis over pages, which ran in order, becomes a loop
// inside the block.  One block per (row b, kv head) stages kTile K/V rows
// of its head in shared memory per step with 16-byte loads, and serves all
// g query heads of the group from that tile, so each row is read from
// device memory once per group, not once per query head.  Simple first:
// no wgmma, no TMA, no split over the sequence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;   // K/V rows staged in shared memory per step
constexpr float kNegInf = -0.7f * 3.40282347e38f;   // NEG_INF of the reference

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The reference multiplies p by V in V's dtype (p.astype(v.dtype)):
// bf16 pages round p to bf16 first; f32 and dequantized pages keep it.
__device__ __forceinline__ float in_kv_dtype(float x, const float*) { return x; }
__device__ __forceinline__ float in_kv_dtype(float x, const int8_t*) { return x; }
__device__ __forceinline__ float in_kv_dtype(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,          // (B, Hq, D)
                       const TKV* __restrict__ k,         // (N, page, Hkv, D)
                       const float* __restrict__ ks,      // (N, page, Hkv), quant only
                       const TKV* __restrict__ v,         // (N, page, Hkv, D)
                       const float* __restrict__ vs,      // (N, page, Hkv), quant only
                       const int* __restrict__ table,     // (B, nP)
                       const int* __restrict__ lengths,   // (B,)
                       TQ* __restrict__ out,              // (B, Hq, D)
                       int hq, int hkv, int d, int n, int page, int np,
                       float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // (g, d) the group's query rows, f32
  float* acc_s = q_s + g * d;        // (g, d) running numerator
  float* k_s = acc_s + g * d;        // (kTile, d) staged keys, f32
  float* v_s = k_s + kTile * d;      // (kTile, d) staged values, f32
  float* p_s = v_s + kTile * d;      // (g, kTile) scores, then probabilities
  float* m_s = p_s + g * kTile;      // (g,) running max
  float* l_s = m_s + g;              // (g,) running sum
  float* c_s = l_s + g;              // (g,) this tile's rescale factor

  // query heads h*g .. h*g+g-1 are contiguous in q's row
  const size_t head0 = static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g;
  const TQ* qb = q + head0 * d;
  for (int i = tid; i < g * d; i += kThreads) {
    q_s[i] = to_float(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // positions past the table's span cannot exist: the TPU grid had nP steps
  const int len = max(0, min(lengths[b], np * page));
  const int* tb = table + static_cast<size_t>(b) * np;
  const int d8 = d / 8;

  for (int r0 = 0; r0 < len; r0 += kTile) {
    const int rows = min(kTile, len - r0);
    __syncthreads();   // the previous tile's readers are done with k_s, v_s, p_s

    // stage this tile's K/V rows for head h (16-byte loads along d)
    for (int c = tid; c < rows * d8; c += kThreads) {
      const int r = c / d8;
      const int col = (c % d8) * 8;
      const int pos = r0 + r;
      const int phys = min(max(tb[pos / page], 0), n - 1);
      const size_t row = (static_cast<size_t>(phys) * page + pos % page) * hkv + h;
      const float sk = kQuant ? ks[row] : 1.f;
      const float sv = kQuant ? vs[row] : 1.f;
      float x[8];
      load8(k + row * d + col, x);
      float4* kd = reinterpret_cast<float4*>(k_s + r * d + col);
      kd[0] = make_float4(x[0] * sk, x[1] * sk, x[2] * sk, x[3] * sk);
      kd[1] = make_float4(x[4] * sk, x[5] * sk, x[6] * sk, x[7] * sk);
      load8(v + row * d + col, x);
      float4* vd = reinterpret_cast<float4*>(v_s + r * d + col);
      vd[0] = make_float4(x[0] * sv, x[1] * sv, x[2] * sv, x[3] * sv);
      vd[1] = make_float4(x[4] * sv, x[5] * sv, x[6] * sv, x[7] * sv);
    }
    __syncthreads();

    // scores: one warp per (query head in group, row), lanes split d
    for (int pr = warp; pr < g * rows; pr += kWarps) {
      const int gi = pr / rows;
      const int r = pr % rows;
      float dot = 0.f;
      for (int i = lane; i < d; i += 32) dot += q_s[gi * d + i] * k_s[r * d + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) p_s[gi * kTile + r] = dot * scale;
    }
    __syncthreads();

    // running softmax statistics: one thread per query head
    for (int gi = tid; gi < g; gi += kThreads) {
      float* p = p_s + gi * kTile;
      const float m_old = m_s[gi];
      float m_new = m_old;
      for (int r = 0; r < rows; ++r) m_new = fmaxf(m_new, p[r]);
      float sum = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float e = expf(p[r] - m_new);
        sum += e;
        p[r] = in_kv_dtype(e, k);
      }
      const float corr = expf(m_old - m_new);
      l_s[gi] = l_s[gi] * corr + sum;
      m_s[gi] = m_new;
      c_s[gi] = corr;
    }
    __syncthreads();

    // numerator: each thread owns fixed (head, column) entries of acc
    for (int i = tid; i < g * d; i += kThreads) {
      const int gi = i / d;
      const int col = i % d;
      const float* p = p_s + gi * kTile;
      float pv = 0.f;
      for (int r = 0; r < rows; ++r) pv += p[r] * v_s[r * d + col];
      acc_s[i] = acc_s[i] * c_s[gi] + pv;
    }
  }
  __syncthreads();

  TQ* ob = out + head0 * d;
  for (int i = tid; i < g * d; i += kThreads) {
    store(ob + i, acc_s[i] / fmaxf(l_s[i / d], 1e-30f));
  }
}

template <typename TQ, typename TKV, bool kQuant>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* table, const void* lengths, void* out,
           int b, int hq, int hkv, int d, int n, int page, int np, float scale,
           void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || d % 8 != 0 || d > 256 || n < 1 ||
      page < 1 || np < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g = hq / hkv;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(g) * d + 2 * kTile * d + g * kTile + 3 * g);
  auto kernel = paged_attention_kernel<TQ, TKV, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(b, hkv), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const float*>(ks), static_cast<const TKV*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<TQ*>(out),
      hq, hkv, d, n, page, np, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q and the output; the plain
// kernel's pages share q's dtype, the quant kernel's pages are int8).
extern "C" int repro_paged_attention(int dtype, const void* q, const void* k,
                                     const void* v, const void* table,
                                     const void* lengths, void* out, int b,
                                     int hq, int hkv, int d, int n, int page,
                                     int np, float scale, void* stream) {
  if (dtype == 0) {
    return launch<float, float, false>(q, k, nullptr, v, nullptr, table, lengths,
                                       out, b, hq, hkv, d, n, page, np, scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, nullptr, v, nullptr, table, lengths, out, b, hq, hkv, d, n, page,
        np, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_paged_attention_quant(int dtype, const void* q,
                                           const void* k, const void* ks,
                                           const void* v, const void* vs,
                                           const void* table, const void* lengths,
                                           void* out, int b, int hq, int hkv,
                                           int d, int n, int page, int np,
                                           float scale, void* stream) {
  if (dtype == 0) {
    return launch<float, int8_t, true>(q, k, ks, v, vs, table, lengths, out, b,
                                       hq, hkv, d, n, page, np, scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, int8_t, true>(q, k, ks, v, vs, table, lengths,
                                               out, b, hq, hkv, d, n, page, np,
                                               scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
