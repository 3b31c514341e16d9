// The Mamba2 SSD scan (Zamba2's backbone) for Hopper (sm_90a): forward, and a
// deterministic backward recomputed from the forward's chunk-boundary states.
//
// The forward replaces the TPU kernel in src/repro/kernels/mamba2_ssd.py:
//   mamba2_pallas (_ssd_kernel, pl.pallas_call at :101)
// and computes what its body computes, per batch row b and head h:
//   S_t = exp(A_h dt_t) S_{t-1} + dt_t x_t B_t^T    (P x N, f32)
//   y_t = S_t C_t                                    (written in x's dtype)
// with x, B, C read in their dtype (f32 or bf16; B and C are shared by every
// head of a batch row), dt and A in f32, every product and sum in f32, and
// the final state in f32.  Unlike the Pallas kernel, which asserts a zero
// initial state, it starts from a given state s0.  The TPU kernel's chunked
// matmul form (cumulative log-decays over chunks of 64) was shaped by the
// MXU; here the recurrence runs step by step and stops at T: no padding.
//
// The reference has no backward kernel (JAX differentiates the jnp chunked
// version).  With H_t = dL/dS_t and a_t = A dt_t, the backward walks each
// chunk of kChunk tokens in reverse:
//   H_t = dy_t C_t^T + exp(a_{t+1}) H_{t+1}
//   dx_t = dt_t H_t B_t,   dB_t = dt_t sum_h H_t^T x_t,   dC_t = sum_h S_t^T dy_t
//   ddt_t = A da_t + x_t . (H_t B_t),   dA = sum_t dt_t da_t
//   da_t = sum H_t . (exp(a_t) S_{t-1})
// The states of a chunk are recomputed forward from the state the forward
// saved at the chunk's start; S is never walked backwards by dividing by
// exp(a_t), which reaches ~0.  da needs S_{t-1} beside H_t, which run in
// opposite directions, so it goes through the scalar Z_t = sum H_t . S_t:
//   da_t = Z_t - dt_t x_t . (H_t B_t),   Z_{t-1} = da_t + dy_{t-1} . y_{t-1}
// with Z at each chunk's end paired directly from H and the recomputed S;
// the recurrence never runs longer than one chunk.  dB and dC are written
// per head and dA per (b, h); the caller sums them over heads and batch
// rows in a fixed order.  The terms of the per-token scalar chain (y_t,
// H_t B_t and H . S, from the f32 states), the chain itself (Z, da) and
// dA's sum over T run in f64: in f32, dA lay ~3e-5 of its magnitude from
// a float64 computation, farther than the plain version.  No atomics
// anywhere, so the same inputs give the same bits.
//
// Bound: at zamba2-2.7b's training shape (B 4, T 512, 80 heads, P = N = 64,
// bf16 x/B/C) the forward must move ~48 MB and do ~1.3 GFLOP, so on paper it
// is bound by bytes (~0.014 ms at 3.35 TB/s).  This first design is bound by
// the serial walk over T: each block runs 512 dependent steps.
//
// Design.  Forward: one block per (b, h) of max(P, N) threads; thread p keeps
// the row S[p, :] in registers, so y_t[p] is thread-local; each chunk's B, C,
// x rows, dt and decays are staged in shared memory and read by broadcast.
// Backward: one block per (b, h) of 2 max(P, N) threads in two roles over the
// staged chunk.  Row role (thread p): S[p, :] and H[p, :], for dx, ds0 and
// the per-token sums behind ddt and dA.  Column role (thread n): S[:, n] and
// H[:, n], for dB and dC.  The per-token scalars reduce over p through
// shared memory in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 32;   // tokens staged at once; the state-save interval

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// element (b, t, h, i) of a contiguous (B, T, H, W) tensor
__device__ __forceinline__ size_t at(int b, int t, int h, int i, int t_len, int heads,
                                     int width) {
  return ((static_cast<size_t>(b) * t_len + t) * heads + h) * width + i;
}

// Stage tokens [t0, t0 + n) of head h of a (B, T, H, W) tensor as f32 rows of
// MM, zero past n and past W.
template <typename T, int MM>
__device__ __forceinline__ void stage(float (*dst)[MM], const T* src, int b, int t0,
                                     int n, int h, int t_len, int heads, int width) {
  for (int idx = threadIdx.x; idx < kChunk * MM; idx += blockDim.x) {
    const int j = idx / MM;
    const int i = idx % MM;
    dst[j][i] = (j < n && i < width)
        ? to_float(src[at(b, t0 + j, h, i, t_len, heads, width)]) : 0.f;
  }
}

// dt_t and the decay exp(A dt_t) of the chunk's tokens
__device__ __forceinline__ void stage_dt(float* dt_s, float* dec_s, const float* dt,
                                        float a, int b, int t0, int n, int h,
                                        int t_len, int heads) {
  for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
    const float x = j < n ? dt[(static_cast<size_t>(b) * t_len + t0 + j) * heads + h]
                          : 0.f;
    dt_s[j] = x;
    dec_s[j] = expf(a * x);
  }
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

template <typename T, int MM>
__global__ void __launch_bounds__(MM)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ s_out,
               float* __restrict__ ckpt,    // (B, H, nc, P, N) or null
               int t_len, int heads, int p, int n) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int pp = threadIdx.x;
  const bool live = pp < p;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const int nc = (t_len + kChunk - 1) / kChunk;
  const float a = A[h];

  __shared__ float b_s[kChunk][MM], c_s[kChunk][MM], x_s[kChunk][MM];
  __shared__ float dt_s[kChunk], dec_s[kChunk];

  float S[MM];   // S[p, :]
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    S[i] = (live && i < n) ? s0[(bh * p + pp) * n + i] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk;
    const int cn = min(kChunk, t_len - t0);
    if (ckpt != nullptr && live) {
      float* dst = ckpt + ((bh * nc + c) * p + pp) * n;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        if (i < n) dst[i] = S[i];
      }
    }
    __syncthreads();   // the previous chunk's readers are done
    stage<T, MM>(b_s, Bm, b, t0, cn, 0, t_len, 1, n);
    stage<T, MM>(c_s, Cm, b, t0, cn, 0, t_len, 1, n);
    stage<T, MM>(x_s, x, b, t0, cn, h, t_len, heads, p);
    stage_dt(dt_s, dec_s, dt, a, b, t0, cn, h, t_len, heads);
    __syncthreads();

    for (int j = 0; j < cn; ++j) {
      const float dec = dec_s[j];
      const float dtx = dt_s[j] * x_s[j][pp];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MM; ++i) {
        S[i] = dec * S[i] + dtx * b_s[j][i];
        acc += S[i] * c_s[j][i];
      }
      if (live) store(y + at(b, t0 + j, h, pp, t_len, heads, p), acc);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < n) s_out[(bh * p + pp) * n + i] = S[i];
    }
  }
}

// ---------------------------------------------------------------------- //
// backward
// ---------------------------------------------------------------------- //

template <int MM>
struct BwdSmem {
  float b[kChunk][MM], c[kChunk][MM], x[kChunk][MM], dy[kChunk][MM];
  double e_part[kChunk][MM];   // dy_t[p] y_t[p]
  double xq_part[kChunk][MM];  // x_t[p] (H_t B_t)[p]
  double z_part[MM];           // (H . S)[p, :] summed, at the chunk's end
  double e_sum[kChunk], xq_sum[kChunk];
  float dt[kChunk], dec[kChunk];
};

template <typename T, int MM>
__global__ void __launch_bounds__(2 * MM)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ ckpt,
               const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ ddt,       // (B, T, H)
               float* __restrict__ dA_part,   // (B, H)
               float* __restrict__ dB_head,   // (B, T, H, N)
               float* __restrict__ dC_head,   // (B, T, H, N)
               float* __restrict__ ds0,       // (B, H, P, N)
               int t_len, int heads, int p, int n) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool row_role = threadIdx.x < MM;
  const int me = row_role ? threadIdx.x : threadIdx.x - MM;   // p or n
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const int nc = (t_len + kChunk - 1) / kChunk;
  const float a = A[h];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<MM>& sm = *reinterpret_cast<BwdSmem<MM>*>(smem_raw);

  float S[MM];   // row role: S[p, :]; column role: S[:, n]
  float H[MM];   // row role: H[p, :]; column role: H[:, n]
#pragma unroll
  for (int i = 0; i < MM; ++i) S[i] = H[i] = 0.f;
  // the per-token scalar chain and the sum over T run in f64 (one thread,
  // a few operations per token): in f32 the 512-term sum behind dA alone
  // lost ~3e-5 of its magnitude
  double dA_acc = 0.0;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int cn = min(kChunk, t_len - t0);
    __syncthreads();   // the previous chunk's readers are done
    stage<T, MM>(sm.b, Bm, b, t0, cn, 0, t_len, 1, n);
    stage<T, MM>(sm.c, Cm, b, t0, cn, 0, t_len, 1, n);
    stage<T, MM>(sm.x, x, b, t0, cn, h, t_len, heads, p);
    stage<T, MM>(sm.dy, dy, b, t0, cn, h, t_len, heads, p);
    stage_dt(sm.dt, sm.dec, dt, a, b, t0, cn, h, t_len, heads);
    __syncthreads();
    const float* base = ckpt + (bh * nc + c) * p * n;

    if (row_role) {
      const int pp = me;
      const bool live = pp < p;
#pragma unroll
      for (int i = 0; i < MM; ++i) S[i] = (live && i < n) ? base[pp * n + i] : 0.f;
      for (int j = 0; j < cn; ++j) {
        const float dec = sm.dec[j];
        const float dtx = sm.dt[j] * sm.x[j][pp];
        double acc = 0.0;
#pragma unroll
        for (int i = 0; i < MM; ++i) {
          S[i] = dec * S[i] + dtx * sm.b[j][i];
          acc += static_cast<double>(S[i]) * sm.c[j][i];
        }
        sm.e_part[j][pp] = sm.dy[j][pp] * acc;
      }
      for (int j = cn - 1; j >= 0; --j) {
        const float g = sm.dy[j][pp];
#pragma unroll
        for (int i = 0; i < MM; ++i) H[i] += g * sm.c[j][i];
        if (j == cn - 1) {   // S is S_{c1-1}, H is H_{c1-1}
          double z = 0.0;
#pragma unroll
          for (int i = 0; i < MM; ++i) z += static_cast<double>(H[i]) * S[i];
          sm.z_part[pp] = z;
        }
        double q = 0.0;
#pragma unroll
        for (int i = 0; i < MM; ++i) q += static_cast<double>(H[i]) * sm.b[j][i];
        if (live) store(dx + at(b, t0 + j, h, pp, t_len, heads, p),
                        static_cast<float>(sm.dt[j] * q));
        sm.xq_part[j][pp] = sm.x[j][pp] * q;
        const float dec = sm.dec[j];
#pragma unroll
        for (int i = 0; i < MM; ++i) H[i] *= dec;
      }
    } else {
      const int nn = me;
      const bool live = nn < n;
#pragma unroll
      for (int i = 0; i < MM; ++i) S[i] = (live && i < p) ? base[i * n + nn] : 0.f;
      for (int j = 0; j < cn; ++j) {
        const float dec = sm.dec[j];
        const float bj = sm.b[j][nn];
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < MM; ++i) {
          S[i] = dec * S[i] + (sm.dt[j] * sm.x[j][i]) * bj;
          acc += sm.dy[j][i] * S[i];
        }
        if (live) dC_head[at(b, t0 + j, h, nn, t_len, heads, n)] = acc;
      }
      for (int j = cn - 1; j >= 0; --j) {
        const float cj = sm.c[j][nn];
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < MM; ++i) {
          H[i] += sm.dy[j][i] * cj;
          acc += H[i] * sm.x[j][i];
        }
        if (live) dB_head[at(b, t0 + j, h, nn, t_len, heads, n)] = sm.dt[j] * acc;
        const float dec = sm.dec[j];
#pragma unroll
        for (int i = 0; i < MM; ++i) H[i] *= dec;
      }
    }
    __syncthreads();
    // per-token sums over p, each in order of p
    for (int j = threadIdx.x; j < cn; j += blockDim.x) {
      double es = 0.0, xs = 0.0;
      for (int i = 0; i < p; ++i) {
        es += sm.e_part[j][i];
        xs += sm.xq_part[j][i];
      }
      sm.e_sum[j] = es;
      sm.xq_sum[j] = xs;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double z = 0.0;
      for (int i = 0; i < p; ++i) z += sm.z_part[i];
      for (int j = cn - 1; j >= 0; --j) {
        const double da = z - sm.dt[j] * sm.xq_sum[j];
        ddt[(static_cast<size_t>(b) * t_len + t0 + j) * heads + h] =
            static_cast<float>(a * da + sm.xq_sum[j]);
        dA_acc += sm.dt[j] * da;
        z = da + (j > 0 ? sm.e_sum[j - 1] : 0.0);
      }
    }
  }

  if (threadIdx.x == 0) dA_part[bh] = static_cast<float>(dA_acc);
  if (row_role && me < p) {
    float* dst = ds0 + (bh * p + me) * n;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      if (i < n) dst[i] = H[i];
    }
  }
}

// ---------------------------------------------------------------------- //
// launchers
// ---------------------------------------------------------------------- //

bool bad_shape(int b, int t, int h, int p, int n) {
  return b < 1 || t < 1 || h < 1 || p < 1 || n < 1 || p > 64 || n > 64;
}

template <typename T, int MM>
int fwd(const void* x, const float* dt, const float* A, const void* Bm,
        const void* Cm, const float* s0, void* y, float* s_out, float* ckpt, int b,
        int t, int h, int p, int n, cudaStream_t stream) {
  ssd_fwd_kernel<T, MM><<<dim3(h, b), MM, 0, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), s0, static_cast<T*>(y), s_out, ckpt, t, h, p, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MM>
int bwd(const void* x, const float* dt, const float* A, const void* Bm,
        const void* Cm, const float* ckpt, const void* dy, void* dx, float* ddt,
        float* dA_part, float* dB_head, float* dC_head, float* ds0, int b, int t,
        int h, int p, int n, cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<T, MM>;
  const size_t smem = sizeof(BwdSmem<MM>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(h, b), 2 * MM, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), ckpt, static_cast<const T*>(dy), static_cast<T*>(dx),
      ddt, dA_part, dB_head, dC_head, ds0, t, h, p, n);
  return static_cast<int>(cudaGetLastError());
}

// f(MM) for the bucket MM = 16, 32 or 64 that holds both P and N
template <typename F>
int with_mm(int p, int n, F&& f) {
  const int m = p > n ? p : n;
  if (m <= 16) return f(std::integral_constant<int, 16>{});
  if (m <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 for x, B, C, y (and dy, dx); dt, A,
// the states, ddt and the partial sums are float32.  Tensors are contiguous:
// x, y (B, T, H, P), dt (B, T, H), A (H), B, C (B, T, N), states (B, H, P, N),
// the saved chunk-start states (B, H, ceil(T / 32), P, N) -- null to save none.
extern "C" int repro_ssd_fwd(int dtype, const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* s0, void* y,
                             void* s_out, void* ckpt, int b, int t, int h, int p,
                             int n, void* stream) {
  if (bad_shape(b, t, h, p, n) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  float* ck = static_cast<float*>(ckpt);
  return with_mm(p, n, [&](auto mm) {
    constexpr int MM = decltype(mm)::value;
    return dtype == 0
        ? fwd<float, MM>(x, dtf, af, Bm, Cm, s0f, y, so, ck, b, t, h, p, n, s)
        : fwd<__nv_bfloat16, MM>(x, dtf, af, Bm, Cm, s0f, y, so, ck, b, t, h, p, n, s);
  });
}

extern "C" int repro_ssd_bwd(int dtype, const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* ckpt,
                             const void* dy, void* dx, void* ddt, void* dA_part,
                             void* dB_head, void* dC_head, void* ds0, int b, int t,
                             int h, int p, int n, void* stream) {
  if (bad_shape(b, t, h, p, n) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* ck = static_cast<const float*>(ckpt);
  float* ddtf = static_cast<float*>(ddt);
  float* dap = static_cast<float*>(dA_part);
  float* dbh = static_cast<float*>(dB_head);
  float* dch = static_cast<float*>(dC_head);
  float* ds = static_cast<float*>(ds0);
  return with_mm(p, n, [&](auto mm) {
    constexpr int MM = decltype(mm)::value;
    return dtype == 0
        ? bwd<float, MM>(x, dtf, af, Bm, Cm, ck, dy, dx, ddtf, dap, dbh, dch, ds, b, t,
                         h, p, n, s)
        : bwd<__nv_bfloat16, MM>(x, dtf, af, Bm, Cm, ck, dy, dx, ddtf, dap, dbh, dch,
                                 ds, b, t, h, p, n, s);
  });
}
