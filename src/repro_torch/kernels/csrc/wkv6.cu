// The WKV6 recurrence of RWKV6 ("Finch") for Hopper (sm_90a): forward, and a
// deterministic backward recomputed from the forward's chunk-boundary states.
//
// The forward replaces the TPU kernel in src/repro/kernels/rwkv6_scan.py:
//   wkv6_pallas (_wkv6_kernel, pl.pallas_call at :110)
// and computes what its body computes, per batch row b and head h:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T          (D x D, f32)
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)       (written in r's dtype)
// with r, k, v read in their dtype (f32 or bf16), w and u in f32, every
// product and sum in f32, and the final state written in f32.  Unlike the
// Pallas kernel, which asserts a zero initial state, it starts from a given
// state s0.  The TPU kernel's chunked matmul form (re-centred exponents over
// chunks of 16) was shaped by the MXU; here the recurrence runs step by step,
// so there are no exponents at all and no padding: the loop stops at T.
//
// The reference has no backward kernel (JAX differentiates the jnp chunked
// version).  The backward walks each chunk of kChunk tokens in reverse, with
// G_t = dL/dS_t carried across chunks:
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T                 (G_{T-1} = 0)
//   dr_t = S_{t-1} dy_t + u . k_t (dy_t . v_t)
//   dk_t = G_t v_t + r_t . u (dy_t . v_t)
//   dv_t = G_t^T k_t + dy_t (r_t . u k_t)
//   du   = sum_t r_t . k_t (dy_t . v_t)
//   dw_t = da_t / w_t,  da_t = sum_e G_t[:, e] (w_t . S_{t-1}[:, e])
// The states S_{t-1} of a chunk are recomputed forward from the state the
// forward saved at the chunk's start; S is never walked backwards by
// dividing by the decay (w reaches e^-e, and each division would multiply
// the rounding error).  da needs S_{t-1} beside G_t, which run in opposite
// directions, so it goes through Z_t = sum_e G_t[:, e] . S_t[:, e]:
//   da_t = Z_t - k_t . (G_t v_t),   Z_{t-1} = da_t + r_t . (S_{t-1} dy_t)
// with Z at each chunk's end paired directly from G and the recomputed S;
// the recurrence never runs longer than one chunk.  du is written per
// (b, h) and summed over b by the caller in a fixed order; no atomics
// anywhere, so the same inputs give the same bits.
//
// Bound: at rwkv6-3b's training shape (B 4, T 512, 40 heads of 64, bf16
// r/k/v, f32 w) the forward must move ~66 MB and do ~1.3 GFLOP, so on paper
// it is bound by bytes (~0.02 ms at 3.35 TB/s).  This first design is bound
// by the serial walk over T: each block runs 512 dependent steps.
//
// Design.  Forward: one block per (b, h) of D threads; thread e keeps the
// column S[:, e] in registers; each chunk's r, k, v, w rows are staged in
// shared memory and read by broadcast; the state is saved at every chunk
// start.  Backward: one block per (b, h) of 2 D threads in two roles that
// share the staged chunk.  Row role (thread i): S[i, :] and G[i, :], for
// dr, dk, dw, du, ds0 -- all sums over e, thread-local.  Column role
// (thread e): G[:, e], for dv -- a sum over i, thread-local.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 32;   // tokens staged at once; the state-save interval

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// element (b, t, h, i) of a contiguous (B, T, H, D) tensor
__device__ __forceinline__ size_t at(int b, int t, int h, int i, int t_len, int heads,
                                     int d) {
  return ((static_cast<size_t>(b) * t_len + t) * heads + h) * d + i;
}

// Stage tokens [t0, t0 + n) of head h of a (B, T, H, D) tensor as f32 rows of
// DM, zero past n and past d.
template <typename T, int DM>
__device__ __forceinline__ void stage(float (*dst)[DM], const T* src, int b, int t0,
                                     int n, int h, int t_len, int heads, int d) {
  for (int idx = threadIdx.x; idx < kChunk * DM; idx += blockDim.x) {
    const int j = idx / DM;
    const int i = idx % DM;
    dst[j][i] = (j < n && i < d) ? to_float(src[at(b, t0 + j, h, i, t_len, heads, d)])
                                 : 0.f;
  }
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

template <typename T, int DM>
__global__ void __launch_bounds__(DM)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ s_out,
                float* __restrict__ ckpt,     // (B, H, nc, D, D) or null
                int t_len, int heads, int d) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x;
  const bool live = e < d;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const int nc = (t_len + kChunk - 1) / kChunk;

  __shared__ float r_s[kChunk][DM], k_s[kChunk][DM], v_s[kChunk][DM], w_s[kChunk][DM];
  __shared__ float u_s[DM], bonus_s[kChunk];

  u_s[e] = live ? u[static_cast<size_t>(h) * d + e] : 0.f;
  float S[DM];   // S[:, e]
#pragma unroll
  for (int i = 0; i < DM; ++i) {
    S[i] = (live && i < d) ? s0[(bh * d + i) * d + e] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, t_len - t0);
    if (ckpt != nullptr && live) {
      float* dst = ckpt + (bh * nc + c) * d * d;
#pragma unroll
      for (int i = 0; i < DM; ++i) {
        if (i < d) dst[i * d + e] = S[i];
      }
    }
    __syncthreads();   // the previous chunk's readers are done
    stage<T, DM>(r_s, r, b, t0, n, h, t_len, heads, d);
    stage<T, DM>(k_s, k, b, t0, n, h, t_len, heads, d);
    stage<T, DM>(v_s, v, b, t0, n, h, t_len, heads, d);
    stage<float, DM>(w_s, w, b, t0, n, h, t_len, heads, d);
    __syncthreads();
    // the bonus scalar r_t . (u k_t) of each token, summed in order of i
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < d; ++i) acc += r_s[j][i] * u_s[i] * k_s[j][i];
      bonus_s[j] = acc;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float vj = v_s[j][e];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DM; ++i) acc += r_s[j][i] * S[i];
      if (live) store(y + at(b, t0 + j, h, e, t_len, heads, d), acc + bonus_s[j] * vj);
#pragma unroll
      for (int i = 0; i < DM; ++i) S[i] = w_s[j][i] * S[i] + k_s[j][i] * vj;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DM; ++i) {
      if (i < d) s_out[(bh * d + i) * d + e] = S[i];
    }
  }
}

// ---------------------------------------------------------------------- //
// backward
// ---------------------------------------------------------------------- //

template <int DM>
struct BwdSmem {
  float r[kChunk][DM], k[kChunk][DM], v[kChunk][DM], w[kChunk][DM], dy[kChunk][DM];
  float drs[kChunk][DM];   // r-side state term S_{t-1} dy_t, per token and row
  float u[DM], dotdv[kChunk], bonus[kChunk];
};

template <typename T, int DM>
__global__ void __launch_bounds__(2 * DM)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const T* __restrict__ dy, T* __restrict__ dr, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part,   // (B, H, D)
                float* __restrict__ ds0,       // (B, H, D, D)
                int t_len, int heads, int d) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool row_role = threadIdx.x < DM;
  const int me = row_role ? threadIdx.x : threadIdx.x - DM;   // i or e
  const bool live = me < d;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const int nc = (t_len + kChunk - 1) / kChunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DM>& sm = *reinterpret_cast<BwdSmem<DM>*>(smem_raw);
  if (threadIdx.x < DM) {
    sm.u[threadIdx.x] = threadIdx.x < d ? u[static_cast<size_t>(h) * d + threadIdx.x] : 0.f;
  }

  float S[DM];   // row role: S[i, :]
  float G[DM];   // row role: G[i, :]; column role: G[:, e]
#pragma unroll
  for (int x = 0; x < DM; ++x) S[x] = G[x] = 0.f;
  double du_acc = 0.0;   // a sum over T: in f64, as the SSD's dA

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, t_len - t0);
    __syncthreads();   // the previous chunk's readers are done
    stage<T, DM>(sm.r, r, b, t0, n, h, t_len, heads, d);
    stage<T, DM>(sm.k, k, b, t0, n, h, t_len, heads, d);
    stage<T, DM>(sm.v, v, b, t0, n, h, t_len, heads, d);
    stage<float, DM>(sm.w, w, b, t0, n, h, t_len, heads, d);
    stage<T, DM>(sm.dy, dy, b, t0, n, h, t_len, heads, d);
    __syncthreads();
    // per token: dy_t . v_t and the bonus r_t . (u k_t), each in order
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float dd = 0.f, bo = 0.f;
      for (int x = 0; x < d; ++x) {
        dd += sm.dy[j][x] * sm.v[j][x];
        bo += sm.r[j][x] * sm.u[x] * sm.k[j][x];
      }
      sm.dotdv[j] = dd;
      sm.bonus[j] = bo;
    }
    __syncthreads();

    if (row_role) {
      const int i = me;
      const float ui = sm.u[i];
      // the chunk's states, forward from the saved one: dr and S_{t-1} dy_t
      const float* src = ckpt + (bh * nc + c) * d * d + static_cast<size_t>(i) * d;
#pragma unroll
      for (int e = 0; e < DM; ++e) S[e] = (live && e < d) ? src[e] : 0.f;
      for (int j = 0; j < n; ++j) {
        float drs = 0.f;
#pragma unroll
        for (int e = 0; e < DM; ++e) drs += sm.dy[j][e] * S[e];
        sm.drs[j][i] = drs;
        const float rk = sm.r[j][i] * sm.k[j][i];
        du_acc += rk * sm.dotdv[j];
        if (live) store(dr + at(b, t0 + j, h, i, t_len, heads, d),
                        drs + ui * sm.k[j][i] * sm.dotdv[j]);
        const float wi = sm.w[j][i];
        const float ki = sm.k[j][i];
#pragma unroll
        for (int e = 0; e < DM; ++e) S[e] = wi * S[e] + ki * sm.v[j][e];
      }
      // S is S_{c1-1} and G is G_{c1-1}: Z at the chunk's end, paired directly
      float z = 0.f;
#pragma unroll
      for (int e = 0; e < DM; ++e) z += G[e] * S[e];
      for (int j = n - 1; j >= 0; --j) {
        float dks = 0.f;
#pragma unroll
        for (int e = 0; e < DM; ++e) dks += G[e] * sm.v[j][e];
        const float ri = sm.r[j][i];
        const float ki = sm.k[j][i];
        const float wi = sm.w[j][i];
        const float da = z - ki * dks;
        if (live) {
          const size_t o = at(b, t0 + j, h, i, t_len, heads, d);
          store(dk + o, dks + ri * ui * sm.dotdv[j]);
          // w under the plain version's clamp at 1e-30 gets no gradient
          dw[o] = wi > 1e-30f ? da / wi : 0.f;
        }
        z = da + ri * sm.drs[j][i];
#pragma unroll
        for (int e = 0; e < DM; ++e) G[e] = wi * G[e] + ri * sm.dy[j][e];
      }
    } else {
      const int e = me;
      for (int j = n - 1; j >= 0; --j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < DM; ++i) acc += G[i] * sm.k[j][i];
        const float dye = sm.dy[j][e];
        if (live) store(dv + at(b, t0 + j, h, e, t_len, heads, d),
                        acc + dye * sm.bonus[j]);
#pragma unroll
        for (int i = 0; i < DM; ++i) G[i] = sm.w[j][i] * G[i] + sm.r[j][i] * dye;
      }
    }
  }

  if (row_role && live) {
    du_part[bh * d + me] = static_cast<float>(du_acc);
    float* dst = ds0 + (bh * d + me) * d;
#pragma unroll
    for (int e = 0; e < DM; ++e) {
      if (e < d) dst[e] = G[e];
    }
  }
}

// ---------------------------------------------------------------------- //
// launchers
// ---------------------------------------------------------------------- //

bool bad_shape(int b, int t, int h, int d) {
  return b < 1 || t < 1 || h < 1 || d < 1 || d > 64;
}

template <typename T, int DM>
int fwd(const void* r, const void* k, const void* v, const float* w, const float* u,
        const float* s0, void* y, float* s_out, float* ckpt, int b, int t, int h,
        int d, cudaStream_t stream) {
  wkv6_fwd_kernel<T, DM><<<dim3(h, b), DM, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      u, s0, static_cast<T*>(y), s_out, ckpt, t, h, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DM>
int bwd(const void* r, const void* k, const void* v, const float* w, const float* u,
        const float* ckpt, const void* dy, void* dr, void* dk, void* dv, float* dw,
        float* du_part, float* ds0, int b, int t, int h, int d, cudaStream_t stream) {
  auto kernel = wkv6_bwd_kernel<T, DM>;
  const size_t smem = sizeof(BwdSmem<DM>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(h, b), 2 * DM, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      u, ckpt, static_cast<const T*>(dy), static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), dw, du_part, ds0, t, h, d);
  return static_cast<int>(cudaGetLastError());
}

// f(DM) for the head-size bucket DM = 16, 32 or 64 that holds d
template <typename F>
int with_dm(int d, F&& f) {
  if (d <= 16) return f(std::integral_constant<int, 16>{});
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 for r, k, v, y (and dy, dr, dk,
// dv); w, u, the states and dw are float32.  Tensors are contiguous:
// r, k, v, w, y (B, T, H, D), u (H, D), states (B, H, D, D), the saved
// chunk-start states (B, H, ceil(T / 32), D, D) -- null to save none.
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
  return with_dm(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    return dtype == 0
        ? fwd<float, DM>(r, k, v, wf, uf, s0f, y, so, ck, b, t, h, d, s)
        : fwd<__nv_bfloat16, DM>(r, k, v, wf, uf, s0f, y, so, ck, b, t, h, d, s);
  });
}

extern "C" int repro_wkv6_bwd(int dtype, const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* ckpt,
                              const void* dy, void* dr, void* dk, void* dv, void* dw,
                              void* du_part, void* ds0, int b, int t, int h, int d,
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
  float* ds = static_cast<float*>(ds0);
  return with_dm(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    return dtype == 0
        ? bwd<float, DM>(r, k, v, wf, uf, ck, dy, dr, dk, dv, dwf, dup, ds, b, t, h,
                         d, s)
        : bwd<__nv_bfloat16, DM>(r, k, v, wf, uf, ck, dy, dr, dk, dv, dwf, dup, ds, b,
                                 t, h, d, s);
  });
}
