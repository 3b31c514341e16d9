// XOR parity reduce for Hopper (sm_90a): (R, M, 128) int32 -> (M, 128) int32,
// out = x[0] ^ x[1] ^ ... ^ x[R-1].
//
// Replaces the TPU kernel in src/repro/kernels/xor_parity.py:
//   xor_reduce_pallas (_xor_reduce_kernel, pl.pallas_call at :47)
// and computes what its body computes, exactly (XOR has no rounding).
//
// Bound: bytes.  Each of the R inputs is read once and the output written
// once, (R + 1) * M * 512 bytes over the H100 SXM's published 3.35 TB/s (at
// its 700 W limit); one XOR per word is nothing beside that.
//
// Design: the TPU grid over row blocks, which staged (R, 256, 128) tiles in
// VMEM, becomes a grid-stride loop over 16-byte words: each thread loads one
// int4 from every fragment in turn (neighbouring threads on neighbouring
// addresses, so every load is coalesced), XORs them in registers and stores
// one int4.  No shared memory: nothing is reused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
xor_reduce_kernel(const int4* __restrict__ x,   // (R, n4) 16-byte words
                  int4* __restrict__ out,       // (n4,)
                  int r, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    int4 acc = x[i];
    for (int j = 1; j < r; ++j) {
      const int4 w = x[static_cast<long long>(j) * n4 + i];
      acc.x ^= w.x;
      acc.y ^= w.y;
      acc.z ^= w.z;
      acc.w ^= w.w;
    }
    out[i] = acc;
  }
}

}  // namespace

// x: (R, M, 128) int32, 16-byte aligned; out: (M, 128) int32.
extern "C" int repro_xor_reduce(const void* x, void* out, int r, long long m,
                                int sm_count, void* stream) {
  if (r < 1 || m < 0 || sm_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const long long n4 = m * 128 / 4;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count) * 8;   // 8 blocks per SM
  if (blocks > cap) blocks = cap;
  xor_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), r, n4);
  return static_cast<int>(cudaGetLastError());
}
