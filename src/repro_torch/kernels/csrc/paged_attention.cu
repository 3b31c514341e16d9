// Paged decode attention for Hopper (sm_90a): one query row per (row, head)
// over that row's pages of a shared physical KV pool, split along the
// sequence.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attention_pallas       (_pa_kernel, pl.pallas_call at :130)
//   paged_attention_pallas_quant (_pa_quant_kernel, pl.pallas_call at :341)
// and computes what their bodies compute: scores q.k * scale in f32, a
// softmax whose max, sum and accumulator stay in f32, positions at or past
// min(lengths[b], nP*page) masked out (their V rows never reach the sum),
// table entries clamped to [0, N-1] as each is read, GQA reading kv head h
// for query heads h*g .. h*g+g-1, p rounded to the pool's dtype before p.V
// (bf16 pools round it; f32 and dequantized int8 pools do not) while the
// sum l takes the unrounded e, and acc / max(l, 1e-30) written in q's dtype
// (so lengths[b] <= 0 gives zeros, as _pa_kernel's _fin does).  int8 rows
// are dequantized by their f32 scales: the key's scale multiplies the dot
// product q.k, the value's scale multiplies p (both in f32).
//
// Bound: bytes.  A call reads each valid K/V row of its rows once (plus the
// int8 rows' scales) and does 4 flops per (query head, position, dim): per
// kv head and position 4*g*D flops over 2*D*sizeof(pool) bytes, which is g
// flops per byte for bf16 and 2g for int8: 1 and 2 for phi3 (g = 1), 9 and
// 18 for starcoder2-7b (g = 9).  The ridge of the f32 CUDA cores is 67
// TFLOP/s over 3.35 TB/s = 20 flops per byte, so even g = 9 sits below it;
// the tensor cores below serve to shorten each block's arithmetic, which
// at one wave of blocks is time on the critical path, not throughput.
//
// Design.
// - Split: each row is cut into spans of kSplit positions and one block of
//   kThreads threads takes one (row b, kv head h, span s).  kSplit is a
//   constant of this source: a row of length L always has max(1, ceil(L /
//   kSplit)) spans, whatever B, nP or the card; blocks past a row's last
//   span exit at once.
// - Loads: each position's pool row is looked up once (beside the row's
//   length), then every copy of the span is issued at once with cp.async,
//   keys (with both int8 scales) and values as two groups, 16 bytes each
//   (8 for int8 rows of D % 16 != 0), into shared memory in the pool's own
//   dtype; rows are padded to an odd number of 16-byte units so that reads
//   at one column fall in distinct banks.  The group's query rows load
//   while the copies fly.
// - Arithmetic, CUDA cores (f32 q, g <= 4 or D % 16 != 0): thread
//   (position, half of D) dots its key with each query head; one warp per
//   head takes the span's max, e = exp(s - m), l and p; thread (column
//   pair, half of the rows) sums p V, the halves added by a shuffle.
// - Arithmetic, tensor cores (bf16 q, g > 4, D % 16 == 0): the group's up
//   to 16 query rows are the M = 16 rows of mma.sync m16n8k16 (bf16 in,
//   f32 accumulate); int8 keys are copied to bf16 exactly (|k| <= 128);
//   bf16 pages run p V there too (p is rounded to bf16, as the reference
//   rounds it), int8 pages keep p in f32 and p V on the CUDA cores.
// - g query heads go in passes of up to kMaxGroup over the same staged
//   rows; loops over heads stop at g, so no work goes to padding.
// - Heads wider than 256 columns keep the spans and the combine
//   (paged_wide_kernel, below): whole rows staged by bulk copies, scores
//   of bf16 queries on the tensor cores whatever g; the wrapper pads a
//   width to a multiple of 8.
//
// Combine: two CUDA launches per call (one when no row can have two
// spans).  Each span writes (m_s, l_s, acc_s) in f32 to a workspace (B,
// Hq, max_splits, D + 2) that the wrapper allocates; a row of one span
// writes its output directly (the same numbers: e^0 = 1).  A second
// kernel, one block per (row, query head), reads a row's spans in the
// order 0, 1, ...: m = max m_s, l = sum l_s e^(m_s - m), acc = sum acc_s
// e^(m_s - m), and writes acc / max(l, 1e-30).  The one-launch route, in
// which the block that arrives last at its (row, kv head) combines (an
// int32 arrival counter per (row, kv head)), leaves one block to walk all
// g heads; tools/paged_variants.py carries it as a text variant and
// measures it slower.
//
// Determinism.  Every sum runs in one thread, one warp, one shuffle pair
// or one mma in an order fixed by the source, and the combine's order is
// the span order; no atomic adds a value.  What a row computes depends on
// its q, its table row and its length alone, never on B, on nP or on the
// other rows: two launches are bit-identical, a row alone equals the same
// row in a batch, and a speculative batch of T rows gives what T
// single-row calls give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;                   // positions per block (span)
constexpr int kParts = kThreads / kSplit;    // threads per position, scores
constexpr int kMaxGroup = 16;                // query heads per pass at most
constexpr int kP16Stride = kSplit + 8;       // bf16 elements per p16 row
constexpr float kNegInf = -0.7f * 3.40282347e38f;   // NEG_INF of the reference
static_assert(kThreads % kSplit == 0 && kSplit % 32 == 0,
              "a warp covers 32 positions of one part");
constexpr int kChunk = 64;                   // spans per step of the combine
constexpr int kCombineThreads = 256;         // the combine kernel's block
static_assert(kChunk <= kCombineThreads && kChunk % 32 == 0,
              "a thread per span of a step; whole warps");

struct Args {
  const void* q;         // (B, Hq, D) in TQ
  const void* k;         // (N, page, Hkv, D) in TKV
  const float* ks;       // (N, page, Hkv), quant only
  const void* v;         // (N, page, Hkv, D) in TKV
  const float* vs;       // (N, page, Hkv), quant only
  const int* table;      // (B, nP)
  const int* lengths;    // (B,)
  void* out;             // (B, Hq, D) in TQ
  float* part;           // (B, Hq, max_splits, D) spans' numerators
  float* stats;          // (B, Hq, max_splits, 2) spans' max and sum
  int batch, hq, hkv, d, n, page, np, max_splits;
  float scale;
};

// The tensor-core route: bf16 q over bf16 or int8 pages, groups of more
// than 4 query heads, a warp per 16 positions; taken where D % 16 == 0.
template <typename TQ, typename TKV, int kMaxG>
__host__ __device__ constexpr bool mma_route() {
  return std::is_same<TQ, __nv_bfloat16>::value &&
         !std::is_same<TKV, float>::value && kMaxG == kMaxGroup &&
         kSplit == 16 * kWarps;
}

// bytes between staged rows: 16-byte aligned, an odd number of 16-byte
// units, so 8 rows read at one column land in 8 distinct bank groups
template <typename T>
__host__ __device__ constexpr int smem_stride(int d) {
  const int bytes = (d * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  return (bytes / 16) % 2 ? bytes : bytes + 16;
}

// A span block's shared memory, in bytes from its start: the staged key
// and value rows, their scales and the pool rows (up to `q`), then the f32
// query rows (CUDA-core route only), the scores (one part on the tensor
// cores, kParts on the CUDA cores), the statistics, and on the
// tensor-core route q16, p16 and, for int8 pages, k16.  Host and device
// both lay it out from here.
struct Layout {
  int q, sc, ml, q16, p16, k16, bytes;
};

template <typename TKV, bool kQuant, int kMaxG>
__host__ __device__ inline Layout layout(int d, bool tc) {
  Layout l;
  int at = 2 * kSplit * smem_stride<TKV>(d) + kSplit * (2 * 4 + 8);
  l.q = at;
  at += tc ? 0 : 4 * kMaxG * d;
  l.sc = at;
  at += 4 * (tc ? 1 : kParts) * kMaxG * kSplit;
  l.ml = at;
  at += (8 * kMaxG + 15) / 16 * 16;
  l.q16 = at;
  at += tc ? 16 * smem_stride<__nv_bfloat16>(d) : 0;
  l.p16 = at;
  at += tc ? 16 * kP16Stride * 2 : 0;
  l.k16 = at;
  at += tc && kQuant ? kSplit * smem_stride<__nv_bfloat16>(d) : 0;
  l.bytes = at;
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// 8 consecutive staged elements as f32
__device__ __forceinline__ void smem8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void smem8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void smem8(const int8_t* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

// 2 consecutive staged elements as f32
__device__ __forceinline__ void smem2(const float* p, float* o) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  o[0] = a.x;
  o[1] = a.y;
}

__device__ __forceinline__ void smem2(const __nv_bfloat16* p, float* o) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = f.x;
  o[1] = f.y;
}

__device__ __forceinline__ void smem2(const int8_t* p, float* o) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  o[0] = static_cast<float>(c.x);
  o[1] = static_cast<float>(c.y);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The reference multiplies p by V in V's dtype (p.astype(v.dtype)):
// bf16 pages round p to bf16 first; f32 and dequantized pages keep it.
__device__ __forceinline__ float in_kv_dtype(float x, const float*) { return x; }
__device__ __forceinline__ float in_kv_dtype(float x, const int8_t*) { return x; }
__device__ __forceinline__ float in_kv_dtype(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the pool row of position pos of kv head h, its table entry clamped
__device__ __forceinline__ size_t pool_row(const int* tb, int pos, int h,
                                           const Args& a) {
  const int phys = min(max(tb[pos / a.page], 0), a.n - 1);
  return (static_cast<size_t>(phys) * a.page + pos % a.page) * a.hkv + h;
}

// copies of the span's rows of one pool, each row's pool index taken from
// pool_rows; thread t copies the chunks t, t + kThreads, ... of the (rows,
// per_row) chunks, stepping (row, chunk) without a division
template <typename TKV>
__device__ __forceinline__ void stage_rows(const TKV* pool, char* dst,
                                           const long long* pool_rows, int rows,
                                           const Args& a) {
  const int row_bytes = a.d * static_cast<int>(sizeof(TKV));
  const int stride = smem_stride<TKV>(a.d);
  const int chunk = row_bytes % 16 == 0 ? 16 : 8;
  const int per_row = row_bytes / chunk;
  const int dr = kThreads / per_row;
  const int dc = kThreads - dr * per_row;
  const char* base = reinterpret_cast<const char*>(pool);
  int r = threadIdx.x / per_row;
  int c = threadIdx.x - r * per_row;
  while (r < rows) {
    const char* src = base + pool_rows[r] * row_bytes + c * chunk;
    if (chunk == 16) {
      cp_async16(dst + r * stride + c * chunk, src);
    } else {
      cp_async8(dst + r * stride + c * chunk, src);
    }
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// copies of the span's rows' scales (int8 pages)
__device__ __forceinline__ void stage_scales(const float* scales, float* dst,
                                             const long long* pool_rows, int rows) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    cp_async4(dst + i, scales + pool_rows[i]);
  }
}

__device__ __forceinline__ int spans_of(const Args& a, int b) {
  const int len = max(0, min(a.lengths[b], a.np * a.page));
  return max(1, (len + kSplit - 1) / kSplit);
}

// The output of query head `head` (flat index b*Hq + head) of row b from
// its spans, by the whole block, kChunk spans at a time.  Each thread
// first issues the loads of its columns' partial values, of the spans'
// max (every warp finds the head's max; a max is exact in any order) and
// of its own span's statistics, for as many spans as the workspace holds,
// beside the load of the row's length: they fly together, and what lies
// past the row's last span is masked once the length is in.  Thread s
// then puts the weight e^(m_s - m) and l_s e^(m_s - m) of span s in shared
// memory, and every thread sums l and its columns' acc in the span order
// 0, 1, ...  The block has kBlock threads, kCols columns each in a
// pass, over the head's columns c_lo .. c_hi-1; more columns than a pass
// take more, each over all its spans again.  ws holds 2 * kChunk floats.
template <typename TQ, int kBlock = kCombineThreads>
__device__ __forceinline__ void combine_head(const Args& a, size_t head, int b,
                                             float* ws, int c_lo, int c_hi) {
  static_assert(kChunk <= kBlock, "a thread per span of a step");
  constexpr int kCols = (256 + kCombineThreads - 1) / kCombineThreads;   // columns per thread
  const int tid = threadIdx.x;
  const int d = a.d;
  const float* st = a.stats + head * a.max_splits * 2;
  const float* pt = a.part + head * a.max_splits * d;
  float* w_s = ws;
  float* lw_s = ws + kChunk;
  for (int c_base = c_lo; c_base < c_hi; c_base += kCols * kBlock) {
    float m = kNegInf, l = 0.f, acc[kCols] = {};
    int n = a.max_splits;   // the spans the workspace holds, until the length is in
    for (int s0 = 0; s0 < n; s0 += kChunk) {
      const int cap = min(kChunk, a.max_splits - s0);
      float x[kCols][kChunk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = c_base + tid + c * kBlock;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          x[c][i] = i < cap && col < c_hi
              ? __ldcg(pt + static_cast<size_t>(s0 + i) * d + col) : 0.f;
        }
      }
      float mine_m = kNegInf, mine_l = 0.f;
      if (tid < cap) {
        mine_m = __ldcg(st + 2 * (s0 + tid));
        mine_l = __ldcg(st + 2 * (s0 + tid) + 1);
      }
      if (s0 == 0) {
        float ms[kChunk / 32];
#pragma unroll
        for (int i = 0; i < kChunk / 32; ++i) {
          const int s = tid % 32 + 32 * i;
          ms[i] = s < a.max_splits ? __ldcg(st + 2 * s) : kNegInf;
        }
        n = spans_of(a, b);
        if (n == 1) return;   // the span kernel wrote this row's output
#pragma unroll
        for (int i = 0; i < kChunk / 32; ++i) {
          if (tid % 32 + 32 * i < n) m = fmaxf(m, ms[i]);
        }
        for (int s = tid % 32 + kChunk; s < n; s += 32) m = fmaxf(m, __ldcg(st + 2 * s));
        m = warp_max(m);
      }
      const int ns = min(kChunk, n - s0);
      __syncthreads();   // the last chunk's readers of ws are done
      if (tid < ns) {
        const float w = expf(mine_m - m);
        w_s[tid] = w;
        lw_s[tid] = mine_l * w;
      }
      __syncthreads();
      for (int i = 0; i < ns; ++i) l += lw_s[i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (i < ns) acc[c] += x[c][i] * w_s[i];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c_base + tid + c * kBlock;
      if (col < c_hi) {
        store(static_cast<TQ*>(a.out) + head * d + col, acc[c] / fmaxf(l, 1e-30f));
      }
    }
  }
}

// One block's span, staged in shared memory, and where its passes write.
struct Span {
  const char* k;       // (kSplit, stride) key rows in the pool's dtype
  const char* v;       // (kSplit, stride) value rows
  const float* ksc;    // (kSplit) key scales, quant only
  const float* vsc;    // (kSplit) value scales
  float* q;            // (kG, D) the pass's query rows, f32
  float* sc;           // (kParts, kG, kSplit) partial scores, then p
  float* ml;           // (2, kG) the span's max and sum per head
  __nv_bfloat16* q16;  // (16, D) query rows,
  __nv_bfloat16* p16;  // (16, kP16Stride) p and
  __nv_bfloat16* k16;  // (kSplit, D) int8 keys, bf16, on the tensor-core route
  size_t head0;        // b*Hq + h*g: the group's first query head
  int stride, rows, s, n_spans;
};

// query rows c0 .. c0+gc-1 as they are (bf16) into q16, 16 bytes a copy
template <typename TQ>
__device__ __forceinline__ void load_q16(const Args& a, const Span& sp,
                                         const TQ* q0, int gc) {
  const int d = a.d;
  const int qs = smem_stride<__nv_bfloat16>(d);
  for (int i = threadIdx.x; i < gc * d / 8; i += kThreads) {
    const int row = i / (d / 8);
    const int c = i - row * (d / 8);
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(sp.q16) + row * qs + c * 16) =
        *reinterpret_cast<const uint4*>(q0 + static_cast<size_t>(row) * d + c * 8);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// c += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Scores on the CUDA cores: thread (position r, part) dots its key row with
// each query head j < gc over the 8-wide chunks part, part + kParts, ...
// of D, into sp.sc part `part`.  int8 keys stay unscaled here (the softmax
// applies their scale).
template <typename TKV, int kG>
__device__ __forceinline__ void scores_cuda(const Args& a, const Span& sp,
                                            const float* qf, int gc) {
  const int d = a.d;
  const int r = threadIdx.x % kSplit;
  const int part = threadIdx.x / kSplit;
  if (r >= sp.rows) return;
  float dot[kG];
#pragma unroll
  for (int j = 0; j < kG; ++j) dot[j] = 0.f;
  const TKV* kr = reinterpret_cast<const TKV*>(sp.k + r * sp.stride);
  for (int c = part * 8; c < d; c += kParts * 8) {
    float x[8];
    smem8(kr + c, x);
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j == gc) break;
      const float4 qa = *reinterpret_cast<const float4*>(qf + j * d + c);
      const float4 qc = *reinterpret_cast<const float4*>(qf + j * d + c + 4);
      float t = dot[j];
      t += qa.x * x[0]; t += qa.y * x[1]; t += qa.z * x[2]; t += qa.w * x[3];
      t += qc.x * x[4]; t += qc.y * x[5]; t += qc.z * x[6]; t += qc.w * x[7];
      dot[j] = t;
    }
  }
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    if (j == gc) break;
    sp.sc[(part * kG + j) * kSplit + r] = dot[j];
  }
}

// Scores on the tensor cores: the up to 16 query rows in q16 are the M =
// 16 rows of mma.sync m16n8k16; warp w takes positions 16w .. 16w+15 as
// two n-tiles of 8, the bf16 key rows k16 (ks bytes apart) being the B
// operand as they lie.  Rows of q16 past gc are never read back.
template <int kG>
__device__ __forceinline__ void scores_mma(const Args& a, const Span& sp,
                                           const char* k16, int ks, int gc) {
  const int lane = threadIdx.x % 32;
  const int p0 = 16 * (threadIdx.x / 32);
  const int qs = smem_stride<__nv_bfloat16>(a.d);
  const char* qa = reinterpret_cast<const char*>(sp.q16) +
                   ((lane % 8) + 8 * ((lane / 8) % 2)) * qs + 16 * (lane / 16);
  const char* kb = k16 + (p0 + (lane % 8) + 8 * (lane / 16)) * ks + 16 * ((lane / 8) % 2);
  float c[2][4] = {};
  for (int kk = 0; kk < a.d; kk += 16) {
    unsigned fa[4], fb[4];
    ldsm_x4(fa, qa + 2 * kk);
    ldsm_x4(fb, kb + 2 * kk);
    mma_bf16(c[0], fa, fb[0], fb[1]);
    mma_bf16(c[1], fa, fb[2], fb[3]);
  }
  // c[n]: heads lane/4 and lane/4 + 8 at positions p0 + 8n + 2(lane%4), +1
  const int gr = lane / 4;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int pos = p0 + 8 * n + 2 * (lane % 4);
    if (gr < gc) {
      sp.sc[gr * kSplit + pos] = c[n][0];
      sp.sc[gr * kSplit + pos + 1] = c[n][1];
    }
    if (gr + 8 < gc) {
      sp.sc[(gr + 8) * kSplit + pos] = c[n][2];
      sp.sc[(gr + 8) * kSplit + pos + 1] = c[n][3];
    }
  }
}

// The span's softmax statistics, one warp per query head j < gc: the
// score is the sum of kScoreParts partial dot products in sp.sc, times the
// key's scale (int8 pages) and the scale; m is their max, e = exp(s - m),
// l = sum e; p = e rounded to the pool's dtype replaces the scores in
// sp.sc, times the value's scale for int8 pages (so p V needs no other
// multiply), and goes to p16 as bf16 where given.  Positions past the
// span's end get p = 0.
template <typename TKV, bool kQuant, int kG, int kScoreParts>
__device__ __forceinline__ void span_softmax(const Args& a, const Span& sp,
                                             int gc, __nv_bfloat16* p16) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = warp; j < gc; j += kWarps) {
    float x[kSplit / 32];
    float m = kNegInf;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      const int rr = lane + 32 * i;
      float sv = kNegInf;
      if (rr < sp.rows) {
        sv = 0.f;
#pragma unroll
        for (int q = 0; q < kScoreParts; ++q) sv += sp.sc[(q * kG + j) * kSplit + rr];
        if (kQuant) sv *= sp.ksc[rr];
        sv *= a.scale;
      }
      x[i] = sv;
      m = fmaxf(m, sv);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      const int rr = lane + 32 * i;
      const float e = rr < sp.rows ? expf(x[i] - m) : 0.f;
      l += e;
      float pv = in_kv_dtype(e, static_cast<const TKV*>(nullptr));
      if (kQuant && rr < sp.rows) pv *= sp.vsc[rr];
      sp.sc[j * kSplit + rr] = pv;
      if (p16 != nullptr) p16[j * kP16Stride + rr] = __float2bfloat16(pv);
    }
    l = warp_sum(l);
    if (lane == 0) {
      sp.ml[j] = m;
      sp.ml[kG + j] = l;
    }
  }
}

// head j's value at column col: the output itself when the row has one
// span, else the span's partial numerator
template <typename TQ, int kG>
__device__ __forceinline__ void put(const Args& a, const Span& sp, int c0,
                                    int j, int col, float acc) {
  const size_t head = sp.head0 + c0 + j;
  if (sp.n_spans == 1) {
    store(static_cast<TQ*>(a.out) + head * a.d + col,
          acc / fmaxf(sp.ml[kG + j], 1e-30f));
  } else {
    a.part[(head * a.max_splits + sp.s) * a.d + col] = acc;
  }
}

// p V on the CUDA cores: thread (pair, half) sums columns 2 pair, 2 pair
// + 1 of every head over its half of the rows (4 at a time); the halves,
// adjacent lanes, add by a shuffle.  Every thread runs the loop, for the
// shuffle.
template <typename TQ, typename TKV, int kG>
__device__ __forceinline__ void pv_cuda(const Args& a, const Span& sp, int c0,
                                        int gc) {
  const int tid = threadIdx.x;
  const int rows = sp.rows;
  const int pairs = a.d / 2;
  const int halves = 2 * pairs <= kThreads ? 2 : 1;
  const int pair = tid / halves;
  const int half = tid % halves;
  const int split = halves == 2 ? min(rows, (rows + 7) / 8 * 4) : rows;
  const int lo = half == 0 ? 0 : split;
  const int hi = half == 0 ? split : rows;
  const int col = 2 * min(pair, pairs - 1);
  float acc[kG][2];
#pragma unroll
  for (int j = 0; j < kG; ++j) acc[j][0] = acc[j][1] = 0.f;
  for (int r4 = lo; r4 < hi; r4 += 4) {
    float vv[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // rows past the half's end hold another half's or stale bytes: p
      // is 0 past the span, but 0 * garbage need not be 0
      const int rr = r4 + i;
      smem2(reinterpret_cast<const TKV*>(sp.v + rr * sp.stride) + col, vv[i]);
      vv[i][0] = rr >= hi ? 0.f : vv[i][0];
      vv[i][1] = rr >= hi ? 0.f : vv[i][1];
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j == gc) break;
      const float4 p = *reinterpret_cast<const float4*>(sp.sc + j * kSplit + r4);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float t = acc[j][c];
        t += p.x * vv[0][c];
        t += p.y * vv[1][c];
        t += p.z * vv[2][c];
        t += p.w * vv[3][c];
        acc[j][c] = t;
      }
    }
  }
  if (halves == 2) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j == gc) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], 1);
    }
  }
  if (half == 0 && pair < pairs) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j == gc) break;
      put<TQ, kG>(a, sp, c0, j, col, acc[j][0]);
      put<TQ, kG>(a, sp, c0, j, col + 1, acc[j][1]);
    }
  }
}

// p V on the tensor cores (bf16 pages): p16 (rows = heads) is the A
// operand; warp w takes the 8-column n-tiles w, w + 4, ..., the value rows
// read by ldmatrix.trans as B, over positions up to kend (a multiple of 16
// whose rows past the span's end are zero).
template <typename TQ, int kG>
__device__ __forceinline__ void pv_mma(const Args& a, const Span& sp, int c0,
                                       int gc, int kend) {
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const char* pa = reinterpret_cast<const char*>(sp.p16) +
                   ((lane % 8) + 8 * ((lane / 8) % 2)) * kP16Stride * 2 + 16 * (lane / 16);
  const char* vb = sp.v + ((lane % 8) + 8 * ((lane / 8) % 2)) * sp.stride;
  for (int nt = threadIdx.x / 32; nt < a.d / 8; nt += kWarps) {
    float c[4] = {};
    for (int kk = 0; kk < kend; kk += 16) {
      unsigned fa[4], fb[2];
      ldsm_x4(fa, pa + 2 * kk);
      ldsm_x2_trans(fb, vb + kk * sp.stride + 16 * nt);
      mma_bf16(c, fa, fb[0], fb[1]);
    }
    // c: heads gr and gr + 8 at columns 8 nt + 2(lane%4), +1
    const int col = 8 * nt + 2 * (lane % 4);
    if (gr < gc) {
      put<TQ, kG>(a, sp, c0, gr, col, c[0]);
      put<TQ, kG>(a, sp, c0, gr, col + 1, c[1]);
    }
    if (gr + 8 < gc) {
      put<TQ, kG>(a, sp, c0, gr + 8, col, c[2]);
      put<TQ, kG>(a, sp, c0, gr + 8, col + 1, c[3]);
    }
  }
}

// One pass over query heads c0 .. c0+gc-1 (gc <= kG) of the group against
// the staged span: scores, the span's softmax statistics, p V, and the
// span's results.  Loops over heads stop at gc, so no work goes to heads
// the group does not have.  kTC: the tensor-core route (bf16 q; g > 4;
// D % 16 == 0): scores on mma.sync, against exact bf16 copies of int8 keys
// (|k| <= 128), and p V on mma.sync for bf16 pages (the reference rounds p
// to bf16 there too); int8 pages keep p in f32 and p V on the CUDA cores.
template <typename TQ, typename TKV, bool kQuant, int kG, bool kTC>
__device__ __forceinline__ void heads_pass(const Args& a, const Span& sp,
                                           const TQ* qb, int c0, int gc,
                                           bool first) {
  const int tid = threadIdx.x;
  const int d = a.d;
  const int kend = (sp.rows + 15) / 16 * 16;
  if (!first) __syncthreads();   // the last pass's readers are done
  // this pass's query rows, while the first pass's copies fly
  if constexpr (kTC) {
    load_q16(a, sp, qb + static_cast<size_t>(c0) * d, gc);
  } else {
    for (int i = tid; i < gc * d; i += kThreads) sp.q[i] = to_float(qb[c0 * d + i]);
  }
  if (first) cp_async_wait<1>();   // this thread's key and scale copies landed
  __syncthreads();

  if constexpr (kTC) {
    const char* k16 = sp.k;
    int ks = sp.stride;
    if constexpr (kQuant) {
      // bf16 copies of the int8 keys, exact, once per block (stale rows
      // past the span's end convert to finite values nobody reads)
      ks = smem_stride<__nv_bfloat16>(d);
      if (first) {
        for (int i = tid; i < kend * (d / 8); i += kThreads) {
          const int rr = i / (d / 8);
          const int c = i - rr * (d / 8);
          float x[8];
          smem8(reinterpret_cast<const int8_t*>(sp.k + rr * sp.stride) + 8 * c, x);
          __nv_bfloat162 h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
          *reinterpret_cast<uint4*>(reinterpret_cast<char*>(sp.k16) + rr * ks + 16 * c) =
              *reinterpret_cast<const uint4*>(h);
        }
        __syncthreads();
      }
      k16 = reinterpret_cast<const char*>(sp.k16);
    }
    scores_mma<kG>(a, sp, k16, ks, gc);
  } else {
    scores_cuda<TKV, kG>(a, sp, sp.q, gc);
  }
  __syncthreads();

  constexpr bool kPvMma = kTC && !kQuant;
  span_softmax<TKV, kQuant, kG, kTC ? 1 : kParts>(a, sp, gc, kPvMma ? sp.p16 : nullptr);
  if (first) cp_async_wait<0>();   // this thread's value copies landed
  if constexpr (kPvMma) {
    // value rows past the span's end, to a multiple of 16: p is 0 there,
    // but 0 * stale bytes need not be 0
    for (int i = tid; i < (kend - sp.rows) * (sp.stride / 16); i += kThreads) {
      const int rr = sp.rows + i / (sp.stride / 16);
      *reinterpret_cast<uint4*>(const_cast<char*>(sp.v) + rr * sp.stride +
                                16 * (i % (sp.stride / 16))) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  if constexpr (kPvMma) {
    pv_mma<TQ, kG>(a, sp, c0, gc, kend);
  } else {
    pv_cuda<TQ, TKV, kG>(a, sp, c0, gc);
  }
  if (sp.n_spans > 1 && tid < gc) {
    float* st = a.stats + ((sp.head0 + c0 + tid) * a.max_splits + sp.s) * 2;
    st[0] = sp.ml[tid];
    st[1] = sp.ml[kG + tid];
  }
}

// One block per (row b, kv head h, span s), numbered (b * Hkv + h) *
// max_splits + s; a block past its row's last span exits at once.  The g
// query heads go in passes of kMaxG over the same staged rows (1 for g =
// 1, 4 for g <= 4, kMaxGroup beyond).
template <typename TQ, typename TKV, bool kQuant, int kMaxG>
__global__ void __launch_bounds__(kThreads, kMaxG == 1 ? 8 : 2)
paged_split_kernel(const Args a) {
  const int s = blockIdx.x % a.max_splits;
  const int bh = blockIdx.x / a.max_splits;
  const int h = bh % a.hkv;
  const int b = bh / a.hkv;
  const int d = a.d;
  const int g = a.hq / a.hkv;
  // thread r's position's pool row, loaded beside the row's length
  const int r0 = s * kSplit;
  const int* tb = a.table + static_cast<size_t>(b) * a.np;
  long long prow = 0;
  if (threadIdx.x < kSplit && r0 + threadIdx.x < a.np * a.page) {
    prow = static_cast<long long>(pool_row(tb, r0 + threadIdx.x, h, a));
  }
  const int n_spans = spans_of(a, b);
  if (s >= n_spans) return;
  const int len = max(0, min(a.lengths[b], a.np * a.page));

  extern __shared__ __align__(16) unsigned char smem[];
  Span sp;
  sp.stride = smem_stride<TKV>(d);
  char* k_s = reinterpret_cast<char*>(smem);
  char* v_s = k_s + kSplit * sp.stride;
  float* ksc_s = reinterpret_cast<float*>(v_s + kSplit * sp.stride);
  float* vsc_s = ksc_s + kSplit;
  long long* rows_s = reinterpret_cast<long long*>(vsc_s + kSplit);   // (kSplit)
  sp.k = k_s;
  sp.v = v_s;
  sp.ksc = ksc_s;
  sp.vsc = vsc_s;
  const bool tensor_cores = mma_route<TQ, TKV, kMaxG>() && d % 16 == 0;
  const Layout lay = layout<TKV, kQuant, kMaxG>(d, tensor_cores);
  sp.q = reinterpret_cast<float*>(smem + lay.q);
  sp.sc = reinterpret_cast<float*>(smem + lay.sc);
  sp.ml = reinterpret_cast<float*>(smem + lay.ml);
  sp.q16 = reinterpret_cast<__nv_bfloat16*>(smem + lay.q16);
  sp.p16 = reinterpret_cast<__nv_bfloat16*>(smem + lay.p16);
  sp.k16 = reinterpret_cast<__nv_bfloat16*>(smem + lay.k16);
  // query heads h*g .. h*g+g-1 are contiguous in q's row
  sp.head0 = static_cast<size_t>(b) * a.hq + static_cast<size_t>(h) * g;
  sp.s = s;
  sp.n_spans = n_spans;
  sp.rows = max(0, min(kSplit, len - r0));   // 0 only when len is 0

  // the copies: keys and scales, then values
  if (threadIdx.x < sp.rows) rows_s[threadIdx.x] = prow;
  __syncthreads();
  // the first group holds the keys and both scales (the softmax folds the
  // value scales into p before the values land), the second the values
  stage_rows<TKV>(static_cast<const TKV*>(a.k), k_s, rows_s, sp.rows, a);
  if (kQuant) {
    stage_scales(a.ks, ksc_s, rows_s, sp.rows);
    stage_scales(a.vs, vsc_s, rows_s, sp.rows);
  }
  cp_async_commit();
  stage_rows<TKV>(static_cast<const TKV*>(a.v), v_s, rows_s, sp.rows, a);
  cp_async_commit();
  const TQ* qb = static_cast<const TQ*>(a.q) + sp.head0 * d;
  for (int c0 = 0; c0 < g; c0 += kMaxG) {
    const int gc = min(kMaxG, g - c0);
    if constexpr (mma_route<TQ, TKV, kMaxG>()) {
      if (tensor_cores) {
        heads_pass<TQ, TKV, kQuant, kMaxG, true>(a, sp, qb, c0, gc, c0 == 0);
        continue;
      }
    }
    heads_pass<TQ, TKV, kQuant, kMaxG, false>(a, sp, qb, c0, gc, c0 == 0);
  }
}

// Heads wider than 256 columns: the wide route.
//
// Bound: bytes.  A position of one kv head moves 2*D*sizeof(pool) bytes
// (plus two f32 scales for int8 pools) for 4*g*D flops: g flops per byte
// over bf16 pools and 2g over int8, 16 and 32 at absorbed MLA's g = 16,
// far below the tensor cores' ridge (989 TFLOP/s over 3.35 TB/s = 295).
// What a block must not do is wait: on copies issued one after another,
// or on arithmetic that runs while no copy is in flight.
//
// Design.  The spans, the workspace and the combine are the narrow
// route's; a block of kWideThreads threads takes one (row, kv head, span).
// - Staging, whole rows (bf16 and int8 pools whose K and V rows of a span
//   fit the block beside the rest: bf16 to D ~740, int8 to ~1,340, f32 to
//   ~400; and row bytes a multiple of 16): each valid row of the span is
//   one bulk copy (cp.async.bulk, the TMA engine), K rows before V rows,
//   issued by 16 lanes of every warp, completing on an mbarrier per 16
//   rows of K and of V; rows padded to an odd number of 16-byte units
//   (ldmatrix and vector reads at one column fall in distinct banks).  All
//   of a span's copies are in flight at once, and the span stays resident
//   for every pass of query heads.
// - Staging, otherwise: 16-byte cp.async (8-byte for int8 rows of D % 16
//   = 8) in boxes of kWideBox columns into a ring of box stages, an
//   mbarrier per stage (cp.async.mbarrier.arrive); the ring holds
//   kWideRing bytes, every box of a span where they fit, else a stage is
//   refilled with the box as many stages on as soon as the block is done with
//   it, and a second pass of heads streams the boxes again.
// - Scores, bf16 queries (over bf16 or int8 pools), whatever g: the pass's
//   up to 16 query rows, loaded once per pass into q16, are the A operand
//   of mma.sync m16n8k16 (bf16 in, f32 accumulate); warp w takes
//   positions 16 (w % 4) .. +15 and the first or second half of each box's
//   64 columns (w / 4), over the boxes in two register chains (even and
//   odd boxes, added at the end); the two halves are added in that order
//   by the softmax.  int8 keys are made bf16 as the B fragments are read
//   (exact: |k| <= 128).  Where D % 16 = 8 the last box's 8 tail columns
//   enter as zeros.
// - Scores, f32 queries: thread (position, head set) on the CUDA cores,
//   over each box's columns in order.
// - p V, bf16 pools: mma.sync with p16 (p rounded to bf16, as the
//   reference rounds it) as A and the V rows read by ldmatrix.trans as B,
//   warp w taking each box's 8 columns 8w .. 8w+7; value rows past the
//   span's end are zeroed first.  On whole rows the 16-position k-steps
//   run outermost, each as soon as its rows land, with an accumulator per
//   box; partial numerators go out in 8-byte (16-byte on the CUDA cores)
//   stores.  int8 and f32 pools: f32 p times the
//   value's scale, on the CUDA cores: thread (4 columns, 4 heads) of one
//   of four boxes at a time sums its 16 outputs over the span's positions
//   in order.  At g 16 that loop sets the pace of int8 pools.
// - Blocks are numbered from the last span down: spans past a row's end,
//   mostly the last ones, exit at once and free their SMs first.
// - The combine takes kWideCombineThreads-column slices of a head, a block
//   each.
// Every sum runs in one thread, or in one mma chain in a fixed order, and
// the score chains and halves add in a fixed order: the bits are fixed,
// and a row's result depends on its q, table row and length alone.
//
// Measured (tools/paged_variants.py --wide; NVIDIA H100 80GB HBM3, 700 W;
// B 4, lengths 1 / 63 / 130 / 256 and 4096 / 3001 / 1024 / 200, page 16,
// L2 cold), bf16 / int8 pool, ms: D 320 (8 over 2) 0.0132 / 0.0169, D 576
// (16 over 1) 0.0177 / 0.0237, D 320 long 0.0189 / 0.0227, D 576 long
// 0.0213 / 0.0322 (bounds 0.00632 / 0.00321 and 0.00572 / 0.00290 at the
// long shapes); the design of the first wide kernel (element
// loads, CUDA cores): 0.0834 / 0.0841, 0.1892 / 0.1937, 0.1548 / 0.1584,
// 0.3249 / 0.3277.  A block moves its span at ~12-14 GB/s whatever the
// path (bulk copies, cp.async, loads through registers; L2-warm or cold),
// so the long shapes' 131-262 blocks set the time, with ~4 us of combine
// after them.
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideBox = 64;                               // columns per box
constexpr int kWideRing = 18 * kSplit * (2 * kWideBox + 16);  // 18 bf16 boxes
constexpr int kWideSmemMax = 232448;                       // a block's most, sm_90
constexpr bool kWideBulk = true;                           // whole rows by bulk copies
constexpr int kWideBarRows = 16;                           // rows a barrier holds
constexpr int kWideBulkBoxes = 12;                         // boxes of a bf16 whole-row span, at most
constexpr int kWideRowGroups = kSplit / kWideBarRows;      // barriers for K, and for V
static_assert(kWideThreads == 4 * kSplit && kSplit == 4 * 16,
              "four head sets of the span's positions; four 16-position tiles");
static_assert(kWideThreads == 4 * 16 * 4 && kMaxGroup == 16,
              "CUDA-core p V: (4 columns, 4 heads) of one of 4 boxes at a time");

// bytes between a box's staged rows: an odd number of 16-byte units
template <typename TKV>
__host__ __device__ constexpr int box_stride() {
  return kWideBox * static_cast<int>(sizeof(TKV)) + 16;
}

// bytes between q16's rows: D rounded up to 16 columns, and 16 bytes
__host__ __device__ constexpr int wide_q_stride(int d) {
  return (d + 15) / 16 * 16 * 2 + 16;
}

// A wide block's shared memory: the span's whole K and V rows, or the
// ring of box stages; then q16 (bf16 queries), the score halves, p (p16
// for bf16 pools, else f32 by position), the statistics, the scales, the
// pool rows and the mbarriers (one per 16 rows of K and of V, or one per
// stage).
// bytes < 0: the head is too wide for a block.  Host and device both lay
// it out from here.
struct WideLayout {
  int nb, stages;   // boxes per tensor, stages of the ring
  bool resident;    // every box of the span has its own stage
  bool bulk;        // whole rows by bulk copies (stages: their barriers)
  int q16, sc, p, ml, ksc, vsc, rows, bar, bytes;
};

template <typename TQ, typename TKV>
__host__ __device__ inline WideLayout wide_layout(int d) {
  constexpr bool kTC = std::is_same<TQ, __nv_bfloat16>::value;
  constexpr bool kP16 = kTC && std::is_same<TKV, __nv_bfloat16>::value;
  constexpr int kBox = kSplit * box_stride<TKV>();
  WideLayout l;
  l.nb = (d + kWideBox - 1) / kWideBox;
  const int rest = (kTC ? kMaxGroup * wide_q_stride(d) : 0) +
                   4 * 2 * kMaxGroup * kSplit +
                   (kP16 ? 2 * kMaxGroup * kP16Stride : 4 * kSplit * kMaxGroup) +
                   4 * 2 * kMaxGroup + 4 * 2 * kSplit + 8 * kSplit;
  const int row_bytes = d * static_cast<int>(sizeof(TKV));
  const int rows_area = 2 * kSplit * smem_stride<TKV>(d);
  l.bulk = kWideBulk && row_bytes % 16 == 0 &&
           rows_area + 8 * kWideRowGroups + rest <= kWideSmemMax;
  int stages = 2 * kWideRowGroups;
  int at = rows_area;
  l.resident = true;
  if (!l.bulk) {
    const int fit = (kWideSmemMax - rest) / (kBox + 8);
    stages = kWideRing / kBox < fit ? kWideRing / kBox : fit;
    l.resident = 2 * l.nb <= stages;
    if (l.resident) stages = 2 * l.nb;
    at = stages * kBox;
  }
  l.stages = stages;
  l.q16 = at;
  at += kTC ? kMaxGroup * wide_q_stride(d) : 0;
  l.sc = at;
  at += 4 * 2 * kMaxGroup * kSplit;
  l.p = at;
  at += kP16 ? 2 * kMaxGroup * kP16Stride : 4 * kSplit * kMaxGroup;
  l.ml = at;
  at += 4 * 2 * kMaxGroup;
  l.ksc = at;
  at += 4 * kSplit;
  l.vsc = at;
  at += 4 * kSplit;
  l.rows = at;
  at += 8 * kSplit;
  l.bar = at;
  at += 8 * stages;
  l.bytes = stages < 2 ? -1 : at;
  return l;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}

// the barrier's arrival once this thread's cp.async copies so far land
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar),
               "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) by the bulk copy
// engine, completing on the barrier's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
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

// two staged int8 keys as a bf16 pair (exact), the lower column low
__device__ __forceinline__ unsigned bf16x2_of(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(c.x),
                                           static_cast<float>(c.y));
  return *reinterpret_cast<unsigned*>(&h);
}

// 4 consecutive staged elements as f32
__device__ __forceinline__ void smem4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

__device__ __forceinline__ void smem4(const int8_t* p, float* o) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = static_cast<float>(c.x); o[1] = static_cast<float>(c.y);
  o[2] = static_cast<float>(c.z); o[3] = static_cast<float>(c.w);
}

// put's values at columns col .. col+n-1 (n = 2 or 4, col a multiple of
// n): the same numbers, a partial numerator's in one n-wide store
template <typename TQ, int kG, int n>
__device__ __forceinline__ void put_n(const Args& a, const Span& sp, int c0, int j,
                                      int col, const float* x) {
  if (sp.n_spans == 1) {
#pragma unroll
    for (int e = 0; e < n; ++e) put<TQ, kG>(a, sp, c0, j, col + e, x[e]);
    return;
  }
  float* dst = a.part + ((sp.head0 + c0 + j) * a.max_splits + sp.s) * a.d + col;
  if constexpr (n == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The wide span kernel: a block per (row b, kv head h, span s), the spans
// numbered from the last (s = max_splits - 1, mostly past the rows' ends:
// such blocks exit at once, before the full ones take the SMs); g query
// heads in passes of kMaxGroup.  Sequence index i names
// the i-th box the block consumes: box i % (2 nb) of the span, K boxes
// first, in stage i % stages (the box itself where the span is resident).
template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kWideThreads, 2)
paged_wide_kernel(const Args a) {
  constexpr bool kTC = std::is_same<TQ, __nv_bfloat16>::value;
  constexpr bool kP16 = kTC && std::is_same<TKV, __nv_bfloat16>::value;
  constexpr int kG = kMaxGroup;
  constexpr int kStride = box_stride<TKV>();
  constexpr int kBox = kSplit * kStride;
  const int s = a.max_splits - 1 - static_cast<int>(blockIdx.x / (a.batch * a.hkv));
  const int bh = blockIdx.x % (a.batch * a.hkv);
  const int h = bh % a.hkv;
  const int b = bh / a.hkv;
  const int d = a.d;
  const int g = a.hq / a.hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = s * kSplit;
  const int* tb = a.table + static_cast<size_t>(b) * a.np;
  // thread r's position's pool row, loaded beside the row's length
  long long prow = 0;
  if (tid < kSplit && r0 + tid < a.np * a.page) {
    prow = static_cast<long long>(pool_row(tb, r0 + tid, h, a));
  }
  const int n_spans = spans_of(a, b);
  if (s >= n_spans) return;
  const int len = max(0, min(a.lengths[b], a.np * a.page));

  const WideLayout lay = wide_layout<TQ, TKV>(d);
  extern __shared__ __align__(16) unsigned char smem[];
  char* ring = reinterpret_cast<char*>(smem);
  __nv_bfloat16* q16 = reinterpret_cast<__nv_bfloat16*>(smem + lay.q16);
  float* pt = reinterpret_cast<float*>(smem + lay.p);   // (kSplit, kG) f32 p
  __nv_bfloat16* p16 = reinterpret_cast<__nv_bfloat16*>(smem + lay.p);
  float* ksc_s = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc_s = reinterpret_cast<float*>(smem + lay.vsc);
  long long* rows_s = reinterpret_cast<long long*>(smem + lay.rows);
  const unsigned bar0 = smem_addr(smem + lay.bar);
  Span sp{};
  sp.ksc = ksc_s;
  sp.vsc = vsc_s;
  sp.sc = reinterpret_cast<float*>(smem + lay.sc);
  sp.ml = reinterpret_cast<float*>(smem + lay.ml);
  sp.p16 = p16;
  sp.head0 = static_cast<size_t>(b) * a.hq + static_cast<size_t>(h) * g;
  sp.s = s;
  sp.n_spans = n_spans;
  sp.rows = max(0, min(kSplit, len - r0));   // 0 only when len is 0
  const int rows = sp.rows;
  const int nb = lay.nb;
  const int passes = (g + kG - 1) / kG;
  const int total = lay.resident ? 2 * nb : passes * 2 * nb;
  if (tid < rows) rows_s[tid] = prow;
  if (tid == 0) {
    for (int i = 0; i < lay.stages; ++i) {
      mbar_init(bar0 + 8 * i, lay.bulk ? 1 : kWideThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int row_bytes = d * static_cast<int>(sizeof(TKV));
  const int chunk = row_bytes % 16 == 0 ? 16 : 8;
  // bytes between staged rows, and sequence index i's box
  const int kst = lay.bulk ? smem_stride<TKV>(d) : kStride;
  auto box_at = [&](int i) -> char* {
    const int box = i % (2 * nb);
    if (lay.bulk) {
      return ring + (box >= nb ? kSplit * kst : 0) +
             (box % nb) * kWideBox * static_cast<int>(sizeof(TKV));
    }
    return ring + (lay.resident ? box : i % lay.stages) * kBox;
  };
  // whole rows: barrier g (K) and kWideRowGroups + g (V) hold rows
  // kWideBarRows g ..
  auto rows_wait = [&](int g) { mbar_wait(bar0 + 8 * g, 0u); };
  auto stage_of = [&](int i) { return lay.resident ? i % (2 * nb) : i % lay.stages; };
  auto wait = [&](int i) {
    mbar_wait(bar0 + 8 * stage_of(i), lay.resident ? 0u : (i / lay.stages) & 1u);
  };
  // this thread's copies of sequence index i's box, then its arrival
  auto issue = [&](int i) {
    const int box = i % (2 * nb);
    const bool is_v = box >= nb;
    const int cb = (is_v ? box - nb : box) * kWideBox;
    const int per_row = min(kWideBox, d - cb) * static_cast<int>(sizeof(TKV)) / chunk;
    char* dst = box_at(i);
    const char* src = static_cast<const char*>(is_v ? a.v : a.k) +
                      cb * static_cast<int>(sizeof(TKV));
    for (int c = tid; c < rows * per_row; c += kWideThreads) {
      const int r = c / per_row;
      const int k = c - r * per_row;
      const char* from = src + rows_s[r] * row_bytes + k * chunk;
      if (chunk == 16) {
        cp_async16(dst + r * kStride + k * chunk, from);
      } else {
        cp_async8(dst + r * kStride + k * chunk, from);
      }
    }
    if (kQuant && i == 0) {
      for (int r = tid; r < rows; r += kWideThreads) {
        cp_async4(ksc_s + r, a.ks + rows_s[r]);
        cp_async4(vsc_s + r, a.vs + rows_s[r]);
      }
    }
    cp_async_arrive(bar0 + 8 * stage_of(i));
  };
  // where stages recycle: the block is done with index i; its stage takes
  // index i + stages
  auto refill = [&](int i) {
    if (i + lay.stages < total) issue(i + lay.stages);
  };
  if (lay.bulk) {
    // every valid row of the span, one bulk copy each, issued by lanes
    // 0-15 of every warp: op = 16 warp + lane; the K rows (warps 0-3)
    // before the V rows, so that the keys land first and the scores run
    // while the values fly
    const int op = 16 * warp + lane;
    const int r = op % kSplit;
    const bool is_v = op >= kSplit;
    if (tid < 2 * kWideRowGroups) {
      const int n = min(kWideBarRows, max(0, rows - kWideBarRows * (tid % kWideRowGroups)));
      mbar_expect_tx(bar0 + 8 * tid, n * row_bytes);
    }
    if (!is_v && lane < 16 && r < rows) {
      bulk_copy(ring + r * kst, static_cast<const char*>(a.k) + rows_s[r] * row_bytes,
                row_bytes, bar0 + 8 * (r / kWideBarRows));
    }
    __syncthreads();
    if (is_v && lane < 16 && r < rows) {
      bulk_copy(ring + (kSplit + r) * kst, static_cast<const char*>(a.v) + rows_s[r] * row_bytes,
                row_bytes, bar0 + 8 * (kWideRowGroups + r / kWideBarRows));
    }
    if (kQuant && tid < rows) {
      ksc_s[tid] = a.ks[prow];
      vsc_s[tid] = a.vs[prow];
    }
  } else {
    for (int i = 0; i < min(total, lay.stages); ++i) issue(i);
  }

  const TQ* qb = static_cast<const TQ*>(a.q) + sp.head0 * d;
  const int qs = wide_q_stride(d);
  for (int c0 = 0; c0 < g; c0 += kG) {
    const int gc = min(kG, g - c0);
    const int base = c0 / kG * 2 * nb;   // this pass's first sequence index
    if (c0 > 0) __syncthreads();         // the last pass's readers are done
    if constexpr (kTC) {
      // this pass's query rows, while the copies fly
      for (int i = tid; i < gc * d / 8; i += kWideThreads) {
        const int row = i / (d / 8);
        const int c = i - row * (d / 8);
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(q16) + row * qs + c * 16) =
            *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(c0 + row) * d + c * 8);
      }
      __syncthreads();
      // scores: positions p0 .. p0+15, the box's column half `half`
      const int p0 = 16 * (warp % 4);
      const int half = warp / 4;
      const char* qa = reinterpret_cast<const char*>(q16) +
                       ((lane % 8) + 8 * ((lane / 8) % 2)) * qs + 16 * (lane / 16);
      // two accumulator chains, even and odd boxes, added at the end
      float c[2][4] = {}, c_odd[2][4] = {};
      auto box_scores = [&](int kb, float (&acc)[2][4]) {
        const int i = base + kb;
        const int cb = kb * kWideBox;
        const int w = min(kWideBox, d - cb);
        const int k_lo = 32 * half;
        if (k_lo < w) {
          if (!lay.bulk) wait(i);
          const char* box = box_at(i);
          const int k_hi = min(w, k_lo + 32);
          for (int kk = k_lo; kk < k_hi; kk += 16) {
            unsigned fa[4], fb[4];
            ldsm_x4(fa, qa + 2 * (cb + kk));
            if constexpr (kQuant) {
              const int8_t* kr = reinterpret_cast<const int8_t*>(
                  box + (p0 + lane / 4) * kst) + kk + 2 * (lane % 4);
              fb[0] = bf16x2_of(kr);
              fb[1] = bf16x2_of(kr + 8);
              fb[2] = bf16x2_of(kr + 8 * kst);
              fb[3] = bf16x2_of(kr + 8 * kst + 8);
            } else {
              ldsm_x4(fb, box + (p0 + (lane % 8) + 8 * (lane / 16)) * kst +
                              16 * ((lane / 8) % 2) + 2 * kk);
            }
            if (kk + 16 > w) {   // D % 16 = 8: the last 8 columns are zeros
              fa[2] = fa[3] = 0u;
              fb[1] = fb[3] = 0u;
            }
            mma_bf16(acc[0], fa, fb[0], fb[1]);
            mma_bf16(acc[1], fa, fb[2], fb[3]);
          }
        }
        if (!lay.resident) {
          __syncthreads();
          refill(i);
        }
      };
      if (lay.bulk) {
        for (int g = p0 / kWideBarRows; g <= (p0 + 15) / kWideBarRows; ++g) rows_wait(g);
      }
      for (int kb = 0; kb < nb; kb += 2) {
        box_scores(kb, c);
        if (kb + 1 < nb) box_scores(kb + 1, c_odd);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] += c_odd[n][e];
      }
      // c[n]: heads lane/4 and lane/4 + 8 at positions p0 + 8n + 2(lane%4), +1
      const int gr = lane / 4;
      float* sc = sp.sc + half * kG * kSplit;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int pos = p0 + 8 * n + 2 * (lane % 4);
        if (gr < gc) {
          sc[gr * kSplit + pos] = c[n][0];
          sc[gr * kSplit + pos + 1] = c[n][1];
        }
        if (gr + 8 < gc) {
          sc[(gr + 8) * kSplit + pos] = c[n][2];
          sc[(gr + 8) * kSplit + pos + 1] = c[n][3];
        }
      }
    } else {
      // scores on the CUDA cores: thread (position r, head set hs) takes
      // heads hs, hs + 4, ... over each box's columns in order; q from
      // device memory (every thread of a warp reads the same row)
      const int r = tid % kSplit;
      const int hs = tid / kSplit;
      float dot[kG / 4] = {};
      if (lay.bulk) rows_wait(r / kWideBarRows);
      for (int kb = 0; kb < nb; ++kb) {
        const int i = base + kb;
        const int cb = kb * kWideBox;
        const int w = min(kWideBox, d - cb);
        if (!lay.bulk) wait(i);
        if (r < rows) {
          const TKV* kr = reinterpret_cast<const TKV*>(box_at(i) + r * kst);
          for (int cc = 0; cc < w; cc += 4) {
            float x[4];
            smem4(kr + cc, x);
#pragma unroll
            for (int m = 0; m < kG / 4; ++m) {
              const int j = hs + 4 * m;
              if (j < gc) {
                const float4 qv = __ldg(reinterpret_cast<const float4*>(
                    qb + static_cast<size_t>(c0 + j) * d + cb + cc));
                float t = dot[m];
                t += qv.x * x[0]; t += qv.y * x[1]; t += qv.z * x[2]; t += qv.w * x[3];
                dot[m] = t;
              }
            }
          }
        }
        if (!lay.resident) {
          __syncthreads();
          refill(i);
        }
      }
#pragma unroll
      for (int m = 0; m < kG / 4; ++m) {
        const int j = hs + 4 * m;
        if (j < gc && r < rows) sp.sc[j * kSplit + r] = dot[m];
      }
    }
    __syncthreads();

    // the span's softmax: one warp per query head; p to p16 (bf16 pools,
    // rounded) or to pt by position (f32, times the value's scale)
    for (int j = warp; j < gc; j += kWideWarps) {
      float x[kSplit / 32];
      float m = kNegInf;
#pragma unroll
      for (int i = 0; i < kSplit / 32; ++i) {
        const int rr = lane + 32 * i;
        float sv = kNegInf;
        if (rr < rows) {
          sv = sp.sc[j * kSplit + rr];
          if (kTC) sv += sp.sc[(kG + j) * kSplit + rr];
          if (kQuant) sv *= ksc_s[rr];
          sv *= a.scale;
        }
        x[i] = sv;
        m = fmaxf(m, sv);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < kSplit / 32; ++i) {
        const int rr = lane + 32 * i;
        const float e = rr < rows ? expf(x[i] - m) : 0.f;
        l += e;
        if constexpr (kP16) {
          p16[j * kP16Stride + rr] = __float2bfloat16(e);
        } else {
          pt[rr * kG + j] = kQuant && rr < rows ? e * vsc_s[rr] : e;
        }
      }
      l = warp_sum(l);
      if (lane == 0) {
        sp.ml[j] = m;
        sp.ml[kG + j] = l;
      }
    }
    __syncthreads();

    if constexpr (kP16) {
      // p V on the tensor cores: p16 as A (loaded once per pass), warp w
      // the box's columns 8w .. 8w+7 as B, over positions up to kend
      const int kend = (rows + 15) / 16 * 16;
      unsigned fp[kSplit / 16][4];
      const char* pa = reinterpret_cast<const char*>(p16) +
                       ((lane % 8) + 8 * ((lane / 8) % 2)) * kP16Stride * 2 + 16 * (lane / 16);
#pragma unroll
      for (int ks = 0; ks < kSplit / 16; ++ks) {
        if (16 * ks < kend) ldsm_x4(fp[ks], pa + 32 * ks);
      }
      if (lay.bulk && nb <= kWideBulkBoxes) {
        // whole rows: k-step (16 positions, one barrier's rows) outer, so
        // that each group of value rows is used as it lands; an
        // accumulator per box, the boxes' sums each in k-step order
        float acc[kWideBulkBoxes][4] = {};
        const char* vb = ring + kSplit * kst +
                         ((lane % 8) + 8 * ((lane / 8) % 2)) * kst + 16 * warp;
#pragma unroll
        for (int ks = 0; ks < kSplit / 16; ++ks) {
          if (16 * ks < kend) {
            rows_wait(kWideRowGroups + ks * 16 / kWideBarRows);
            if (16 * ks + 16 > rows) {
              // this warp's 16 bytes of every box's value rows past the
              // span's end, to kend: p is 0 there, but 0 * stale bytes
              // need not be 0
              for (int v = 0; v < nb; ++v) {
                if (lane < kend - rows && 8 * warp < d - v * kWideBox) {
                  *reinterpret_cast<uint4*>(ring + (kSplit + rows + lane) * kst +
                                            2 * v * kWideBox + 16 * warp) =
                      make_uint4(0, 0, 0, 0);
                }
              }
              __syncwarp();
            }
#pragma unroll
            for (int v = 0; v < kWideBulkBoxes; ++v) {
              if (v < nb && 8 * warp < d - v * kWideBox) {
                unsigned fb[2];
                ldsm_x2_trans(fb, vb + 16 * ks * kst + 2 * v * kWideBox);
                mma_bf16(acc[v], fp[ks], fb[0], fb[1]);
              }
            }
          }
        }
        const int gr = lane / 4;
#pragma unroll
        for (int v = 0; v < kWideBulkBoxes; ++v) {
          const int col = v * kWideBox + 8 * warp + 2 * (lane % 4);
          if (v < nb && 8 * warp < d - v * kWideBox) {
            if (gr < gc) put_n<TQ, kG, 2>(a, sp, c0, gr, col, acc[v]);
            if (gr + 8 < gc) put_n<TQ, kG, 2>(a, sp, c0, gr + 8, col, acc[v] + 2);
          }
        }
      } else {
        if (lay.bulk) {
          for (int g = 0; g < kWideRowGroups; ++g) rows_wait(kWideRowGroups + g);
        }
        for (int v = 0; v < nb; ++v) {
          const int i = base + nb + v;
          const int cb = v * kWideBox;
          if (8 * warp < d - cb) {
            if (!lay.bulk) wait(i);
            char* box = box_at(i);
            // this warp's 16 bytes of the value rows past the span's end, to
            // kend: p is 0 there, but 0 * stale bytes need not be 0
            if (lane < kend - rows) {
              *reinterpret_cast<uint4*>(box + (rows + lane) * kst + 16 * warp) =
                  make_uint4(0, 0, 0, 0);
            }
            __syncwarp();
            const char* vb = box + ((lane % 8) + 8 * ((lane / 8) % 2)) * kst + 16 * warp;
            float acc[4] = {};
#pragma unroll
            for (int ks = 0; ks < kSplit / 16; ++ks) {
              if (16 * ks < kend) {
                unsigned fb[2];
                ldsm_x2_trans(fb, vb + 16 * ks * kst);
                mma_bf16(acc, fp[ks], fb[0], fb[1]);
              }
            }
            // acc: heads lane/4 and lane/4 + 8 at columns col, col + 1
            const int gr = lane / 4;
            const int col = cb + 8 * warp + 2 * (lane % 4);
            if (gr < gc) put_n<TQ, kG, 2>(a, sp, c0, gr, col, acc);
            if (gr + 8 < gc) put_n<TQ, kG, 2>(a, sp, c0, gr + 8, col, acc + 2);
          }
          if (!lay.resident) {
            __syncthreads();
            refill(i);
          }
        }
      }
    } else {
      // p V on the CUDA cores, 4 boxes at a time: thread (4 columns cq, 4
      // heads hq) of box v0 + grp sums over the positions in order
      const int cq = tid % 16;
      const int hq = (tid / 16) % 4;
      const int grp = tid / 64;
      if (lay.bulk) {
        for (int g = 0; g < kWideRowGroups; ++g) rows_wait(kWideRowGroups + g);
      }
      for (int v0 = 0; v0 < nb; v0 += 4) {
        const int v = v0 + grp;
        const int cb = v * kWideBox;
        if (v < nb && 4 * hq < gc && 4 * cq < d - cb) {
          const int i = base + nb + v;
          if (!lay.bulk) wait(i);
          const TKV* vc = reinterpret_cast<const TKV*>(box_at(i)) + 4 * cq;
          float acc[4][4] = {};
          for (int r = 0; r < rows; ++r) {
            float x[4];
            smem4(vc + r * (kst / static_cast<int>(sizeof(TKV))), x);
            const float4 p = *reinterpret_cast<const float4*>(pt + r * kG + 4 * hq);
            const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][e] += pr[m] * x[e];
            }
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            if (4 * hq + m < gc) put_n<TQ, kG, 4>(a, sp, c0, 4 * hq + m, cb + 4 * cq, acc[m]);
          }
        }
        if (!lay.resident) {
          __syncthreads();
          for (int u = v0; u < min(nb, v0 + 4); ++u) refill(base + nb + u);
        }
      }
    }
    if (sp.n_spans > 1 && tid < gc) {
      float* st = a.stats + ((sp.head0 + c0 + tid) * a.max_splits + sp.s) * 2;
      st[0] = sp.ml[tid];
      st[1] = sp.ml[kG + tid];
    }
  }
}

// the wide route's combine: one block of kWideCombineThreads threads per
// (row, query head, slice of as many columns), so that a head's loads are
// spread over more blocks
constexpr int kWideCombineThreads = 128;
__host__ __device__ constexpr int combine_slices(int d) {
  return (d + kWideCombineThreads - 1) / kWideCombineThreads;
}

// the combine, a second launch: one block per (row, query head), and on
// the wide route per slice of kWideCombineThreads columns; every column's
// sums run as in one block
template <typename TQ, bool kWide = false>
__global__ void __launch_bounds__(kWide ? kWideCombineThreads : kCombineThreads)
paged_combine_kernel(const Args a) {
  __shared__ float ws[2 * kChunk];
  if constexpr (kWide) {
    const int slices = combine_slices(a.d);
    const size_t head = blockIdx.x / slices;
    const int c_lo = static_cast<int>(blockIdx.x % slices) * kWideCombineThreads;
    combine_head<TQ, kWideCombineThreads>(a, head, static_cast<int>(head / a.hq), ws,
                                          c_lo, min(a.d, c_lo + kWideCombineThreads));
  } else {
    // a row of one span wrote its output itself; the block finds out with
    // the loads of the combine already in flight and stores nothing
    combine_head<TQ>(a, blockIdx.x, blockIdx.x / a.hq, ws, 0, a.d);
  }
}

template <typename TQ, typename TKV, bool kQuant, int kMaxG>
int launch_split(const Args& a, cudaStream_t stream) {
  const size_t smem = layout<TKV, kQuant, kMaxG>(
      a.d, mma_route<TQ, TKV, kMaxG>() && a.d % 16 == 0).bytes;
  auto kernel = paged_split_kernel<TQ, TKV, kQuant, kMaxG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.batch * a.hkv * a.max_splits, kThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.max_splits == 1) return static_cast<int>(err);
  paged_combine_kernel<TQ><<<a.batch * a.hq, kCombineThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// heads wider than 256 columns: the wide span kernel, then the combine
template <typename TQ, typename TKV, bool kQuant>
int launch_wide(const Args& a, cudaStream_t stream) {
  const WideLayout lay = wide_layout<TQ, TKV>(a.d);
  if (lay.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_wide_kernel<TQ, TKV, kQuant>;
  if (lay.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.batch * a.hkv * a.max_splits, kWideThreads, lay.bytes, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.max_splits == 1) return static_cast<int>(err);
  paged_combine_kernel<TQ, true><<<a.batch * a.hq * combine_slices(a.d),
                                   kWideCombineThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool kQuant>
int launch(Args a, void* workspace, int b, void* stream) {
  if (b < 1 || a.hkv < 1 || a.hq % a.hkv != 0 || a.d % 8 != 0 || a.d < 8 ||
      a.n < 1 || a.page < 1 || a.np < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the wrapper's plan: ceil(nP * page / kSplit) spans, and a workspace
  // whenever a row can have two
  const long long span = static_cast<long long>(a.np) * a.page;
  if (a.max_splits != (span + kSplit - 1) / kSplit ||
      static_cast<long long>(b) * a.hkv * a.max_splits > INT_MAX ||
      static_cast<long long>(b) * a.hq * combine_slices(a.d) > INT_MAX ||
      (a.max_splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.part = static_cast<float*>(workspace);
  a.stats = a.part + static_cast<size_t>(b) * a.hq * a.max_splits * a.d;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.batch = b;
  if (a.d > 256) return launch_wide<TQ, TKV, kQuant>(a, s);
  const int g = a.hq / a.hkv;
  if (g == 1) return launch_split<TQ, TKV, kQuant, 1>(a, s);
  if (g <= 4) return launch_split<TQ, TKV, kQuant, 4>(a, s);
  return launch_split<TQ, TKV, kQuant, kMaxGroup>(a, s);
}

Args make_args(const void* q, const void* k, const void* ks, const void* v,
               const void* vs, const void* table, const void* lengths,
               void* out, int hq, int hkv, int d, int n, int page, int np,
               int max_splits, float scale) {
  Args a{};
  a.q = q; a.k = k; a.ks = static_cast<const float*>(ks);
  a.v = v; a.vs = static_cast<const float*>(vs);
  a.table = static_cast<const int*>(table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.hq = hq; a.hkv = hkv; a.d = d; a.n = n; a.page = page; a.np = np;
  a.max_splits = max_splits;
  a.scale = scale;
  return a;
}

}  // namespace

// positions per span
extern "C" int repro_paged_split_tokens() { return kSplit; }

// dtype codes: 0 = float32, 1 = bfloat16 (q and the output; the plain
// kernel's pages share q's dtype, the quant kernel's pages are int8).
// workspace: B*Hq*max_splits*(D+2) f32 (none when max_splits is 1).
extern "C" int repro_paged_attention(int dtype, const void* q, const void* k,
                                     const void* v, const void* table,
                                     const void* lengths, void* out,
                                     void* workspace, int b, int hq, int hkv,
                                     int d, int n, int page, int np,
                                     int max_splits, float scale, void* stream) {
  const Args a = make_args(q, k, nullptr, v, nullptr, table, lengths, out, hq,
                           hkv, d, n, page, np, max_splits, scale);
  if (dtype == 0) {
    return launch<float, float, false>(a, workspace, b, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16, false>(a, workspace, b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_paged_attention_quant(int dtype, const void* q,
                                           const void* k, const void* ks,
                                           const void* v, const void* vs,
                                           const void* table, const void* lengths,
                                           void* out, void* workspace, int b,
                                           int hq, int hkv, int d, int n,
                                           int page, int np, int max_splits,
                                           float scale, void* stream) {
  const Args a = make_args(q, k, ks, v, vs, table, lengths, out, hq, hkv, d,
                           n, page, np, max_splits, scale);
  if (dtype == 0) {
    return launch<float, int8_t, true>(a, workspace, b, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, int8_t, true>(a, workspace, b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
