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
// - Heads wider than 256 columns keep the spans and the combine and stream
//   D through shared memory in 64-column boxes (paged_wide_kernel); any
//   multiple of 8 runs, and the wrapper pads the rest.
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
// 0, 1, ...  The block has kCombineThreads threads, kCols columns each in
// a pass; a head wider than a pass takes more, each over all its spans
// again.  ws holds 2 * kChunk floats.
template <typename TQ>
__device__ __forceinline__ void combine_head(const Args& a, size_t head, int b,
                                             float* ws) {
  constexpr int kBlock = kCombineThreads;
  constexpr int kCols = (256 + kBlock - 1) / kBlock;   // columns per thread
  const int tid = threadIdx.x;
  const int d = a.d;
  const float* st = a.stats + head * a.max_splits * 2;
  const float* pt = a.part + head * a.max_splits * d;
  float* w_s = ws;
  float* lw_s = ws + kChunk;
  for (int c_base = 0; c_base < d; c_base += kCols * kBlock) {
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
          x[c][i] = i < cap && col < d
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
      if (col < d) {
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

// Heads wider than 256 columns.  The staged span outgrows shared memory
// there (64 f32 key and value rows of D 576 are 297 KB), so such a head keeps
// the split, the spans, the workspace and the combine, and streams D
// through shared memory in boxes of kWideBox columns as f32 (int8 rows
// unscaled): thread (position, head set) adds each box's part of its
// scores to their slots in shared memory (no other thread writes them);
// span_softmax takes them as one part; then thread (column, head set) sums
// p V box after box, for every head of a pass of up to kMaxGroup.  Each sum
// runs in one thread in an order the source fixes, so the bits stay
// fixed.
// A simple kernel, not a fast one: no configuration has such heads.
constexpr int kWideBox = 64;
constexpr int kWideStride = kWideBox + 1;    // odd: a column's rows in distinct banks
constexpr int kHeadSets = kThreads / kSplit;
static_assert(kThreads == kHeadSets * kWideBox, "a thread per (column, head set)");

template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads, 1)
paged_wide_kernel(const Args a) {
  constexpr int kG = kMaxGroup;
  const int s = blockIdx.x % a.max_splits;
  const int bh = blockIdx.x / a.max_splits;
  const int h = bh % a.hkv;
  const int b = bh / a.hkv;
  const int d = a.d;
  const int g = a.hq / a.hkv;
  const int tid = threadIdx.x;
  const int r0 = s * kSplit;
  const int* tb = a.table + static_cast<size_t>(b) * a.np;
  long long prow = 0;
  if (tid < kSplit && r0 + tid < a.np * a.page) {
    prow = static_cast<long long>(pool_row(tb, r0 + tid, h, a));
  }
  const int n_spans = spans_of(a, b);
  if (s >= n_spans) return;
  const int len = max(0, min(a.lengths[b], a.np * a.page));

  __shared__ __align__(16) float x_s[kSplit * kWideStride];   // a box of K or V rows
  __shared__ __align__(16) float q_s[kG * kWideBox];          // a box of the pass's q rows
  __shared__ __align__(16) float sc_s[kG * kSplit];           // scores, then p
  __shared__ float ml_s[2 * kG];
  __shared__ float ksc_s[kSplit], vsc_s[kSplit];
  __shared__ long long rows_s[kSplit];
  Span sp{};
  sp.ksc = ksc_s;
  sp.vsc = vsc_s;
  sp.sc = sc_s;
  sp.ml = ml_s;
  sp.head0 = static_cast<size_t>(b) * a.hq + static_cast<size_t>(h) * g;
  sp.s = s;
  sp.n_spans = n_spans;
  sp.rows = max(0, min(kSplit, len - r0));
  if (tid < sp.rows) {
    rows_s[tid] = prow;
    if (kQuant) {
      ksc_s[tid] = a.ks[prow];
      vsc_s[tid] = a.vs[prow];
    }
  }
  const TQ* qb = static_cast<const TQ*>(a.q) + sp.head0 * d;
  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);
  const int pos = tid % kSplit;     // scores: this thread's position
  const int col = tid % kWideBox;   // p V: this thread's column of a box
  const int set = tid / kSplit;     // heads set, set + kHeadSets, ... of a pass
  for (int c0 = 0; c0 < g; c0 += kG) {
    const int gc = min(kG, g - c0);
    __syncthreads();   // the last pass's readers of sc_s are done
    for (int j = set; j < gc; j += kHeadSets) sc_s[j * kSplit + pos] = 0.f;
    for (int cb = 0; cb < d; cb += kWideBox) {
      const int w = min(kWideBox, d - cb);
      __syncthreads();   // the last box's readers are done
      for (int i = tid; i < kSplit * w; i += kThreads) {
        const int rr = i / w;
        const int c = i - rr * w;
        x_s[rr * kWideStride + c] =
            rr < sp.rows ? to_float(kp[rows_s[rr] * d + cb + c]) : 0.f;
      }
      for (int i = tid; i < gc * w; i += kThreads) {
        const int j = i / w;
        const int c = i - j * w;
        q_s[j * kWideBox + c] = to_float(qb[static_cast<size_t>(c0 + j) * d + cb + c]);
      }
      __syncthreads();
      for (int j = set; j < gc; j += kHeadSets) {
        float t = sc_s[j * kSplit + pos];
        for (int c = 0; c < w; ++c) t += q_s[j * kWideBox + c] * x_s[pos * kWideStride + c];
        sc_s[j * kSplit + pos] = t;
      }
    }
    __syncthreads();
    span_softmax<TKV, kQuant, kG, 1>(a, sp, gc, nullptr);
    for (int cb = 0; cb < d; cb += kWideBox) {
      const int w = min(kWideBox, d - cb);
      __syncthreads();   // p is in sc_s; the last box's readers are done
      for (int i = tid; i < kSplit * w; i += kThreads) {
        const int rr = i / w;
        const int c = i - rr * w;
        x_s[rr * kWideStride + c] =
            rr < sp.rows ? to_float(vp[rows_s[rr] * d + cb + c]) : 0.f;
      }
      __syncthreads();
      if (col < w) {
        for (int j = set; j < gc; j += kHeadSets) {
          float t = 0.f;
          for (int rr = 0; rr < sp.rows; ++rr) {
            t += sc_s[j * kSplit + rr] * x_s[rr * kWideStride + col];
          }
          put<TQ, kG>(a, sp, c0, j, cb + col, t);
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

// the combine, a second launch: one block per (row, query head)
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const Args a) {
  __shared__ float ws[2 * kChunk];
  // a row of one span wrote its output itself; the block finds out with
  // the loads of the combine already in flight and stores nothing
  combine_head<TQ>(a, blockIdx.x, blockIdx.x / a.hq, ws);
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

// heads wider than 256 columns: the boxed span kernel, then the combine
template <typename TQ, typename TKV, bool kQuant>
int launch_wide(const Args& a, cudaStream_t stream) {
  paged_wide_kernel<TQ, TKV, kQuant><<<a.batch * a.hkv * a.max_splits, kThreads, 0,
                                       stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.max_splits == 1) return static_cast<int>(err);
  paged_combine_kernel<TQ><<<a.batch * a.hq, kCombineThreads, 0, stream>>>(a);
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
      static_cast<long long>(b) * a.hq > INT_MAX ||
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
