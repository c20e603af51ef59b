// Paged decode attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (kfserving_tpu_torch/ops/paged_attention.py).
//
// Replaces the Pallas TPU kernel kfserving_tpu/ops/paged_attention.py::
// paged_attention_tpu (body _paged_kernel): one query token per row attends
// over a shared block pool [NB, BS, H, D], walked through the row's block
// table [B, MB] (-1 entries read block 0, as the TPU kernel clamps them) up
// to the row's length, with fp32 scores scaled by 1/sqrt(D), an fp32 softmax
// and an fp32 accumulator.  The output is acc / max(l, 1e-30) in q's dtype,
// so a row of length 0 gives exactly 0.  A length past MB * BS (a parked row)
// reads the whole table and never indexes past it.
//
// What bounds it.  Decode attention reads every valid key and value once and
// does 4 * D operations per (token, head): about one operation per byte in
// bf16, far under the H100's ~295, so it is bound by device memory.  The work
// is to keep enough bytes in flight on every SM, and to read no block past a
// row's length.
//
// Two paths; the wrapper routes by dtype and head dim, and a call that
// neither takes raises there:
//   - hopper: bf16 at D = 64, 128, 192 and 256 (every served decoder's
//     decode, verify, tier and handoff wave, and each tp rank's wave; the
//     TPU kernel's own head dims up to 256);
//   - simple: float32 at D = 16, 32, 64, 80, 96, 128, 192 and 256 and bf16
//     at D = 16, 32, 80 and 96 (the tiny configs, the fp32 edge cases, and
//     the head dims that are not a multiple of 64, where the JAX package
//     runs XLA), PR 2's flash-decoding kernel.
//
// Hopper path (paged_span_kernel + paged_span_combine_kernel).  What became
// of the four limits of the simple kernel:
//   1. A pipeline of loads.  A CTA stages its tiles into a ring of `stages`
//      shared-memory stages, each holding the K and the V tile of one token
//      span.  One producer thread issues one-dimensional bulk copies
//      (cp.async.bulk ... mbarrier::complete_tx) that follow the block table
//      on the device, up to `stages` tiles ahead; consumer warps wait on a
//      stage's full barrier, compute, and release it on its empty barrier.
//      K and V of later tiles are in flight while a tile computes.
//   2. All heads of a token span in one copy.  A tile is TT tokens of one
//      pool block with every head (or a head group, where H * D is too wide
//      for a stage): one contiguous region of TT * H * D * 2 bytes each for K
//      and V, so one copy each.  In shared memory a group of D / 8 lanes
//      (rounded up to a power of two: 32 with 8 idle at D = 192) reads one
//      (token, head) row with 16-byte loads, D split across the lanes, so
//      each quarter-warp reads 128 contiguous bytes (no bank conflict).
//      Each group keeps a running max, sum and accumulator for one head
//      over every P-th token of a tile (one pass, online softmax, no score
//      array).  At D = 256 one token of 8 heads is 8 KB of K and V, so a
//      stage holds 4 tokens (split_plan sizes tiles to the stage).
//   3. A split sized to the card.  The grid is static, G CTAs (the SM
//      count, from the wrapper's plan: B, H, D, BS, MB and the SMs) times
//      the head groups, so it can be captured in a CUDA graph.  A row's
//      partials are its spans of SPAN tokens, fixed by its own length, so a
//      row's output never depends on the other rows (a speculative verify
//      and plain decode give the same tokens only so).  Each CTA counts the
//      spans from `lengths` on the device and takes an equal run of whole
//      spans of all rows laid end to end; every valid (row, token) is read
//      once, and nothing past a row's length is read.  One long row is
//      spread over the card as evenly as many short ones, to a span.  A
//      CTA's run may cross rows: its tiles continue through the same ring.
//   4. The merge.  At a span's end the P groups of each head merge in
//      shared memory and write the span's partial at its slot, its index
//      among all spans; the CTA of a row's first span records its slot.  A
//      second kernel, grid (H, B), merges each row's slots in an order set
//      by the row's span count alone.
// CUDA cores do the arithmetic: at about one operation per byte, neither
// the TPU kernel nor this one needs the tensor cores.
//
// Simple path (paged_partition_kernel + paged_combine_kernel, flash
// decoding).  Pass 1 has one thread block per (partition of
// PARTITION_TOKENS tokens, head, row): partitions past the row's length exit
// at once.  Inside a block, groups of lanes take one token each and load
// the token's D values of this head with 16-byte vector loads: D / VEC
// lanes rounded up to a power of two (idle lanes load nothing), at most a
// warp, a lane holding several vectors where D / VEC is over 32 (fp32 at
// D = 192 and 256).  Scores go to shared memory; the block takes their max and
// sum, then walks V for P V, and writes the partition's unnormalized
// accumulator with its max and sum.  Pass 2 (one block per (head, row), one
// thread per d) merges the partitions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"

// Built with -DKFS_PAGED_LOADS_ONLY=1 (tools/paged_sweep.py does so for a
// measurement), the hopper path's consumers skip the arithmetic: what is
// left is the time of the copies, the ring and the merge.  Never served.
#ifndef KFS_PAGED_LOADS_ONLY
#define KFS_PAGED_LOADS_ONLY 0
#endif

namespace {

constexpr int PARTITION_TOKENS = 256;  // ops/paged_attention.py: same value
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

typedef __nv_bfloat16 bf16;

// One 16-byte vector of T as floats.
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
  __device__ __forceinline__ static void store(float* p, float x) { *p = x; }
};

// Lanes that share one (token, head) row of `vecs` 16-byte vectors, a
// power of two so a lane group divides the warp and its sums are xor
// shuffles: up to a warp's worth of vectors the next power of two (the
// lanes past `vecs` load nothing), past it the largest power of two up to
// 32 that divides `vecs` (each lane then holds vecs / lanes vectors, none
// idle: 16 lanes of 3 for fp32 at D = 192, whose idle-lane form spilled).
__host__ __device__ constexpr int row_lanes(int vecs) {
  int lanes = 1;
  if (vecs <= 32) {
    while (lanes < vecs) lanes *= 2;
    return lanes;
  }
  while (lanes < 32 && vecs % (2 * lanes) == 0) lanes *= 2;
  return lanes;
}

__device__ __forceinline__ int row_tokens(const int* lengths, int b,
                                          int max_tokens) {
  return min(max(lengths[b], 0), max_tokens);
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// Pass 1: grid (partitions, H, B).  A group of LPT lanes takes one token:
// lane i of the group holds the 16-byte vectors i, i + LPT, ... of its D
// values (NV of them: one where D fits a warp's vectors, three for fp32
// at D = 192 and two at 256), and lanes past D's vectors hold none.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    paged_partition_kernel(const T* __restrict__ q,
                           const T* __restrict__ pool_k,
                           const T* __restrict__ pool_v,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths,
                           float* __restrict__ part_acc,
                           float* __restrict__ part_ml, int H, int BS, int MB,
                           int parts, float scale) {
  constexpr int VEC = Vec<T>::N;
  static_assert(D % VEC == 0, "head dim");
  constexpr int VECS = D / VEC;         // 16-byte vectors of a row
  constexpr int LPT = row_lanes(VECS);  // lanes per token
  constexpr int NV = (VECS + LPT - 1) / LPT;  // vectors of a lane
  constexpr int TPW = 32 / LPT;         // tokens per warp step
  constexpr int GROUPS = WARPS * TPW;   // tokens per block step
  __shared__ float scores[PARTITION_TOKENS];
  __shared__ float red[WARPS];
  __shared__ float acc_red[GROUPS][D];

  const int p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = row_tokens(lengths, b, MB * BS);
  const int start = p * PARTITION_TOKENS;
  if (start >= len) return;  // past the row: the combine never reads it
  const int n = min(PARTITION_TOKENS, len - start);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp * TPW + lane / LPT;
  // Element offset of this lane's j-th vector, and whether it exists
  // (captured by value: a reference to `lane` put it on the stack).
  auto d_of = [=](int j) { return ((lane % LPT) + j * LPT) * VEC; };
  auto has = [=](int j) {
    return NV * LPT == VECS || (lane % LPT) + j * LPT < VECS;
  };
  const long long row_stride = (long long)H * D;  // one token of the pool

  float qv[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (has(j)) {
      Vec<T>::load(q + ((long long)b * H + h) * D + d_of(j), qv[j]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[j][i] = 0.f;
    }
  }
  const int* trow = table + (long long)b * MB;

  // Scores of this partition's tokens.  The loop bound is the warp's first
  // token, so every lane of a warp runs the same trips (the shuffles below
  // need all 32); lanes past the end load nothing.
  for (int t0 = warp * TPW; t0 < n; t0 += GROUPS) {
    const int t = t0 + lane / LPT;
    float s = 0.f;
    if (t < n) {
      const int pos = start + t;
      const int blk = max(trow[pos / BS], 0);
      const T* kp = pool_k + ((long long)blk * BS + pos % BS) * row_stride +
                    (long long)h * D;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!has(j)) continue;
        float kv[VEC];
        Vec<T>::load(kp + d_of(j), kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(qv[j][i], kv[i], s);
      }
    }
#pragma unroll
    for (int o = LPT / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (t < n && lane % LPT == 0) scores[t] = s * scale;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int t = threadIdx.x; t < n; t += THREADS) mx = fmaxf(mx, scores[t]);
  const float m = block_max(mx, red);
  float sum = 0.f;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const float e = expf(scores[t] - m);
    scores[t] = e;
    sum += e;
  }
  const float l = block_sum(sum, red);  // its barriers publish scores[]

  // P V over this partition, then across the token groups.
  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[j][i] = 0.f;
  for (int t = group; t < n; t += GROUPS) {
    const int pos = start + t;
    const int blk = max(trow[pos / BS], 0);
    const T* vp = pool_v + ((long long)blk * BS + pos % BS) * row_stride +
                  (long long)h * D;
    const float w = scores[t];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!has(j)) continue;
      float vv[VEC];
      Vec<T>::load(vp + d_of(j), vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[j][i] = fmaf(w, vv[i], acc[j][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (!has(j)) continue;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc_red[group][d_of(j) + i] = acc[j][i];
  }
  __syncthreads();
  const long long slot = ((long long)b * H + h) * parts + p;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float s = 0.f;
#pragma unroll 4
    for (int g = 0; g < GROUPS; ++g) s += acc_red[g][d];
    part_acc[slot * D + d] = s;
  }
  if (threadIdx.x == 0) {
    part_ml[slot * 2] = m;
    part_ml[slot * 2 + 1] = l;
  }
}

// Pass 2: grid (H, B), D threads.  Merges the row's non-empty partitions.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    paged_combine_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int H, int max_tokens, int parts) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = row_tokens(lengths, b, max_tokens);
  const int used = (len + PARTITION_TOKENS - 1) / PARTITION_TOKENS;
  const long long base = ((long long)b * H + h) * parts;
  float m = -INFINITY;
  for (int p = 0; p < used; ++p) m = fmaxf(m, part_ml[(base + p) * 2]);
  float l = 0.f, o = 0.f;
  for (int p = 0; p < used; ++p) {
    const float w = expf(part_ml[(base + p) * 2] - m);
    l = fmaf(part_ml[(base + p) * 2 + 1], w, l);
    o = fmaf(part_acc[(base + p) * D + d], w, o);
  }
  // used == 0 (a row of length 0): o = 0 and l = 0, so the output is 0.
  Vec<T>::store(out + ((long long)b * H + h) * D + d, o / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* pk, const void* pv, const int* table,
           const int* lengths, void* out, float* part_acc, float* part_ml,
           int B, int H, int BS, int MB, int parts, float scale,
           cudaStream_t stream) {
  dim3 grid1(parts, H, B);
  paged_partition_kernel<T, D><<<grid1, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, lengths, part_acc, part_ml, H, BS, MB,
      parts, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2(H, B);
  paged_combine_kernel<T, D><<<grid2, D, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), H, MB * BS, parts);
  return (int)cudaGetLastError();
}

// The simple path's instances: float32 at every head dim of the set, bf16
// at D = 16, 32, 80 and 96 (bf16 at D = 64, 128, 192 and 256 takes the
// hopper path).  ops/paged_attention.py::kernel_path routes the same way.
template <typename T>
int dispatch_d(int D, const void* q, const void* pk, const void* pv,
               const int* table, const int* lengths, void* out, float* pa,
               float* pml, int B, int H, int BS, int MB, int parts,
               float scale, cudaStream_t st) {
  constexpr bool f32 = std::is_same<T, float>::value;
#define KFS_SIMPLE(d)                                                       \
  if (D == d)                                                              \
    return launch<T, d>(q, pk, pv, table, lengths, out, pa, pml, B, H, BS, \
                        MB, parts, scale, st);
  KFS_SIMPLE(16)
  KFS_SIMPLE(32)
  KFS_SIMPLE(80)
  KFS_SIMPLE(96)
  if constexpr (f32) {
    KFS_SIMPLE(64)
    KFS_SIMPLE(128)
    KFS_SIMPLE(192)
    KFS_SIMPLE(256)
  }
#undef KFS_SIMPLE
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Hopper path: bf16 at D = 64, 128, 192 and 256.

constexpr int LANE_ELEMS = 8;           // bf16 in one 16-byte load
constexpr int CHUNK = 4;                // tokens a group scores together
constexpr int MAX_CONSUMERS = 512;      // consumer threads of a CTA
constexpr int SPAN_THREADS = MAX_CONSUMERS + 32;  // + the producer warp
constexpr int SMEM_LIMIT = 232448;      // 227 KB: a CTA's shared memory
constexpr float LOG2E = 1.4426950408889634f;

struct SpanParams {
  const bf16* q;
  const bf16* pool_k;
  const bf16* pool_v;
  const int* table;
  const int* lengths;
  float* part_acc;  // [spans, H, D]: each span's unnormalized P V
  float* part_ml;   // [spans, H, 2]: its max (log2 units) and sum
  int* row_first;   // [B]: the slot of each non-empty row's first span
  int B, H, BS, MB;
  int head_group;       // HG: heads of one CTA, H or a divisor of it
  int tile_tokens;      // TT: tokens of a stage, a power of two dividing BS
  int span_tokens;      // SPAN: tokens of one partial, a multiple of TT
  int stages;           // S: ring stages
  int groups_per_head;  // P: lane groups sharing one head's tokens
  int ctas;             // G: CTAs along the spans
  float scale_log2;     // log2(e) / sqrt(D)
};

// Shared-memory bytes of one CTA: the ring (K and V of each stage), the
// span merge's two scratch buffers, the barriers and the CTA's share.  Keep
// equal to span_smem_bytes in ops/paged_attention.py.
__host__ __device__ inline int span_smem_bytes(int D, int HG, int TT, int S,
                                               int P) {
  return 2 * S * TT * HG * D * (int)sizeof(bf16) +
         2 * P * HG * (D + 2) * 4 + 2 * S * 8 + 16;
}

__device__ __forceinline__ int row_spans(const int* lengths, int b,
                                         int max_tokens, int span) {
  return (row_tokens(lengths, b, max_tokens) + span - 1) / span;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ long long warp_scan(long long x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Syncs the consumer warps only (named barrier 1): the producer may be
// blocked on a stage.
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// A CTA's walk over its share: row, token within it, the row's clamped
// length and the spans left in the share.  Producer and consumers each step
// one alike, so both see the same sequence of tiles.
struct Cursor {
  int row, pos, len, spans;

  // Tokens of the next tile: to the next multiple of TT (which divides BS
  // and SPAN, so a tile never crosses a pool block or a span) or the row's
  // end.
  __device__ __forceinline__ int tile(int tt) const {
    return min(len - pos, tt - (pos & (tt - 1)));
  }

  // Steps past the tile's n tokens; returns whether they ended a span.
  __device__ __forceinline__ bool advance(int n, int span,
                                          const int* lengths, int B,
                                          int max_tokens) {
    pos += n;
    if (pos != len && (pos & (span - 1)) != 0) return false;
    --spans;
    if (pos == len && spans > 0) {
      pos = 0;
      do {
        ++row;
        len = row_tokens(lengths, row, max_tokens);
      } while (len == 0 && row + 1 < B);
    }
    return true;
  }
};

// Grid (G, H / HG); HG * P * LPG consumer threads plus one producer warp.
template <int D>
__global__ void __launch_bounds__(SPAN_THREADS)
    paged_span_kernel(const SpanParams p) {
  // Lanes of one (token, head) row: its D / 8 vectors, padded to a power
  // of two (8 of the 32 idle at D = 192); span_lanes in
  // ops/paged_attention.py.
  constexpr int VECS = D / LANE_ELEMS;
  constexpr int LPG = row_lanes(VECS);
  static_assert(D % LANE_ELEMS == 0 && VECS <= 32, "head dim");
  extern __shared__ __align__(128) unsigned char smem[];
  const int HG = p.head_group, TT = p.tile_tokens, S = p.stages,
            P = p.groups_per_head, H = p.H;
  const int consumers = HG * P * LPG;
  const int tile_elems = TT * HG * D;
  const int SPAN = p.span_tokens;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: K, then V
  float* red = reinterpret_cast<float*>(ring + 2 * S * tile_elems);
  const int red_floats = P * HG * (D + 2);  // one buffer: acc, then m and l
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * red_floats);
  int* share = reinterpret_cast<int*>(bars + 2 * S);  // row, pos, spans, slot

  const int g = blockIdx.x, h0 = blockIdx.y * HG;
  const int max_tokens = p.MB * p.BS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // A row's partials are its spans of SPAN tokens, fixed by its own length,
  // so its output does not depend on the other rows.  This CTA's share is a
  // run of whole spans of all rows laid end to end: [g * I / G', (g + 1) *
  // I / G') with I the spans and G' = min(G, I), so no share is empty.
  // Warp 0 counts the spans, then finds the row holding the share's first
  // (the first 32 rows' prefix is kept from the count).
  if (warp == 0) {
    const long long v0 =
        lane < p.B ? row_spans(p.lengths, lane, max_tokens, SPAN) : 0;
    const long long incl0 = warp_scan(v0, lane);
    long long total = __shfl_sync(0xffffffffu, incl0, 31);
    for (int c = 32; c < p.B; c += 32) {
      const int r = c + lane;
      total += warp_sum(r < p.B ? row_spans(p.lengths, r, max_tokens, SPAN)
                                : 0);
    }
    const long long ctas = min((long long)p.ctas, total);
    int row = -1;
    long long begin = 0, end = 0, before = 0, run = 0;
    if (g < ctas) {
      begin = g * total / ctas;
      end = (g + 1) * total / ctas;
      for (int c = 0; c < p.B && row < 0; c += 32) {
        const int r = c + lane;
        long long v = v0, incl = incl0;
        if (c > 0) {
          v = r < p.B ? row_spans(p.lengths, r, max_tokens, SPAN) : 0;
          incl = warp_scan(v, lane) + run;
        }
        const unsigned hit =
            __ballot_sync(0xffffffffu, r < p.B && incl > begin);
        if (hit) {
          const int first = __ffs(hit) - 1;
          row = c + first;
          before = __shfl_sync(0xffffffffu, incl - v, first);
        }
        run = __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    if (lane == 0) {
      share[0] = row;
      share[1] = (int)(begin - before) * SPAN;
      share[2] = (int)(end - begin);
      share[3] = (int)begin;  // the slot of the share's first span
      for (int s = 0; s < S; ++s) {
        mbar_init(smem_u32(&bars[s]), 1);                 // full
        mbar_init(smem_u32(&bars[S + s]), consumers / 32);  // empty
      }
      fence_barrier_init();
    }
  }
  __syncthreads();
  Cursor cur;
  cur.row = share[0];
  if (cur.row < 0) return;  // no share: more CTAs than spans
  cur.pos = share[1];
  cur.spans = share[2];
  cur.len = row_tokens(p.lengths, cur.row, max_tokens);
  const long long token_stride = (long long)H * D;  // one token of a pool
  const int token_bytes = HG * D * (int)sizeof(bf16);

  if (threadIdx.x >= consumers) {
    // Producer: one thread keeps up to S tiles in flight.
    if (threadIdx.x != consumers) return;
    int entry = -1, blk = 0;
    for (int s = 0, phase = 0, i = 0; cur.spans > 0; ++i) {
      const int n = cur.tile(TT);
      if (i >= S) mbar_wait(smem_u32(&bars[S + s]), phase ^ 1);
      const int e = cur.row * p.MB + cur.pos / p.BS;
      if (e != entry) {
        entry = e;
        blk = max(__ldg(p.table + e), 0);
      }
      const long long off =
          ((long long)blk * p.BS + cur.pos % p.BS) * token_stride +
          (long long)h0 * D;
      const uint32_t full = smem_u32(&bars[s]);
      const uint32_t dk = smem_u32(ring + 2 * s * tile_elems);
      const uint32_t dv = dk + tile_elems * (uint32_t)sizeof(bf16);
      mbar_expect_tx(full, 2 * n * token_bytes);
      if (HG == H) {  // the span is one contiguous region
        bulk_load(dk, p.pool_k + off, n * token_bytes, full);
        bulk_load(dv, p.pool_v + off, n * token_bytes, full);
      } else {
        for (int t = 0; t < n; ++t) {
          bulk_load(dk + t * token_bytes, p.pool_k + off + t * token_stride,
                    token_bytes, full);
          bulk_load(dv + t * token_bytes, p.pool_v + off + t * token_stride,
                    token_bytes, full);
        }
      }
      cur.advance(n, SPAN, p.lengths, p.B, max_tokens);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: group grp owns head h for tokens par, par + P, ... of each
  // tile; its lanes split D.
  const int grp = threadIdx.x / LPG;
  const int h = grp % HG, par = grp / HG;
  const int d0 = (threadIdx.x % LPG) * LANE_ELEMS;
  // Whether this lane holds a vector of the row (every lane where D / 8
  // is a power of two); an idle lane loads nothing and adds 0.
  const bool live = VECS == LPG || threadIdx.x % LPG < VECS;
  const int row_elems = HG * D;  // one token of a tile
  float m = -INFINITY, l = 0.f, acc[LANE_ELEMS], qv[LANE_ELEMS];
#pragma unroll
  for (int i = 0; i < LANE_ELEMS; ++i) acc[i] = qv[i] = 0.f;
  int slot = share[3], buf = 0, q_row = -1;
  bool first = false;  // the current span is its row's first
  bool span_start = true;
  for (int s = 0, phase = 0; cur.spans > 0;) {
    const int n = cur.tile(TT);
    if (cur.row != q_row && live) {
      Vec<bf16>::load(p.q + ((long long)cur.row * H + h0 + h) * D + d0, qv);
#pragma unroll
      for (int i = 0; i < LANE_ELEMS; ++i) qv[i] *= p.scale_log2;
    }
    q_row = cur.row;
    if (span_start) {
      first = cur.pos == 0;
      span_start = false;
    }
    mbar_wait(smem_u32(&bars[s]), phase);
    const bf16* kt = ring + 2 * s * tile_elems + h * D + d0;
    const bf16* vt = kt + tile_elems;
    // Every lane runs the same trips (the shuffles need all 32); tokens
    // past the tile score nothing and load nothing.
    const int trips = KFS_PAGED_LOADS_ONLY ? 0 : (n + P - 1) / P;
    for (int k = 0; k < trips; k += CHUNK) {
      float sc[CHUNK];
      uint4 vraw[CHUNK];
      bool ok[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int t = par + (k + u) * P;
        ok[u] = t < n;
        sc[u] = 0.f;
        if (!live) vraw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u] && live) {
          float kv[LANE_ELEMS];
          Vec<bf16>::load(kt + t * row_elems, kv);
#pragma unroll
          for (int i = 0; i < LANE_ELEMS; ++i) sc[u] = fmaf(qv[i], kv[i], sc[u]);
          vraw[u] = *reinterpret_cast<const uint4*>(vt + t * row_elems);
        }
      }
#pragma unroll
      for (int o = LPG / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < CHUNK; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u]);
      const float m_new = fmaxf(m, mx);
      if (m_new == -INFINITY) continue;  // no token yet for this group
      const float alpha = exp2f(m - m_new);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int i = 0; i < LANE_ELEMS; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (!ok[u]) continue;
        const float w = exp2f(sc[u] - m_new);
        l += w;
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&vraw[u]);
#pragma unroll
        for (int i = 0; i < LANE_ELEMS / 2; ++i) {
          const float2 f = __bfloat1622float2(v2[i]);
          acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
          acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
        }
      }
      m = m_new;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[S + s]));  // stage s is free
    const int row = cur.row;
    const bool span_done = cur.advance(n, SPAN, p.lengths, p.B, max_tokens);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
    if (!span_done) continue;

    // The span ends: merge the P groups of each head and write the span's
    // partial.  Two scratch buffers in turn: a thread that writes this one
    // again has passed the next span's barrier, so every read of it ended.
    float* red_acc = red + buf * red_floats;
    float* red_ml = red_acc + P * HG * D;
    float* mine = red_acc + (par * HG + h) * D + d0;
    if (live) {
#pragma unroll
      for (int i = 0; i < LANE_ELEMS; ++i) mine[i] = acc[i];
    }
    if (threadIdx.x % LPG == 0) {
      red_ml[2 * (par * HG + h)] = m;
      red_ml[2 * (par * HG + h) + 1] = l;
    }
    consumer_sync(consumers);
    for (int idx = threadIdx.x; idx < HG * D; idx += consumers) {
      const int hh = idx / D, d = idx % D;
      float mm = -INFINITY;
      for (int j = 0; j < P; ++j) mm = fmaxf(mm, red_ml[2 * (j * HG + hh)]);
      float ll = 0.f, aa = 0.f;
      for (int j = 0; j < P; ++j) {
        const float w = exp2f(red_ml[2 * (j * HG + hh)] - mm);
        ll = fmaf(red_ml[2 * (j * HG + hh) + 1], w, ll);
        aa = fmaf(red_acc[(j * HG + hh) * D + d], w, aa);
      }
      const long long o = (long long)slot * H + h0 + hh;
      p.part_acc[o * D + d] = aa;
      if (d == 0) {
        p.part_ml[2 * o] = mm;
        p.part_ml[2 * o + 1] = ll;
      }
    }
    if (threadIdx.x == 0 && first) p.row_first[row] = slot;
    ++slot;
    buf ^= 1;
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < LANE_ELEMS; ++i) acc[i] = 0.f;
    span_start = true;
  }
}

// Grid (H, B), COMBINE_WARPS warps: merges the partials of each row's
// spans.  Warp w takes the row's slots w * BATCH, w * BATCH + 1, ... in
// batches of BATCH (loads of a batch in flight together), merging them
// online with its lanes over d; then the warps merge in shared memory.  The
// order depends on the row's span count alone.
constexpr int COMBINE_WARPS = 16;
constexpr int BATCH = 8;

template <int D>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
    paged_span_combine_kernel(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              const int* __restrict__ row_first,
                              const int* __restrict__ lengths,
                              bf16* __restrict__ out, int H, int max_tokens,
                              int span) {
  constexpr int DPL = D / 32;  // d of one lane
  __shared__ float s_ml[COMBINE_WARPS][2];
  __shared__ float s_acc[COMBINE_WARPS][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* o = out + ((long long)b * H + h) * D;
  // Both loads in flight together; row_first is stale for an empty row.
  const long long lo = row_first[b];
  const int len = row_tokens(lengths, b, max_tokens);
  const long long hi = lo + (len + span - 1) / span - 1;
  if (len == 0) {
    // A row of length 0 has no partial: its output is exactly 0.
    if (threadIdx.x < D) o[threadIdx.x] = __float2bfloat16_rn(0.f);
    return;
  }
  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (long long s0 = lo + warp * BATCH; s0 <= hi;
       s0 += COMBINE_WARPS * BATCH) {
    float ms[BATCH], ls[BATCH], as[BATCH][DPL];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long s = s0 + u;
      ms[u] = -INFINITY;
      ls[u] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) as[u][i] = 0.f;
      if (s <= hi) {
        const long long e = s * H + h;
        ms[u] = part_ml[2 * e];
        ls[u] = part_ml[2 * e + 1];
#pragma unroll
        for (int i = 0; i < DPL; ++i) as[u][i] = part_acc[e * D + lane * DPL + i];
      }
    }
    float mb = m;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) mb = fmaxf(mb, ms[u]);
    const float a = exp2f(m - mb);  // the batch's first slot is valid
    l *= a;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= a;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const float w = exp2f(ms[u] - mb);  // 0 past the row's last slot
      l = fmaf(ls[u], w, l);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(as[u][i], w, acc[i]);
    }
    m = mb;
  }
  if (lane == 0) {
    s_ml[warp][0] = m;
    s_ml[warp][1] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) s_acc[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < D) {
    // Warps without a slot keep m = -inf and weigh 0; slot lo is live.
    float mm = -INFINITY;
    for (int w = 0; w < COMBINE_WARPS; ++w) mm = fmaxf(mm, s_ml[w][0]);
    float ll = 0.f, oo = 0.f;
    for (int w = 0; w < COMBINE_WARPS; ++w) {
      const float wt = exp2f(s_ml[w][0] - mm);
      ll = fmaf(s_ml[w][1], wt, ll);
      oo = fmaf(s_acc[w][threadIdx.x], wt, oo);
    }
    o[threadIdx.x] = __float2bfloat16_rn(oo / fmaxf(ll, 1e-30f));
  }
}

template <int D>
int launch_span(const SpanParams& p, bf16* out, cudaStream_t stream) {
  auto kernel = paged_span_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  const int consumers =
      p.head_group * p.groups_per_head * row_lanes(D / LANE_ELEMS);
  if (consumers % 32 != 0 || consumers > MAX_CONSUMERS)
    return (int)cudaErrorInvalidValue;
  const int smem = span_smem_bytes(D, p.head_group, p.tile_tokens, p.stages,
                                   p.groups_per_head);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.ctas, p.H / p.head_group);
  kernel<<<grid, consumers + 32, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_span_combine_kernel<D><<<dim3(p.H, p.B), COMBINE_WARPS * 32, 0,
                                 stream>>>(
      p.part_acc, p.part_ml, p.row_first, p.lengths, out, p.H, p.MB * p.BS,
      p.span_tokens);
  return (int)cudaGetLastError();
}

}  // namespace

// The simple path (dispatch_d's instances).
// dtype: 0 = bfloat16, 1 = float32.  q [B, 1, H, D], pools [NB, BS, H, D],
// out [B, 1, H, D], all contiguous; table [B, MB] and lengths [B] int32.
// part_acc [B, H, parts, D] and part_ml [B, H, parts, 2] fp32 scratch, with
// parts = ceil(MB * BS / PARTITION_TOKENS).  Returns the launches'
// cudaError_t as an int.
extern "C" int kfs_paged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* lengths, void* out,
                                   void* part_acc, void* part_ml, int B,
                                   int H, int D, int BS, int MB, int parts,
                                   int dtype, float scale, void* stream) {
  if (parts * PARTITION_TOKENS < MB * BS) return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<bf16>(D, q, pool_k, pool_v, tbl, lens, out, pa, pml, B,
                            H, BS, MB, parts, scale, st);
  if (dtype == 1)
    return dispatch_d<float>(D, q, pool_k, pool_v, tbl, lens, out, pa, pml, B,
                             H, BS, MB, parts, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The hopper path: bf16 q [B, 1, H, D], pools [NB, BS, H, D], out
// [B, 1, H, D], all contiguous; table [B, MB] and lengths [B] int32;
// part_acc [B * ceil(MB * BS / span_tokens), H, D] and part_ml [the same
// spans, H, 2] fp32 and row_first [B] int32 scratch.  The plan
// (head_group, tile_tokens, span_tokens, stages, groups_per_head, ctas)
// comes from split_plan in ops/paged_attention.py.  Returns the launches'
// cudaError_t as an int.
extern "C" int kfs_paged_attention_hopper(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* lengths, void* out, void* part_acc, void* part_ml,
    void* row_first, int B, int H, int D, int BS, int MB, int head_group,
    int tile_tokens, int span_tokens, int stages, int groups_per_head,
    int ctas, float scale, void* stream) {
  if (head_group < 1 || H % head_group != 0 || tile_tokens < 1 ||
      (tile_tokens & (tile_tokens - 1)) != 0 || BS % tile_tokens != 0 ||
      (span_tokens & (span_tokens - 1)) != 0 || span_tokens < tile_tokens ||
      stages < 1 || groups_per_head < 1 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  SpanParams p;
  p.q = static_cast<const bf16*>(q);
  p.pool_k = static_cast<const bf16*>(pool_k);
  p.pool_v = static_cast<const bf16*>(pool_v);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.row_first = static_cast<int*>(row_first);
  p.B = B;
  p.H = H;
  p.BS = BS;
  p.MB = MB;
  p.head_group = head_group;
  p.tile_tokens = tile_tokens;
  p.span_tokens = span_tokens;
  p.stages = stages;
  p.groups_per_head = groups_per_head;
  p.ctas = ctas;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* o = static_cast<bf16*>(out);
  if (D == 64) return launch_span<64>(p, o, st);
  if (D == 128) return launch_span<128>(p, o, st);
  if (D == 192) return launch_span<192>(p, o, st);
  if (D == 256) return launch_span<256>(p, o, st);
  return (int)cudaErrorInvalidValue;
}
