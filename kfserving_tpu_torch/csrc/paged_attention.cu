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
// is to keep enough loads in flight, and to read no block past a row's length.
//
// Design (flash decoding).  The TPU grid walks a row's blocks in order on one
// core; here the walk is split.  Pass 1 has one thread block per (partition
// of PARTITION_TOKENS tokens, head, row): partitions past the row's length
// exit at once, so the grid is static (no host sync on the lengths) while the
// reads follow the data.  Inside a block, groups of D / VEC lanes take one
// token each and load the token's D values of this head with 16-byte vector
// loads: a head's row is D contiguous elements (128 bytes at D = 64 bf16), so
// every load uses whole memory segments.  Scores go to shared memory; the
// block takes their max and sum, then walks V for P V, and writes the
// partition's unnormalized accumulator with its max and sum.  Pass 2 (one
// block per (head, row), one thread per d) merges the partitions.
//
// This first version reads K and V of each head separately (the TPU kernel
// reads [BS, H * D] tiles with all heads at once) and keeps no pipeline of
// loads beyond what the warps in flight give; cp.async/TMA staging is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// Pass 1: grid (partitions, H, B).
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
  constexpr int LPT = D / VEC;          // lanes per token
  static_assert(LPT >= 1 && LPT <= 32 && (32 % LPT) == 0, "head dim");
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
  const int d0 = (lane % LPT) * VEC;
  const long long row_stride = (long long)H * D;  // one token of the pool

  float qv[VEC];
  Vec<T>::load(q + ((long long)b * H + h) * D + d0, qv);
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
                    (long long)h * D + d0;
      float kv[VEC];
      Vec<T>::load(kp, kv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(qv[i], kv[i], s);
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
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int t = group; t < n; t += GROUPS) {
    const int pos = start + t;
    const int blk = max(trow[pos / BS], 0);
    const T* vp = pool_v + ((long long)blk * BS + pos % BS) * row_stride +
                  (long long)h * D + d0;
    float vv[VEC];
    Vec<T>::load(vp, vv);
    const float w = scores[t];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, vv[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc_red[group][d0 + i] = acc[i];
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

template <typename T>
int dispatch_d(int D, const void* q, const void* pk, const void* pv,
               const int* table, const int* lengths, void* out, float* pa,
               float* pml, int B, int H, int BS, int MB, int parts,
               float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, pk, pv, table, lengths, out, pa, pml, B, H, BS,
                           MB, parts, scale, st);
    case 64:
      return launch<T, 64>(q, pk, pv, table, lengths, out, pa, pml, B, H, BS,
                           MB, parts, scale, st);
    case 128:
      return launch<T, 128>(q, pk, pv, table, lengths, out, pa, pml, B, H,
                            BS, MB, parts, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

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
