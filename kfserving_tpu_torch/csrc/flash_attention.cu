// Flash attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (kfserving_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas TPU kernel kfserving_tpu/ops/pallas_attention.py::
// flash_attention (body _flash_kernel): softmax(Q K^T / sqrt(D)) V over
// [B, L, H, D] tensors with an online softmax, fp32 running max, normalizer
// and accumulator, optional causal masking (query i at position i) and
// optional per-row kv_lengths (suffix key padding; key tiles past a row's
// length are skipped).  Rows with no valid key give 0.
//
// Design.  One thread block owns BLOCK_Q = 64 query rows of one (b, h) and
// walks the key axis in BLOCK_K = 64 tiles; the loop replaces the TPU grid's
// sequential k axis.  Four warps each own 16 query rows.  Both products run
// on the tensor cores with mma.sync m16n8k16 (bf16 operands, fp32
// accumulate); the score tile stays in registers and is re-packed as the
// A operand of P V without touching shared memory.  fp32 inputs are split
// into bf16 hi + lo halves and multiplied as hi*hi + hi*lo + lo*hi, which
// keeps about 16 mantissa bits.  Q, K and V are read by strides, so views of
// a fused projection need no transpose copy.
//
// What bounds it.  At the BERT-base serving shapes (D = 64, L <= 512) the
// work is 4*B*H*L^2*D operations against 4*B*L*H*D*2 bytes, about L/2 flops
// per byte: below the H100's ~295 bf16 flops per byte for L < 590, so the
// bound is memory for the shorter buckets and close to balanced at 512.  This
// first version loads each K/V tile synchronously (no cp.async / TMA
// pipeline, no wgmma), so it is latency-bound well above either roof; the
// pipelined wgmma form is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
// Row padding of the shared-memory tiles, in bf16 elements (16 bytes):
// staggers rows across banks so the fragment loads below are conflict-free.
constexpr int PAD = 8;

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, l, h;  // elements; the D axis has stride 1
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats -> one register of two bf16 (the lower column in the low half).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// Two floats -> bf16 hi halves and the bf16 rounding of what they miss.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 scalars from separate rows -> one register (the V operand).
__device__ __forceinline__ uint32_t pack_rows(const bf16* p, int ld) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) |
         ((uint32_t)__bfloat16_as_ushort(p[ld]) << 16);
}

// Copies a [64, D] tile (rows past `rows_valid` zero-filled) from global
// memory into shared memory as bf16 (and, for fp32 input, its lo half).
template <typename T, int D, bool SPLIT>
__device__ void load_tile(bf16* hi, bf16* lo, const T* base,
                          long long stride_l, int rows_valid) {
  constexpr int LD = D + PAD;
  constexpr int VN = std::is_same<T, float>::value ? 4 : 8;  // 16 bytes
  constexpr int CPR = D / VN;
  for (int i = threadIdx.x; i < BLOCK_Q * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * VN;
    bf16* dh = hi + r * LD + c;
    if constexpr (SPLIT) {
      bf16* dl = lo + r * LD + c;
      uint2 h = make_uint2(0u, 0u), l = make_uint2(0u, 0u);
      if (r < rows_valid) {
        const float4 f =
            *reinterpret_cast<const float4*>(base + r * stride_l + c);
        split_pack(f.x, f.y, h.x, l.x);
        split_pack(f.z, f.w, h.y, l.y);
      }
      *reinterpret_cast<uint2*>(dh) = h;
      *reinterpret_cast<uint2*>(dl) = l;
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) {
        val = *reinterpret_cast<const uint4*>(base + r * stride_l + c);
      }
      *reinterpret_cast<uint4*>(dh) = val;
    }
  }
}

template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     const int* __restrict__ kv_lengths, int H, int Lq, int Lk,
                     int causal, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale_log2) {
  constexpr int LD = D + PAD;
  constexpr int TILE = BLOCK_Q * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + TILE;
  bf16* sv = sk + TILE;
  // lo halves follow the hi tiles (fp32 input only).
  bf16* sq_lo = sv + TILE;
  bf16* sk_lo = sq_lo + TILE;
  bf16* sv_lo = sk_lo + TILE;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  int n_kv = Lk;
  if (kv_lengths != nullptr) n_kv = min(max(kv_lengths[b], 0), Lk);
  int kv_end = n_kv;
  // Keys past the tile's last query row never attend (causal skip).
  if (causal) kv_end = min(kv_end, q0 + BLOCK_Q);

  const T* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.l;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, D, SPLIT>(sq, sq_lo, qb, qs.l, min(BLOCK_Q, Lq - q0));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp
  float l_i[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;
  const int wrow = warp * 16 + g;

  for (int k0 = 0; k0 < kv_end; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile's readers are done
    const int rows = min(BLOCK_K, Lk - k0);
    load_tile<T, D, SPLIT>(sk, sk_lo, kb + (long long)k0 * ks.l, ks.l, rows);
    load_tile<T, D, SPLIT>(sv, sv_lo, vb + (long long)k0 * vs.l, vs.l, rows);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BLOCK_K / 8][4];
#pragma unroll
    for (int n = 0; n < BLOCK_K / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qr = sq + wrow * LD + kk * 16 + t * 2;
      uint32_t a[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8),
                       ld32(qr + 8 * LD + 8)};
      uint32_t al[4];
      if constexpr (SPLIT) {
        const bf16* ql = sq_lo + wrow * LD + kk * 16 + t * 2;
        al[0] = ld32(ql);
        al[1] = ld32(ql + 8 * LD);
        al[2] = ld32(ql + 8);
        al[3] = ld32(ql + 8 * LD + 8);
      }
#pragma unroll
      for (int n = 0; n < BLOCK_K / 8; ++n) {
        const bf16* kr = sk + (n * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t b0 = ld32(kr), b1 = ld32(kr + 8);
        mma_bf16(s[n], a, b0, b1);
        if constexpr (SPLIT) {
          const bf16* kl = sk_lo + (n * 8 + g) * LD + kk * 16 + t * 2;
          mma_bf16(s[n], a, ld32(kl), ld32(kl + 8));
          mma_bf16(s[n], al, b0, b1);
        }
      }
    }

    // Scale into the log2 domain and mask (suffix padding, causal).
#pragma unroll
    for (int n = 0; n < BLOCK_K / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t * 2 + (e & 1);
        const int qrow = row0 + (e >= 2 ? 8 : 0);
        const bool ok = key < n_kv && (!causal || key <= qrow);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
      }

    // Online softmax; the four threads of a group share a row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < BLOCK_K / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[r], mx);
      // A row with no valid key yet keeps m = -inf; subtract 0 instead so
      // every exp2 below is exp2(-inf) = 0 and never NaN.
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m_i[r] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < BLOCK_K / 8; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - m_use);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_use);
        rs += s[n][2 * r] + s[n][2 * r + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_i[r] = l_i[r] * alpha + rs;
      m_i[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V.  The accumulator layout of two adjacent 8-key tiles is the
    // A-operand layout of one 16-key step, so P never leaves registers.
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      uint32_t a[4], al[4];
      if constexpr (SPLIT) {
        split_pack(s[2 * kk][0], s[2 * kk][1], a[0], al[0]);
        split_pack(s[2 * kk][2], s[2 * kk][3], a[1], al[1]);
        split_pack(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], al[2]);
        split_pack(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], al[3]);
      } else {
        a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vr = sv + (kk * 16 + t * 2) * LD + n * 8 + g;
        const uint32_t b0 = pack_rows(vr, LD);
        const uint32_t b1 = pack_rows(vr + 8 * LD, LD);
        mma_bf16(acc[n], a, b0, b1);
        if constexpr (SPLIT) {
          const bf16* vl = sv_lo + (kk * 16 + t * 2) * LD + n * 8 + g;
          mma_bf16(acc[n], a, pack_rows(vl, LD), pack_rows(vl + 8 * LD, LD));
          mma_bf16(acc[n], al, b0, b1);
        }
      }
    }
  }

  // Normalize and store; a row whose normalizer is 0 had no valid key.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = row0 + 8 * r;
    if (qrow >= Lq) continue;
    const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
    T* orow = o + b * os.b + h * os.h + (long long)qrow * os.l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * r] * inv;
      const float x1 = acc[n][2 * r + 1] * inv;
      if constexpr (SPLIT) {
        *reinterpret_cast<float2*>(orow + n * 8 + t * 2) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + t * 2) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename T, int D, bool SPLIT>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_lengths, int B, int H, int Lq, int Lk, int causal,
           Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
           cudaStream_t stream) {
  const int smem = (SPLIT ? 6 : 3) * BLOCK_Q * (D + PAD) * (int)sizeof(bf16);
  auto kernel = flash_fwd_kernel<T, D, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BLOCK_Q - 1) / BLOCK_Q, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_lengths, H, Lq, Lk,
      causal, qs, ks, vs, os, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, bool SPLIT>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               const int* lens, int B, int H, int Lq, int Lk, int causal,
               Strides qs, Strides ks, Strides vs, Strides os, float sl2,
               cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64, SPLIT>(q, k, v, o, lens, B, H, Lq, Lk, causal, qs,
                                  ks, vs, os, sl2, st);
    case 128:
      return launch<T, 128, SPLIT>(q, k, v, o, lens, B, H, Lq, Lk, causal,
                                   qs, ks, vs, os, sl2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Strides are in elements, D-stride 1.
// kv_lengths may be null.  Returns the launch's cudaError_t as an int.
extern "C" int kfs_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    const void* kv_lengths, int B, int H, int Lq, int Lk, int D, int dtype,
    int causal, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, float scale, void* stream) {
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh},
      vs{v_sb, v_sl, v_sh}, os{o_sb, o_sl, o_sh};
  const float scale_log2 = scale * 1.4426950408889634f;
  const int* lens = static_cast<const int*>(kv_lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<bf16, false>(D, q, k, v, o, lens, B, H, Lq, Lk, causal,
                                   qs, ks, vs, os, scale_log2, st);
  if (dtype == 1)
    return dispatch_d<float, true>(D, q, k, v, o, lens, B, H, Lq, Lk, causal,
                                   qs, ks, vs, os, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}
