// Flash attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (kfserving_tpu_torch/ops/
// flash_attention.py).
//
// Replaces the Pallas TPU kernel kfserving_tpu/ops/pallas_attention.py::
// flash_attention (body _flash_kernel): softmax(Q K^T / sqrt(D)) V over
// [B, L, H, D] tensors with an online softmax, fp32 running max, normalizer
// and accumulator, optional causal masking (query i at position i) and
// optional per-row kv_lengths (suffix key padding; key tiles past a row's
// length are skipped).  Rows with no valid key give 0.
//
// What bounds it on an H100.  The work is 4 * D operations per (query, key)
// pair against 2 * D * itemsize bytes per query and per key row, so the
// operations per byte grow with the keys a query attends: at the decoder's
// b8 x 4096 causal prefill (D = 64) they are ~1000x the bytes and the
// tensor cores bound the call (989 TFLOP/s bf16); at BERT's buckets
// (L <= 512) the two roofs are within a few x of each other and each call
// lasts tens of microseconds, so latency and the tile pipeline's fill and
// drain matter as much as either roof.
//
// bf16 path (D = 64, 128, 192 and 256): one thread block of three
// warpgroups per 128-query tile of one (b, h) (two at D = 256, below).
//   - Warpgroup 0 is the producer.  It gives most of its registers to the
//     consumers (setmaxnreg) and one thread issues TMA loads: the Q tile
//     once, then K and V tiles of BLOCK_K keys (128 up to D = 128, 64 at
//     D = 192 and 256, where two 128-key stages beside Q overflow the 227
//     KB) into a ring of STAGES buffers guarded by full / empty mbarriers.
//     It stops at the row's last valid tile, so the causal skip and the
//     kv_lengths skip move no bytes.  Tensor maps are built on the host
//     from the wrapper's element strides, with a 128-byte swizzle; a head
//     loads as D / 64 boxes of 64 columns.
//     TMA zero-fills rows past L, so short or ragged L needs no other path.
//   - Warpgroups 1 and 2 each own 64 query rows (one wgmma M).  S = Q K^T is
//     a wgmma with both operands in shared memory, K-major, whose
//     descriptors use the same 128-byte swizzle as the TMA boxes.  The
//     online softmax runs in fp32 registers with exp2; the causal and
//     length masks are applied only on the tiles that cross the diagonal or
//     a row's length.  P is rounded to bf16 in registers and is the
//     register-A operand of O += P V, whose B operand is the V tile read
//     MN-major (transposed) straight from the ring: no transpose copy.
//   - At D = 256 a consumer's O is 128 fp32 registers a thread, which
//     spilled under the 168 that a block of 12 warps leaves each thread
//     (setmaxnreg did not lift ptxas's allocation), so the block is the
//     two consumer warpgroups alone (255 registers) and their first thread
//     issues the loads: Q and the first STAGES tiles up front, then each
//     stage again once both warpgroups have released it.
//   - Causal grids issue the heaviest q tiles (those with the most key
//     tiles) first, for every (b, h), so the tail of the grid is short.
//   - Producer and consumers take their trip count from one function; a
//     tile with no keys skips every barrier wait on both sides.
// Each consumer warpgroup runs Q K^T, softmax and P V in turn, and nothing
// orders the two warpgroups, so one's softmax can overlap the other's
// products.  At D = 64 a tile's exp2 work on the special-function units
// (16 a clock per SM) takes as long as its two products on the tensor
// cores, so this overlap is what bounds the kernel.  Two tighter schedules
// were tried on the H100 and were slower at every checked shape: issuing
// tile j's Q K^T with tile j-1's P V so the softmax overlaps P V inside a
// warpgroup (and at D = 128 it spills under the 168-register cap that
// three warpgroups impose), and a named-barrier ping-pong that makes the
// warpgroups take turns on the tensor cores.  No persistent grid yet; rows
// of Q past a row's length are computed (as by the plain version) and
// stored.
//
// mma.sync path (fp32 at every head dim, bf16 at D = 16, 32, 80 and 96):
// the first version's m16n8k16 kernel, templated on the element type.  fp32
// inputs are split into bf16 hi + lo halves and multiplied as hi*hi + hi*lo
// + lo*hi (about 16 mantissa bits).  wgmma's tf32 form needs a K-major B
// operand, which V (keys by head dim, head dim contiguous) is not, and no
// served path runs fp32, so this path keeps synchronous 64 x 64 tiles (at
// D = 256 fp32 its six tiles take 203 KB).  The wgmma path's TMA boxes and
// descriptors are built on 64-column panels of 128-byte swizzled rows, so
// bf16 head dims that are not a multiple of 64 take this path with bf16
// tiles loaded as they are: one product a step, P rounded to bf16 before
// P V.  At D = 16 and 32 (bert_tiny, decoder_tiny, vit_tiny) a call moves
// few bytes and does few operations, so launch latency bounds it; at D =
// 80 (ViT-H/14, Phi-2) and 96 (GPT-NeoX-20B) the synchronous loads and
// mma.sync keep it off the tensor cores' wgmma rate.  Simple and right
// first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, l, h;  // elements; the D axis has stride 1
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats -> one register of two bf16 (the lower column in the low half).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// ---------------------------------------------------------------------------
// mma.sync path: fp32 at every head dim (bf16 hi + lo halves), and bf16 at
// the head dims the wgmma path does not take (16, 32, 80 and 96).

constexpr int F32_BLOCK_Q = 64;
constexpr int F32_THREADS = 128;  // four warps, 16 query rows each

// Keys of one step: 64, or 32 for fp32 at D = 256, where a thread's share
// of the 64 x 256 O (128 registers) beside a 64-key S and the split
// operands overflows the 255 registers a thread may have (ptxas spilled).
template <typename T, int D>
__host__ __device__ constexpr int mma_block_k() {
  return sizeof(T) == 4 && D >= 256 ? 32 : 64;
}
// Row padding of the shared-memory tiles, in bf16 elements (16 bytes):
// staggers rows across banks so the fragment loads below are conflict-free.
constexpr int PAD = 8;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Copies a [ROWS, D] tile (rows past `rows_valid` zero-filled) into shared
// memory: fp32 as bf16 hi and lo halves, bf16 as it is (`lo` unused).
template <typename T, int D, int ROWS>
__device__ void load_tile(bf16* hi, bf16* lo, const T* base,
                          long long stride_l, int rows_valid) {
  constexpr int LD = D + PAD;
  if constexpr (sizeof(T) == 4) {
    constexpr int CPR = D / 4;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * CPR; i += F32_THREADS) {
      const int r = i / CPR;
      const int c = (i % CPR) * 4;
      uint2 h = make_uint2(0u, 0u), l = make_uint2(0u, 0u);
      if (r < rows_valid) {
        const float4 f =
            *reinterpret_cast<const float4*>(base + r * stride_l + c);
        split_pack(f.x, f.y, h.x, l.x);
        split_pack(f.z, f.w, h.y, l.y);
      }
      *reinterpret_cast<uint2*>(hi + r * LD + c) = h;
      *reinterpret_cast<uint2*>(lo + r * LD + c) = l;
    }
  } else {
    constexpr int CPR = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * CPR; i += F32_THREADS) {
      const int r = i / CPR;
      const int c = (i % CPR) * 8;
      uint4 h = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid)
        h = *reinterpret_cast<const uint4*>(base + r * stride_l + c);
      *reinterpret_cast<uint4*>(hi + r * LD + c) = h;
    }
  }
}

// One 64-query tile of one (b, h) per thread block.  T = float: every
// product is hi*hi + hi*lo + lo*hi over the split halves (about 16
// mantissa bits); T = bf16: one product per step, P rounded to bf16 before
// P V as in the wgmma path.
template <typename T, int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int* __restrict__ kv_lengths, int H, int Lq, int Lk,
                  int causal, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale_log2) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int F32_BLOCK_K = mma_block_k<T, D>();
  constexpr int LD = D + PAD;
  constexpr int Q_TILE = F32_BLOCK_Q * LD;
  constexpr int KV_TILE = F32_BLOCK_K * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + Q_TILE;
  bf16* sv = sk + KV_TILE;
  // The lo halves exist only for fp32 (the launch sizes shared memory to
  // match); a bf16 launch never touches them.
  bf16* sq_lo = sv + KV_TILE;
  bf16* sk_lo = sq_lo + Q_TILE;
  bf16* sv_lo = sk_lo + KV_TILE;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * F32_BLOCK_Q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  int n_kv = Lk;
  if (kv_lengths != nullptr) n_kv = min(max(kv_lengths[b], 0), Lk);
  int kv_end = n_kv;
  // Keys past the tile's last query row never attend (causal skip).
  if (causal) kv_end = min(kv_end, q0 + F32_BLOCK_Q);

  const T* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.l;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, D, F32_BLOCK_Q>(sq, sq_lo, qb, qs.l,
                              min(F32_BLOCK_Q, Lq - q0));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp
  float l_i[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;
  const int wrow = warp * 16 + g;

  for (int k0 = 0; k0 < kv_end; k0 += F32_BLOCK_K) {
    __syncthreads();  // the previous tile's readers are done
    const int rows = min(F32_BLOCK_K, Lk - k0);
    load_tile<T, D, F32_BLOCK_K>(sk, sk_lo, kb + (long long)k0 * ks.l,
                                 ks.l, rows);
    load_tile<T, D, F32_BLOCK_K>(sv, sv_lo, vb + (long long)k0 * vs.l,
                                 vs.l, rows);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x F32_BLOCK_K keys.
    float s[F32_BLOCK_K / 8][4];
#pragma unroll
    for (int n = 0; n < F32_BLOCK_K / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qr = sq + wrow * LD + kk * 16 + t * 2;
      const uint32_t a[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8),
                             ld32(qr + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < F32_BLOCK_K / 8; ++n) {
        const bf16* kr = sk + (n * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t b0 = ld32(kr), b1 = ld32(kr + 8);
        mma_bf16(s[n], a, b0, b1);
        if constexpr (kSplit) {
          const bf16* ql = sq_lo + wrow * LD + kk * 16 + t * 2;
          const uint32_t al[4] = {ld32(ql), ld32(ql + 8 * LD), ld32(ql + 8),
                                  ld32(ql + 8 * LD + 8)};
          const bf16* kl = sk_lo + (n * 8 + g) * LD + kk * 16 + t * 2;
          mma_bf16(s[n], a, ld32(kl), ld32(kl + 8));
          mma_bf16(s[n], al, b0, b1);
        }
      }
    }

    // Scale into the log2 domain and mask (suffix padding, causal).
#pragma unroll
    for (int n = 0; n < F32_BLOCK_K / 8; ++n)
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
      for (int n = 0; n < F32_BLOCK_K / 8; ++n)
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
      for (int n = 0; n < F32_BLOCK_K / 8; ++n) {
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
    for (int kk = 0; kk < F32_BLOCK_K / 16; ++kk) {
      uint32_t a[4], al[4];
      if constexpr (kSplit) {
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
        if constexpr (kSplit) {
          const bf16* vl = sv_lo + (kk * 16 + t * 2) * LD + n * 8 + g;
          mma_bf16(acc[n], a, pack_rows(vl, LD),
                   pack_rows(vl + 8 * LD, LD));
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
      const float x0 = acc[n][2 * r] * inv, x1 = acc[n][2 * r + 1] * inv;
      if constexpr (kSplit)
        *reinterpret_cast<float2*>(orow + n * 8 + t * 2) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + t * 2) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path: TMA ring + wgmma, warp-specialized.

constexpr int BLOCK_Q = 128;   // query rows per thread block
constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;   // warpgroups of 64 query rows each
// A swizzle row: 64 bf16 = 128 bytes; a tile is stored as panels of
// [rows][64] with the 128-byte swizzle, one panel per 64 head-dim columns.
constexpr int SW_COLS = 64;
constexpr int SW_ROW_BYTES = 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(WG_THREADS * PRODUCER_REGS + CONSUMERS * WG_THREADS *
                  CONSUMER_REGS <= 65536,
              "register split exceeds the SM's file");

template <int D>
struct WgCfg {
  static constexpr int PANELS = D / SW_COLS;
  // Keys per ring stage: 128 up to D = 128.  At D = 192 and 256 a
  // 128-key K and V stage is 96-128 KB, so two of them beside Q (48-64
  // KB) overflow a CTA's 227 KB: 64 keys there.
  static constexpr int BLOCK_K = D <= 128 ? 128 : 64;
  // The loads: a producer warpgroup ahead of the consumers that hands
  // them its registers (setmaxnreg), or at D = 256 the first consumer
  // thread between its tiles.  ptxas allocates the whole kernel under its
  // launch bound, and each of an SM's four register banks (16K) holds
  // every fourth warp: 12 warps leave 168 registers a thread (9 warps
  // too, on the SMSP that holds three), and a D = 256 consumer holds a
  // 64 x 256 fp32 O (128 registers) beside S, P and the operand
  // descriptors, so it spilled there.  The two consumer warpgroups alone
  // (8 warps) allow 255.
  static constexpr bool PRODUCER_WG = D <= 192;
  static constexpr int THREADS =
      CONSUMERS * WG_THREADS + (PRODUCER_WG ? WG_THREADS : 0);
  static constexpr int FIRST_CONSUMER = PRODUCER_WG ? WG_THREADS : 0;
  static constexpr int S_REGS = BLOCK_K / 2;  // S floats of one thread
  static constexpr int K_STEPS = BLOCK_K / 16;  // k16 steps of P V
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int Q_PANEL = BLOCK_Q * SW_ROW_BYTES;
  static constexpr int KV_PANEL = BLOCK_K * SW_ROW_BYTES;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or V tile
  static constexpr int BARRIERS = 1 + 3 * STAGES;     // q, k/v full, empty
  // 1024 bytes of slack align the tiles to the swizzle pattern's repeat.
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  static_assert(D % SW_COLS == 0, "the wgmma path takes 64-column panels");
  static_assert(SMEM <= 232448, "over a CTA's 227 KB of shared memory");
};

// TMA: one box of the 4-d tensor map (d, h, l, b) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int l,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(l),
      "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
// The stride offset steps 8 rows of the operand's outer dimension (1024
// bytes).  K-major (Q, K): a 16-deep slice lies inside one 128-byte row, so
// the leading offset is unused (1, as CUTLASS sets it).  MN-major (V, 64
// columns wide): the leading offset would step to the next 64 columns,
// which a 64-wide product never does; it is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t leading) {
  constexpr uint64_t kStride = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)leading << 16) |
         (kStride << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 1);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 1024 >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16, bf16 operands, fp32 accumulators (all 64 x N floats
// of D spread over the warpgroup's 128 threads, N / 2 each).

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (both K-major, 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], as wgmma_ss_n128 (the S tile
// of a 64-key stage).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs),
// B from shared memory MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The number of key tiles of BK keys a query tile reads: keys up to the
// row's length and, for causal calls, up to the tile's last query row.  The
// producer and the consumers both take their trip count from here, so
// their barrier waits always pair up; 0 means no load and no wait.
template <int BK>
__device__ __forceinline__ int kv_tile_count(int q0, int n_kv, int causal) {
  const int kv_end = causal ? min(n_kv, q0 + BLOCK_Q) : n_kv;
  return kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
}

// S = Q K^T for one warpgroup's 64 query rows and one key tile (issued,
// not waited for): D / 16 steps of 16 head-dim columns, 32 bytes of a
// swizzled row each, a new panel every 64 columns.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[WgCfg<D>::S_REGS],
                                         uint32_t q_half, uint32_t k_tile) {
  using C = WgCfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        kmajor_desc(q_half + (kk / 4) * C::Q_PANEL + (kk % 4) * 32);
    const uint64_t db =
        kmajor_desc(k_tile + (kk / 4) * C::KV_PANEL + (kk % 4) * 32);
    if constexpr (C::BLOCK_K == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// O += P V (issued, not waited for).  V [keys][head dim] is the MN-major B
// operand; a k16 step is 16 swizzled rows (2048 bytes) of each 64-column
// panel.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / SW_COLS][32],
    const uint32_t (&pa)[WgCfg<D>::K_STEPS][4], uint32_t v_tile) {
  using C = WgCfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::K_STEPS; ++kk)
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      wgmma_rs_n64(acc[p], pa[kk],
                   mnmajor_desc(v_tile + p * C::KV_PANEL +
                                kk * 16 * SW_ROW_BYTES));
}

// One S tile of BK keys through the online softmax, in place: masks (when
// `masked`), exponentiates in the log2 domain, updates the running max and
// this thread's partial sums, and returns the factor each of its two rows'
// earlier O must be scaled by.  The four threads of a group share a row.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m_i)[2],
                                             float (&l_i)[2],
                                             float (&alpha)[2], bool masked,
                                             int k0, int n_kv, int causal,
                                             int row0, int t,
                                             float scale_log2) {
  constexpr int N8 = BK / 8;  // n8 blocks of the tile
  if (masked) {
#pragma unroll
    for (int i = 0; i < N8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + i * 8 + t * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (key >= n_kv || (causal && key > row)) s[i * 4 + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m_i[r];
#pragma unroll
    for (int i = 0; i < N8; ++i)
      mx = fmaxf(mx, fmaxf(s[i * 4 + 2 * r], s[i * 4 + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // A row with no valid key yet keeps m = -inf; subtract 0 instead so
    // every exp2 below is exp2(-inf) = 0 and never NaN.
    const float m_use = (mx == -INFINITY) ? 0.f : mx * scale_log2;
    alpha[r] = exp2f(m_i[r] * scale_log2 - m_use);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < N8; ++i) {
      float& x0 = s[i * 4 + 2 * r];
      float& x1 = s[i * 4 + 2 * r + 1];
      x0 = exp2f(fmaf(x0, scale_log2, -m_use));
      x1 = exp2f(fmaf(x1, scale_log2, -m_use));
      rs += x0 + x1;
    }
    l_i[r] = l_i[r] * alpha[r] + rs;
    m_i[r] = mx;
  }
}

// P in bf16: the accumulator layout of keys 16kk..16kk+15 (two n8 blocks)
// is the register-A layout of one k16 step.
template <int BK>
__device__ __forceinline__ void to_bf16(const float (&s)[BK / 2],
                                        uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, const int* __restrict__ kv_lengths,
                    int H, int Lq, int Lk, int causal, Strides os,
                    float scale_log2) {
  using C = WgCfg<D>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t sq = (smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t sk = sq + C::Q_BYTES;
  const uint32_t sv = sk + C::STAGES * C::KV_BYTES;
  const uint32_t bars = sv + C::STAGES * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + C::STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * C::STAGES + s); };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // The last q tiles read the most key tiles under a causal mask; the grid
  // runs blockIdx.y in order, so they go first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_Q;
  int n_kv = Lk;
  if (kv_lengths != nullptr) n_kv = min(max(kv_lengths[b], 0), Lk);
  const int n_tiles = kv_tile_count<C::BLOCK_K>(q0, n_kv, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * WG_THREADS / 32);  // one per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The loads of Q, and of key tile j into stage j % STAGES (which tile
  // j - STAGES filled: the caller waits for both consumers to release
  // it first).
  auto load_q = [&]() {
    mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      tma_load(sq + p * C::Q_PANEL, &tq, q_full, p * SW_COLS, h, q0, b);
  };
  auto load_kv = [&](int j) {
    const int s = j % C::STAGES;
    const int k0 = j * C::BLOCK_K;
    mbar_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      tma_load(sk + s * C::KV_BYTES + p * C::KV_PANEL, &tk, k_full(s),
               p * SW_COLS, h, k0, b);
    mbar_expect_tx(v_full(s), C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      tma_load(sv + s * C::KV_BYTES + p * C::KV_PANEL, &tv, v_full(s),
               p * SW_COLS, h, k0, b);
  };

  const int consumer_thread = threadIdx.x - C::FIRST_CONSUMER;
  if (consumer_thread < 0) {
    // Producer warpgroup: one thread issues every load.
    if constexpr (C::PRODUCER_WG) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   ::"n"(PRODUCER_REGS));
      if (threadIdx.x == 0 && n_tiles > 0) {
        load_q();
        for (int j = 0; j < n_tiles; ++j) {
          if (j >= C::STAGES)
            mbar_wait(empty(j % C::STAGES), ((j / C::STAGES) - 1) & 1);
          load_kv(j);
        }
      }
    }
  } else {
    if constexpr (C::PRODUCER_WG) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   ::"n"(CONSUMER_REGS));
    } else if (threadIdx.x == 0 && n_tiles > 0) {
      // No producer: the first STAGES tiles now, the rest in the loop.
      load_q();
      for (int j = 0; j < min(n_tiles, C::STAGES); ++j) load_kv(j);
    }
    const int c = consumer_thread / WG_THREADS;  // 64-row half of the tile
    const int warp = (threadIdx.x / 32) % 4;     // 16-row slice of the half
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int first_row = q0 + c * 64;
    const int row0 = first_row + warp * 16 + g;  // rows row0 and row0 + 8

    // O: one 64-column panel of 32 floats per 64 head-dim columns.
    float acc[C::PANELS][32];
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};  // running max, raw score units
    float l_i[2] = {0.f, 0.f};              // this thread's partial sums
    float alpha[2];
    float s[C::S_REGS];                     // S tile: 64 rows x BLOCK_K
#pragma unroll
    for (int i = 0; i < C::S_REGS; ++i) s[i] = 0.f;
    uint32_t pa[C::K_STEPS][4];             // P in bf16
    const uint32_t q_half = sq + c * 64 * SW_ROW_BYTES;
    // Masks only on a tile that crosses a row's length or (causal) the
    // diagonal of this warpgroup's rows.
    auto masked = [&](int k0) {
      return k0 + C::BLOCK_K > n_kv ||
             (causal && k0 + C::BLOCK_K - 1 > first_row);
    };
    auto fence_acc = [&]() {
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p) fence_regs(acc[p]);
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % C::STAGES;
      const uint32_t phase = (j / C::STAGES) & 1;
      mbar_wait(k_full(st), phase);
      fence_regs(s);
      wgmma_fence();
      issue_qk<D>(s, q_half, sk + st * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      const int k0 = j * C::BLOCK_K;
      softmax_tile<C::BLOCK_K>(s, m_i, l_i, alpha, masked(k0), k0, n_kv,
                               causal, row0, t, scale_log2);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[p][i * 4 + 2 * r] *= alpha[r];
            acc[p][i * 4 + 2 * r + 1] *= alpha[r];
          }
      to_bf16<C::BLOCK_K>(s, pa);
      mbar_wait(v_full(st), phase);
      fence_acc();
      wgmma_fence();
      issue_pv<D>(acc, pa, sv + st * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc();
      release(st);
      if constexpr (!C::PRODUCER_WG) {
        // Refill this stage once both consumers have released it.
        if (threadIdx.x == 0 && j + C::STAGES < n_tiles) {
          mbar_wait(empty(st), phase);
          load_kv(j + C::STAGES);
        }
        __syncwarp();
      }
    }

    // Normalize and store; a row whose normalizer is 0 had no valid key.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= Lq) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* orow = o + b * os.b + h * os.h + (long long)row * os.l;
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(orow + p * SW_COLS + i * 8 +
                                             t * 2) =
              __floats2bfloat162_rn(acc[p][i * 4 + 2 * r] * inv,
                                    acc[p][i * 4 + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Returned for a failed tensor-map encoding: kTensorMapError + CUresult.
constexpr int kTensorMapError = 10000;

// A 4-d map over one bf16 [B, L, H, D] operand, dims (d, h, l, b) innermost
// first, in boxes of 64 head-dim columns x `rows` positions, 128-byte
// swizzle.  Positions past L read as zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
               Strides st, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // A size-1 axis is never stepped; give it a stride TMA accepts whatever
  // the view reports.
  const long long sh = H > 1 ? st.h : D;
  const long long sb = B > 1 ? st.b : (long long)L * H * D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st.l * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SW_COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const int* kv_lengths, int B, int H, int Lq, int Lk,
                int causal, Strides qs, Strides ks, Strides vs, Strides os,
                float scale_log2, cudaStream_t stream) {
  using C = WgCfg<D>;
  auto kernel = flash_fwd_wgmma<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, B, Lq, H, D, qs, BLOCK_Q);
  if (err == 0) err = tensor_map(&tk, k, B, Lk, H, D, ks, C::BLOCK_K);
  if (err == 0) err = tensor_map(&tv, v, B, Lk, H, D, vs, C::BLOCK_K);
  if (err != 0) return err;
  const dim3 grid(B * H, (Lq + BLOCK_Q - 1) / BLOCK_Q);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), kv_lengths, H, Lq, Lk, causal, os,
      scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const int* kv_lengths, int B, int H, int Lq, int Lk,
               int causal, Strides qs, Strides ks, Strides vs, Strides os,
               float scale_log2, cudaStream_t stream) {
  // Q, K and V tiles, plus their lo halves for fp32.
  constexpr int halves = sizeof(T) == 4 ? 2 : 1;
  constexpr int smem = halves * (F32_BLOCK_Q + 2 * mma_block_k<T, D>()) *
                       (D + PAD) * (int)sizeof(bf16);
  static_assert(smem <= 232448, "over a CTA's 227 KB of shared memory");
  auto kernel = flash_fwd_mma<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Lq + F32_BLOCK_Q - 1) / F32_BLOCK_Q, B * H);
  kernel<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_lengths, H, Lq, Lk,
      causal, qs, ks, vs, os, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Strides are in elements, D-stride 1.
// kv_lengths may be null.  Returns the launch's cudaError_t as an int, or
// 10000 + the CUresult of a tensor map the driver refused.
extern "C" int kfs_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    const void* kv_lengths, int B, int H, int Lq, int Lk, int D, int dtype,
    int causal, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, float scale, void* stream) {
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh},
      vs{v_sb, v_sl, v_sh}, os{o_sb, o_sl, o_sh};
  const float sl2 = scale * 1.4426950408889634f;
  const int* lens = static_cast<const int*>(kv_lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KFS_ARGS q, k, v, o, lens, B, H, Lq, Lk, causal, qs, ks, vs, os, sl2, st
  // The paths by (dtype, D): ops/flash_attention.py::kernel_path.
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_mma<bf16, 16>(KFS_ARGS);
      case 32: return launch_mma<bf16, 32>(KFS_ARGS);
      case 64: return launch_bf16<64>(KFS_ARGS);
      case 80: return launch_mma<bf16, 80>(KFS_ARGS);
      case 96: return launch_mma<bf16, 96>(KFS_ARGS);
      case 128: return launch_bf16<128>(KFS_ARGS);
      case 192: return launch_bf16<192>(KFS_ARGS);
      case 256: return launch_bf16<256>(KFS_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_mma<float, 16>(KFS_ARGS);
      case 32: return launch_mma<float, 32>(KFS_ARGS);
      case 64: return launch_mma<float, 64>(KFS_ARGS);
      case 80: return launch_mma<float, 80>(KFS_ARGS);
      case 96: return launch_mma<float, 96>(KFS_ARGS);
      case 128: return launch_mma<float, 128>(KFS_ARGS);
      case 192: return launch_mma<float, 192>(KFS_ARGS);
      case 256: return launch_mma<float, 256>(KFS_ARGS);
    }
  }
#undef KFS_ARGS
  return (int)cudaErrorInvalidValue;
}
