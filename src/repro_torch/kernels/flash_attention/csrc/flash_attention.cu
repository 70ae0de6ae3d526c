// Flash attention for Hopper (sm_90a): the forward with its logsumexp, and
// the backward as a dq kernel and a dk/dv kernel.
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/flash_attention/
// flash_attention.py:
//   flash_attention_kernel      (_kernel, pallas_call grid (B, H, Sq/bq,
//                                Skv/bk) with the KV axis sequential)
//   flash_attention_bwd_kernel  (_dq_kernel over (B, H, Sq/bq, Skv/bk) and
//                                _dkv_kernel over (B, K, Skv/bk, G*Sq/bq))
//
// Computes, for q (B,Sq,H,hd), k/v (B,Skv,K,hd), query head h reading KV
// head h / (H/K), scale = hd^-0.5 and the mask
//   valid(i, j) = j < Skv  and, when causal, j <= i + (Skv - Sq) and, with a
//                 window w > 0, j > i + (Skv - Sq) - w,
//   out[b,i,h] = sum_j p_ij v[b,j],  p_ij = exp(s_ij - lse_i) on valid (i, j),
//   s_ij = scale * q[b,i,h] . k[b,j],  lse_i = m_i + log(max(l_i, 1e-30)),
// so a row with no valid key gives out = 0 (the TPU kernel's max(l, 1e-30)).
// The backward recomputes p from lse as where(valid, exp(s - lse), 0), the
// `where` after the exp, and takes delta_i = sum_d dO.O (computed outside, as
// the TPU wrapper leaves it to XLA):
//   dv_j = sum_i p_ij dO_i,  ds_ij = p_ij (dO_i . v_j - delta_i),
//   dq_i = scale sum_j ds_ij k_j,  dk_j = scale sum_i ds_ij q_i,
// dk/dv summed over the G query heads of each KV head.
//
// What bounds it on this card: operations.  At the training shape (fed-100m,
// B=8, S=256, H=12, K=4, hd=64, causal) the forward needs ~0.81 GFLOP on
// ~17 MB of operands (~48 flop/byte, above the f32 ridge of ~20), the
// backward 2.5x the flops; f32 operands must not go through TF32 tensor
// cores (the parity tolerance is 2e-5), so the ceiling is the 67 TFLOP/s of
// f32 FMAs.  bf16 operands take the same f32 path here; tensor-core
// (wgmma) tiles are later work.
//
// What the design does about it: every kernel is built from one
// micro-kernel.  Blocks of 128 threads; thread t owns rows tr + 16i (i < 4)
// and columns tc + 8j (j < 8) of a 64x64 score tile (tr = t / 8,
// tc = t % 8) and channels 4tc + 32h + e (e < 4) of a 64 x hd output tile,
// so one 16-byte shared-memory read feeds 8 or more FMAs.  Operand tiles
// are staged as f32 [row][channel] with rows of hd + 4 floats (the 8
// threads of a quarter warp read 8 rows tc + 8j at one channel, which lie
// on 8 different 16-byte bank groups, or one row: a broadcast); score
// tiles are [row][column] with rows of 72 floats, so a warp's 32 scalar
// stores hit 32 banks.  Tiles arrive by 16-byte cp.async while the tile
// before them is computed.  s, p and dp stay in registers through the max,
// the exp and ds; only the operand of a transposed product is staged.
// * Forward: one block per (64-row tile, head, batch row), two blocks an
//   SM, q tiles launched last first (under a causal band the last is the
//   heaviest).  The TPU's sequential grid axis becomes a loop inside the
//   block over only the k tiles that intersect the causal/window band (the
//   TPU kernel's _band), so causal attention does half the tile products.
//   K and V tiles are double-buffered: the next band tile's K and V are in
//   flight while the current one is computed.  Per k tile: s = q k^T
//   (registers), the online softmax in registers (row max and sum over the
//   8 lanes that share a row, by shuffles; the mask only on tiles the band
//   cuts), p staged once as the operand of o += p v.  The online-softmax
//   state stays in registers in f32.
// * dq: one block per (64-row tile, head, batch row), q tiles launched last
//   first, two blocks an SM; the next K tile and the V tile load while the
//   current products run.
// * dk/dv: a thread-block cluster per (64-key tile, KV head, batch row),
//   one block per query head of the group (min(G, 8) blocks; with G > 8 a
//   block takes heads rank, rank + 8, ...).  Each block sums its heads'
//   band q tiles in registers; the cluster then adds the blocks' partials
//   through distributed shared memory in rank order.  No atomics: out, lse,
//   dq, dk and dv are bitwise the same from call to call.
// * Head dims 64, 120, 128 and 256.  A head dim that is no multiple of 32
//   (120, h2o-danube-3-4b's) computes at the next multiple (128): rows are read
//   and written at 120 channels in device memory (480 or 240 bytes, whole
//   16-byte reads), staged into tiles of 128 + 4 floats, q.k sums the 120
//   real channels, and the products over a staged tile carry 8 pad columns
//   in registers that no store reads, about 128/120 of the exact FMAs.
//   Shared memory and registers are those of head dim 128.
// * Head dim 256 (recurrentgemma-2b's) computes on 32-row tiles, every other
//   head dim on 64-row ones (Geo<HD>::kT; the 64-row code is the same code
//   with kT = 64, so its results are bit for bit those of the 64-only
//   kernels).  At 64 rows, HD 256 would stage five f32 tiles of 64 x 260
//   floats (333 KB) where a block may have 227 KB, hold 4 x 32 = 128
//   accumulators a thread (256 in dk/dv) and a dk/dv partial of
//   2 x 64 x 256 floats (128 KB).  At 32 rows a thread owns rows tr + 16i
//   (i < 2) and score columns tc + 8j (j < 4): five tiles of 32 x 260 floats
//   plus a 32 x 40 score tile are 171.5 KB (one block an SM), the
//   accumulators 2 x 32 = 64 floats a thread (128 in dk/dv, which ptxas
//   fits in 255 registers with spills of the size hd 120 and 128 already
//   have), and the partial 2 x 32 x 256 floats = 64 KB, which fits in the
//   freed tile buffers.  Each K/V tile then serves 32 query rows
//   instead of 64: twice the K/V traffic from L2 per query row, which at
//   hd 256 the 4x larger products per tile still cover.
// * q/k/v/dO are read in the model's (B,S,heads,hd) layout through their
//   strides: no transpose, no padding, no repeat of K/V for GQA.  The ragged
//   sequence edge is masked inside the kernel by the real lengths.  Rows
//   that are not 16-byte aligned take the scalar route of the same kernels
//   (one element a copy), chosen by the caller: flash_fwd_scalar_launch,
//   flash_dq_scalar_launch, flash_dkv_scalar_launch.
//
// Each entry point launches on the given stream and returns the
// cudaError_t of the launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxTile = 64;     // query rows and keys per tile, at most
constexpr int kThreads = 128;    // threads of every block
constexpr float kNegInf = -1e30f;

struct Band {
  int causal, window, q_off, skv;
  // does the (q tile, k tile) pair of T-row tiles hold any (query, key) of
  // the band?
  template <int T>
  __device__ __forceinline__ bool tiles(int q_first, int k_first) const {
    if (causal) {
      if (k_first > q_first + q_off + T - 1) return false;
      if (window && k_first + T - 1 <= q_first + q_off - window)
        return false;
    }
    return true;
  }
  // does every (query, key) of the pair lie in the band?  (rows past Sq are
  // never stored, so they need no mask)
  template <int T>
  __device__ __forceinline__ bool full(int q_first, int k_first) const {
    if (k_first + T > skv) return false;
    if (!causal) return true;
    return k_first + T - 1 <= q_first + q_off &&
           (window == 0 || k_first > q_first + q_off + T - 1 - window);
  }
  // element mask for query row qi (sequence index) and key kj
  __device__ __forceinline__ bool valid(int qi, int kj) const {
    if (kj >= skv) return false;
    if (!causal) return true;
    const int qpos = qi + q_off;
    return kj <= qpos && (window == 0 || kj > qpos - window);
  }
};

// reductions over the 8 lanes that share a score-tile row (tc = 0..7)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// the micro-kernel's pieces, shared by the forward and the backward
// ---------------------------------------------------------------------------

// HD channels live in device memory; the tiles hold and compute kPD = HD
// rounded up to 32.  Staging writes channels [0, HD) of a row; zero_pad
// zeroes [HD, kPD) once at block start, so the pad stays zero: dot_rows
// sums channels [0, HD) only, and score_times' pad columns go to
// accumulators that are never stored.  Tiles have kT rows (queries or
// keys): 64, or 32 above head dim 128 (see the head comment).
template <int HD>
struct Geo {
  static_assert(HD % 8 == 0, "16-byte bf16 rows and float4 stores");
  static constexpr int kT = HD > 128 ? 32 : kMaxTile;  // rows of a tile
  static constexpr int kRI = kT / 16;         // rows tr + 16i of a thread
  static constexpr int kCJ = kT / 8;          // score columns tc + 8j
  static constexpr int kLdS = kT + 8;         // padded row of a score tile
  static constexpr int kPD = (HD + 31) / 32 * 32;  // computed channels
  static constexpr int kLd = kPD + 4;         // padded [row][channel] row
  static constexpr int kTileF = kT * kLd;     // floats of a staged tile
  static constexpr int kScoreF = kT * kLdS;
  static constexpr int kNH = kPD / 32;        // float4 channel groups
  static constexpr int kAcc = kPD / 8;        // accumulators of a row
  // is output channel group h (channels 4tc + 32h + e) inside HD?
  __device__ __forceinline__ static bool stored(int tc, int h) {
    return HD == kPD || 4 * tc + 32 * h < HD;
  }
  // forward: q, two k and two v stages, p.  dq: q, dO, two k stages, v,
  // ds.  dk/dv: k, v, two q stages, dO, p/ds, two lse stages and delta.
  static constexpr size_t kFwdSmem = sizeof(float) * (5 * kTileF + kScoreF);
  static constexpr size_t kDqSmem = sizeof(float) * (5 * kTileF + kScoreF);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (5 * kTileF + kScoreF + 3 * kT);
  static_assert(kDkvSmem <= 227 * 1024, "a block has at most 227 KB");
  static_assert(2 * kT * HD <= 5 * kTileF, "the dk/dv partial fits");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 4 or 16 bytes; !ok zero-fills the destination and reads
// nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [first, first + kT) of an (S, HD) slice with row stride `rs` into
// channels [0, HD) of a staged tile; rows at or beyond n are zero.  VEC:
// 16 bytes a read (f32 by cp.async, bf16 eight at a time through
// registers); else one element a read (f32 by cp.async, bf16 through
// registers).
template <typename T, int HD, bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long rs, int first, int n) {
  constexpr int kLd = Geo<HD>::kLd;
  constexpr int E = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kPerRow = HD / E;
  constexpr int kReads = Geo<HD>::kT * kPerRow;  // HD 120 bf16: 960
  static_assert(HD % E == 0, "whole reads per row");
#pragma unroll
  for (int i = 0; i < (kReads + kThreads - 1) / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    if (kReads % kThreads != 0 && e >= kReads) break;
    const int r = e / kPerRow, c = (e % kPerRow) * E;
    const bool ok = first + r < n;
    const T* p = ok ? src + (first + r) * rs + c : src;
    float* to = dst + r * kLd + c;
    if constexpr (sizeof(T) == 4) {
      if constexpr (VEC)
        cp_async16(to, p, ok);
      else
        cp_async4(to, p, ok);
    } else if constexpr (VEC) {
      const uint4 raw =
          ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h2[0]);
      const float2 f1 = __bfloat1622float2(h2[1]);
      const float2 f2 = __bfloat1622float2(h2[2]);
      const float2 f3 = __bfloat1622float2(h2[3]);
      *reinterpret_cast<float4*>(to) = make_float4(f0.x, f0.y, f1.x, f1.y);
      *reinterpret_cast<float4*>(to + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
    } else {
      *to = ok ? __bfloat162float(*p) : 0.f;
    }
  }
}

// channels [HD, kPD) of n staged tiles from dst to zero (none below HD
// 120's padded width); staging never writes them
template <int HD>
__device__ __forceinline__ void zero_pad(float* dst, int n) {
  using G = Geo<HD>;
  if constexpr (G::kPD > HD) {
    constexpr int kPer = (G::kPD - HD) / 4;  // float4 of a row's pad
    for (int e = static_cast<int>(threadIdx.x); e < n * G::kT * kPer;
         e += kThreads)
      *reinterpret_cast<float4*>(dst + (e / kPer) * G::kLd + HD +
                                 4 * (e % kPer)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// kT values src[first + i] (zero at or beyond n) into dst[i], by threads
// [lane0, lane0 + kT)
template <int kT>
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int first, int n, int lane0) {
  const int i = static_cast<int>(threadIdx.x) - lane0;
  if (i >= 0 && i < kT) {
    const bool ok = first + i < n;
    cp_async4(dst + i, ok ? src + first + i : src, ok);
  }
}

// acc[i][j] += a[tr + 16i] . b[tc + 8j]: rows of two staged tiles dotted
// over their HD channels, 12 16-byte reads for 128 FMAs (64-row tiles)
template <int HD>
__device__ __forceinline__ void dot_rows(
    float (&acc)[Geo<HD>::kRI][Geo<HD>::kCJ], const float* __restrict__ a,
    const float* __restrict__ b) {
  using G = Geo<HD>;
  constexpr int kLd = G::kLd;
  const float* pa = a + (threadIdx.x >> 3) * kLd;
  const float* pb = b + (threadIdx.x & 7) * kLd;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[G::kRI], bv[G::kCJ];
#pragma unroll
    for (int i = 0; i < G::kRI; ++i)
      av[i] = *reinterpret_cast<const float4*>(pa + 16 * i * kLd + d);
#pragma unroll
    for (int j = 0; j < G::kCJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(pb + 8 * j * kLd + d);
#pragma unroll
    for (int i = 0; i < G::kRI; ++i)
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        acc[i][j] = fmaf(av[i].w, bv[j].w, s);
      }
  }
}

// acc[i][4h + e] += sum_c s[tr + 16i][c] m[c][4tc + 32h + e]: a staged
// score tile times a staged tile over its kPD channels, (4 + 4 kPD/32)
// 16-byte reads for 4 x 4 x kPD/8 FMAs
template <int HD>
__device__ __forceinline__ void score_times(
    float (&acc)[Geo<HD>::kRI][Geo<HD>::kAcc], const float* __restrict__ s,
    const float* __restrict__ m) {
  using G = Geo<HD>;
  constexpr int kLd = G::kLd, kNH = G::kNH, kLdS = G::kLdS;
  const float* ps = s + (threadIdx.x >> 3) * kLdS;
  const float* pm = m + 4 * (threadIdx.x & 7);
#pragma unroll 2
  for (int c = 0; c < G::kT; c += 4) {
    float4 sv[G::kRI];
#pragma unroll
    for (int i = 0; i < G::kRI; ++i)
      sv[i] = *reinterpret_cast<const float4*>(ps + 16 * i * kLdS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float4 mv[kNH];
#pragma unroll
      for (int h = 0; h < kNH; ++h)
        mv[h] = *reinterpret_cast<const float4*>(pm + (c + cc) * kLd + 32 * h);
#pragma unroll
      for (int i = 0; i < G::kRI; ++i) {
        const float a = cc == 0   ? sv[i].x
                        : cc == 1 ? sv[i].y
                        : cc == 2 ? sv[i].z
                                  : sv[i].w;
#pragma unroll
        for (int h = 0; h < kNH; ++h) {
          acc[i][4 * h] = fmaf(a, mv[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(a, mv[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(a, mv[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(a, mv[h].w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(a, b);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(c, d);
}

// the band's tiles along one axis: [lo, hi] of the n tiles t for which
// `hit(t)`; they are contiguous, and lo > hi when there are none
template <class F>
__device__ __forceinline__ int2 tile_range(int n, F hit) {
  int lo = 0, hi = n - 1;
  while (lo <= hi && !hit(lo)) ++lo;
  while (hi >= lo && !hit(hi)) --hi;
  return make_int2(lo, hi);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// out and lse per (kT-row tile, head, batch row): grid (B*H, Sq/kT), q
// tiles in reverse order, over the band's k tiles.  Per k tile: s = q k^T
// (registers), the online softmax (registers), p staged, o += p v; the next
// k and v tiles (the other stage) load meanwhile.
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int sq, int n_heads,
    int group, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, Band band) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float fsmem[];
  float* s_q = fsmem;
  float* s_k = s_q + G::kTileF;      // two stages
  float* s_v = s_k + 2 * G::kTileF;  // two stages
  float* s_p = s_v + 2 * G::kTileF;

  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int h = blockIdx.x % n_heads, b = blockIdx.x / n_heads;
  const int kvh = h / group;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  // q tile n - 1 - y: under a causal band the heaviest tiles go first
  const int n_qt = (sq + G::kT - 1) / G::kT;
  const int q_first = (n_qt - 1 - static_cast<int>(blockIdx.y)) * G::kT;
  const int2 kr = tile_range((band.skv + G::kT - 1) / G::kT, [&](int t) {
    return band.template tiles<G::kT>(q_first, t * G::kT);
  });

  // groups: {q, k tile 0}, {v tile 0}; then {k, v} of the next tile at the
  // top of every iteration (empty after the last)
  zero_pad<HD>(fsmem, 5);
  stage_tile<T, HD, VEC>(s_q, q + b * q_sb + h * q_sh, q_ss, q_first, sq);
  if (kr.x <= kr.y)
    stage_tile<T, HD, VEC>(s_k, kb, k_ss, kr.x * G::kT, band.skv);
  cp_async_commit();
  if (kr.x <= kr.y)
    stage_tile<T, HD, VEC>(s_v, vb, v_ss, kr.x * G::kT, band.skv);
  cp_async_commit();

  float m[G::kRI], l[G::kRI], acc[G::kRI][G::kAcc];
#pragma unroll
  for (int i = 0; i < G::kRI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::kAcc; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kr.x; kt <= kr.y; ++kt) {
    const int k_first = kt * G::kT;
    const int stage = (kt - kr.x) & 1;
    cp_async_wait<1>();  // q and this k tile have landed (v may not)
    __syncthreads();     // ... for all; the last tile's products are done
    if (kt < kr.y) {
      stage_tile<T, HD, VEC>(s_k + (stage ^ 1) * G::kTileF, kb, k_ss,
                             k_first + G::kT, band.skv);
      cp_async_commit();
      stage_tile<T, HD, VEC>(s_v + (stage ^ 1) * G::kTileF, vb, v_ss,
                             k_first + G::kT, band.skv);
    } else {
      cp_async_commit();
    }
    cp_async_commit();

    float s[G::kRI][G::kCJ] = {};
    dot_rows<HD>(s, s_q, s_k + stage * G::kTileF);
    const bool full = band.template full<G::kT>(q_first, k_first);
#pragma unroll
    for (int i = 0; i < G::kRI; ++i) {
      const int qi = q_first + tr + 16 * i;
      bool ok[G::kCJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j) {
        ok[j] = full || band.valid(qi, k_first + tc + 8 * j);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        s_p[(tr + 16 * i) * G::kLdS + tc + 8 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < G::kAcc; ++c) acc[i][c] *= alpha;
    }
    cp_async_wait<2>();  // this v tile (the next k and v may not)
    __syncthreads();     // ... and p, for all
    score_times<HD>(acc, s_p, s_v + stage * G::kTileF);
  }
  cp_async_wait<0>();  // a block with no band tile still staged q

#pragma unroll
  for (int i = 0; i < G::kRI; ++i) {
    const int qi = q_first + tr + 16 * i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o + ((static_cast<long long>(b) * sq + qi) * n_heads + h) * HD;
#pragma unroll
    for (int c = 0; c < G::kNH; ++c)
      if (G::stored(tc, c))
        store4(row + 4 * tc + 32 * c, acc[i][4 * c] / denom,
               acc[i][4 * c + 1] / denom, acc[i][4 * c + 2] / denom,
               acc[i][4 * c + 3] / denom);
    if (tc == 0)
      lse[(static_cast<long long>(b) * n_heads + h) * sq + qi] =
          m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

namespace bwd {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the portable cluster size


// dq per (kT-row tile, head, batch row): grid (B*H, Sq/kT), q tiles in
// reverse order, over the band's k tiles.  Per k tile: s = q k^T and
// p (registers), dp = dO v^T and ds (registers, then staged), dq += ds k;
// the next k tile (second stage) and v tile load meanwhile.
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq,
    int n_heads, int group, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, Band band) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float bsmem[];
  float* s_q = bsmem;
  float* s_do = s_q + G::kTileF;
  float* s_k = s_do + G::kTileF;  // two stages
  float* s_v = s_k + 2 * G::kTileF;
  float* s_ds = s_v + G::kTileF;

  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int h = blockIdx.x % n_heads, b = blockIdx.x / n_heads;
  const int q_first = (gridDim.y - 1 - blockIdx.y) * G::kT;
  const int kvh = h / group;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int2 kr = tile_range((band.skv + G::kT - 1) / G::kT, [&](int t) {
    return band.template tiles<G::kT>(q_first, t * G::kT);
  });

  zero_pad<HD>(bsmem, 5);
  stage_tile<T, HD, VEC>(s_q, q + b * q_sb + h * q_sh, q_ss, q_first, sq);
  stage_tile<T, HD, VEC>(s_do, dout + b * do_sb + h * do_sh, do_ss, q_first,
                         sq);
  cp_async_commit();
  if (kr.x <= kr.y) {
    stage_tile<T, HD, VEC>(s_k, kb, k_ss, kr.x * G::kT, band.skv);
    cp_async_commit();
    stage_tile<T, HD, VEC>(s_v, vb, v_ss, kr.x * G::kT, band.skv);
    cp_async_commit();
  }
  float row_lse[G::kRI], row_delta[G::kRI], acc[G::kRI][G::kAcc];
  const long long row0 = (static_cast<long long>(b) * n_heads + h) * sq;
#pragma unroll
  for (int i = 0; i < G::kRI; ++i) {
    const int qi = q_first + tr + 16 * i;
    row_lse[i] = qi < sq ? lse[row0 + qi] : 0.f;
    row_delta[i] = qi < sq ? delta[row0 + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < G::kAcc; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kr.x; kt <= kr.y; ++kt) {
    const int k_first = kt * G::kT;
    const float* s_kc = s_k + ((kt - kr.x) & 1) * G::kTileF;
    cp_async_wait<1>();  // q, dO and this k tile have landed (v may not)
    __syncthreads();
    float p[G::kRI][G::kCJ] = {};
    dot_rows<HD>(p, s_q, s_kc);
#pragma unroll
    for (int i = 0; i < G::kRI; ++i) {
      const int qi = q_first + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j) {
        const bool ok = qi < sq && band.valid(qi, k_first + tc + 8 * j);
        p[i][j] = ok ? expf(p[i][j] * scale - row_lse[i]) : 0.f;
      }
    }
    cp_async_wait<0>();  // this v tile
    __syncthreads();
    float dp[G::kRI][G::kCJ] = {};
    dot_rows<HD>(dp, s_do, s_v);
#pragma unroll
    for (int i = 0; i < G::kRI; ++i)
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j)
        s_ds[(tr + 16 * i) * G::kLdS + tc + 8 * j] =
            p[i][j] * (dp[i][j] - row_delta[i]);
    __syncthreads();  // ds is staged; v and the other k stage are free
    if (kt < kr.y) {
      stage_tile<T, HD, VEC>(s_k + ((kt + 1 - kr.x) & 1) * G::kTileF, kb,
                             k_ss, k_first + G::kT, band.skv);
      cp_async_commit();
      stage_tile<T, HD, VEC>(s_v, vb, v_ss, k_first + G::kT, band.skv);
      cp_async_commit();
    }
    score_times<HD>(acc, s_ds, s_kc);
  }
  cp_async_wait<0>();  // a block with no band tile still staged q and dO

#pragma unroll
  for (int i = 0; i < G::kRI; ++i) {
    const int qi = q_first + tr + 16 * i;
    if (qi >= sq) continue;
    T* row = dq + ((static_cast<long long>(b) * sq + qi) * n_heads + h) * HD;
#pragma unroll
    for (int c = 0; c < G::kNH; ++c)
      if (G::stored(tc, c))
        store4(row + 4 * tc + 32 * c, acc[i][4 * c] * scale,
               acc[i][4 * c + 1] * scale, acc[i][4 * c + 2] * scale,
               acc[i][4 * c + 3] * scale);
  }
}

// dk and dv per (kT-key tile, KV head, batch row): a cluster of min(G, 8)
// blocks along x, grid (ranks*K*B, Skv/kT), key tile 0 (the heaviest under
// a causal band) first.  Block `rank` walks heads rank, rank + ranks, ... of
// the group and, for each, the band's q tiles: s^T = k q^T and p (staged as
// [key][query]), dv += p dO, dp^T = v dO^T and ds, then (staged) dk += ds q;
// the next q tile loads meanwhile, the dO tile during the s product.  The
// cluster sums the blocks' register partials in rank order.
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int n_heads, int n_kv_heads, int group, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, float scale,
    Band band) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float bsmem[];
  float* s_k = bsmem;
  float* s_v = s_k + G::kTileF;
  float* s_q = s_v + G::kTileF;  // two stages
  float* s_do = s_q + 2 * G::kTileF;
  float* s_ps = s_do + G::kTileF;         // p, then ds: [key][query]
  float* s_lse = s_ps + G::kScoreF;       // two stages
  float* s_delta = s_lse + 2 * G::kT;

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int unit = blockIdx.x / ranks;
  const int kvh = unit % n_kv_heads, b = unit / n_kv_heads;
  const int k_first = blockIdx.y * G::kT;
  const int2 qr = tile_range((sq + G::kT - 1) / G::kT, [&](int t) {
    return band.template tiles<G::kT>(t * G::kT, k_first);
  });
  const int per_head = qr.y - qr.x + 1;  // q tiles of one head
  const int items =
      per_head > 0 ? (group - rank + ranks - 1) / ranks * per_head : 0;
  // item n: head kvh*group + rank + ranks*(n / per_head), q tile
  // qr.x + n % per_head
  auto head_of = [&](int n) {
    return kvh * group + rank + ranks * (n / per_head);
  };
  auto first_of = [&](int n) { return (qr.x + n % per_head) * G::kT; };
  auto stage_q = [&](int n) {
    const int h = head_of(n), first = first_of(n);
    stage_tile<T, HD, VEC>(s_q + (n & 1) * G::kTileF, q + b * q_sb + h * q_sh,
                           q_ss, first, sq);
    stage_row<G::kT>(s_lse + (n & 1) * G::kT,
                     lse + (static_cast<long long>(b) * n_heads + h) * sq,
                     first, sq, 0);
  };

  zero_pad<HD>(bsmem, 5);
  stage_tile<T, HD, VEC>(s_k, k + b * k_sb + kvh * k_sh, k_ss, k_first,
                         band.skv);
  stage_tile<T, HD, VEC>(s_v, v + b * v_sb + kvh * v_sh, v_ss, k_first,
                         band.skv);
  if (items > 0) stage_q(0);
  cp_async_commit();

  float dk_acc[G::kRI][G::kAcc], dv_acc[G::kRI][G::kAcc];
#pragma unroll
  for (int i = 0; i < G::kRI; ++i)
#pragma unroll
    for (int c = 0; c < G::kAcc; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int n = 0; n < items; ++n) {
    const int h = head_of(n), q_first = first_of(n);
    const float* s_qc = s_q + (n & 1) * G::kTileF;
    const float* s_lc = s_lse + (n & 1) * G::kT;
    cp_async_wait<0>();  // this q tile (and k, v) have landed
    __syncthreads();     // ... for all; the previous item's products are done
    stage_tile<T, HD, VEC>(s_do, dout + b * do_sb + h * do_sh, do_ss,
                           q_first, sq);
    stage_row<G::kT>(s_delta,
                     delta + (static_cast<long long>(b) * n_heads + h) * sq,
                     q_first, sq, G::kT);
    cp_async_commit();
    if (n + 1 < items) stage_q(n + 1);
    cp_async_commit();

    float s[G::kRI][G::kCJ] = {};
    dot_rows<HD>(s, s_k, s_qc);
#pragma unroll
    for (int i = 0; i < G::kRI; ++i) {
      const int kj = k_first + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j) {
        const int qi = q_first + tc + 8 * j;
        const bool ok = qi < sq && band.valid(qi, kj);
        s_ps[(tr + 16 * i) * G::kLdS + tc + 8 * j] =
            ok ? expf(s[i][j] * scale - s_lc[tc + 8 * j]) : 0.f;
      }
    }
    cp_async_wait<1>();  // this dO tile and delta (the next q may not)
    __syncthreads();
    score_times<HD>(dv_acc, s_ps, s_do);
    float dp[G::kRI][G::kCJ] = {};
    dot_rows<HD>(dp, s_v, s_do);
#pragma unroll
    for (int i = 0; i < G::kRI; ++i)
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j)
        dp[i][j] = s_ps[(tr + 16 * i) * G::kLdS + tc + 8 * j] *
                   (dp[i][j] - s_delta[tc + 8 * j]);
    __syncthreads();  // every thread has read p
#pragma unroll
    for (int i = 0; i < G::kRI; ++i)
#pragma unroll
      for (int j = 0; j < G::kCJ; ++j)
        s_ps[(tr + 16 * i) * G::kLdS + tc + 8 * j] = dp[i][j];
    __syncthreads();
    score_times<HD>(dk_acc, s_ps, s_qc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the tile buffers now take this block's partials

  float* part = bsmem;  // [2][kT][HD]: dk, then dv (no pad channels)
#pragma unroll
  for (int i = 0; i < G::kRI; ++i)
#pragma unroll
    for (int c = 0; c < G::kNH; ++c) {
      if (!G::stored(tc, c)) continue;
      const int at = (tr + 16 * i) * HD + 4 * tc + 32 * c;
      store4(part + at, dk_acc[i][4 * c], dk_acc[i][4 * c + 1],
             dk_acc[i][4 * c + 2], dk_acc[i][4 * c + 3]);
      store4(part + G::kT * HD + at, dv_acc[i][4 * c], dv_acc[i][4 * c + 1],
             dv_acc[i][4 * c + 2], dv_acc[i][4 * c + 3]);
    }
  cluster.sync();  // every partial of the cluster is written

  // block `rank` sums its share of the float4s over the ranks, in order
  constexpr int kNV = 2 * G::kT * HD / 4;
  const int share = (kNV + ranks - 1) / ranks;
  const int end = min(kNV, (rank + 1) * share);
  for (int e = rank * share + static_cast<int>(threadIdx.x); e < end;
       e += kThreads) {
    float4 sum = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0))[e];
    for (int r = 1; r < ranks; ++r) {
      const float4 x = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, r))[e];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const bool is_dv = e >= kNV / 2;
    const int key = (e / (HD / 4)) % G::kT, ch = (e % (HD / 4)) * 4;
    const int kj = k_first + key;
    if (kj >= band.skv) continue;
    const long long at =
        ((static_cast<long long>(b) * band.skv + kj) * n_kv_heads + kvh) * HD +
        ch;
    const float f = is_dv ? 1.f : scale;
    store4((is_dv ? dv : dk) + at, sum.x * f, sum.y * f, sum.z * f,
           sum.w * f);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// kernels whose shared memory exceeds the default 48 KB must opt in once
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Strides {
  long long sb, ss, sh;
};

// the 16-byte route reads rows whose base and every stride are whole
// multiples of 16 bytes
bool rows16(const void* p, Strides s, int elem) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0 &&
         (s.sb * elem) % 16 == 0 && (s.ss * elem) % 16 == 0 &&
         (s.sh * elem) % 16 == 0;
}

template <typename T, int HD, bool VEC>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int sq, int n_heads, int group,
                Strides qs, Strides ks, Strides vs, float scale, Band band,
                cudaStream_t stream) {
  using G = Geo<HD>;
  auto kernel = flash_fwd_kernel<T, HD, VEC>;
  cudaError_t err = allow_smem(kernel, G::kFwdSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + G::kT - 1) / G::kT;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(batch * n_heads, n_qt);
  kernel<<<grid, kThreads, G::kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, n_heads, group, qs.sb, qs.ss, qs.sh, ks.sb, ks.ss, ks.sh, vs.sb,
      vs.ss, vs.sh, scale, band);
  return cudaGetLastError();
}

// the backward's operands and shape, as each entry point receives them
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  int batch, sq, n_heads, n_kv_heads, group;
  Strides qs, ks, vs, dos;
  float scale;
  Band band;
  cudaStream_t stream;
};

template <typename T, int HD, bool VEC>
cudaError_t dq(const BwdArgs& a, void* dq_out) {
  using G = Geo<HD>;
  auto kernel = bwd::flash_dq_kernel<T, HD, VEC>;
  cudaError_t err = allow_smem(kernel, G::kDqSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.sq + G::kT - 1) / G::kT;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.batch * a.n_heads, n_qt);
  kernel<<<grid, kThreads, G::kDqSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq_out), a.sq, a.n_heads, a.group, a.qs.sb, a.qs.ss,
      a.qs.sh, a.ks.sb, a.ks.ss, a.ks.sh, a.vs.sb, a.vs.ss, a.vs.sh,
      a.dos.sb, a.dos.ss, a.dos.sh, a.scale, a.band);
  return cudaGetLastError();
}

template <typename T, int HD, bool VEC>
cudaError_t dkv(const BwdArgs& a, void* dk, void* dv) {
  using G = Geo<HD>;
  auto kernel = bwd::flash_dkv_kernel<T, HD, VEC>;
  cudaError_t err = allow_smem(kernel, G::kDkvSmem);
  if (err != cudaSuccess) return err;
  const int ranks = a.group < bwd::kMaxCluster ? a.group : bwd::kMaxCluster;
  const int n_kt = (a.band.skv + G::kT - 1) / G::kT;
  if (n_kt > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * a.n_kv_heads * a.batch, n_kt);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = G::kDkvSmem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.n_heads,
      a.n_kv_heads, a.group, a.qs.sb, a.qs.ss, a.qs.sh, a.ks.sb, a.ks.ss,
      a.ks.sh, a.vs.sb, a.vs.ss, a.vs.sh, a.dos.sb, a.dos.ss, a.dos.sh,
      a.scale, a.band);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int batch, int sq, int skv, int n_heads, int n_kv_heads) {
  return batch < 1 || batch > 65535 || sq < 1 || skv < 1 || n_heads < 1 ||
         n_heads > 65535 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
         static_cast<long long>(batch) * n_heads > (1LL << 30) ||
         (sq + kMaxTile - 1) / kMaxTile > 65535 ||
         (skv + kMaxTile - 1) / kMaxTile > 65535;
}

Band make_band(int causal, int window, int sq, int skv) {
  // rows are the LAST sq queries of the skv-long sequence, as in the
  // reference sdpa; a window applies to causal attention only
  return Band{causal != 0, causal ? window : 0, causal ? skv - sq : 0, skv};
}

// the (dtype, hd) dispatch of every entry point
template <class Launch>
int dispatch(int dtype, int hd, Launch launch) {
  cudaError_t err;
  if (dtype == 0 && hd == 64)
    err = launch(float{}, std::integral_constant<int, 64>{});
  else if (dtype == 0 && hd == 120)
    err = launch(float{}, std::integral_constant<int, 120>{});
  else if (dtype == 0 && hd == 128)
    err = launch(float{}, std::integral_constant<int, 128>{});
  else if (dtype == 0 && hd == 256)
    err = launch(float{}, std::integral_constant<int, 256>{});
  else if (dtype == 1 && hd == 64)
    err = launch(__nv_bfloat16{}, std::integral_constant<int, 64>{});
  else if (dtype == 1 && hd == 120)
    err = launch(__nv_bfloat16{}, std::integral_constant<int, 120>{});
  else if (dtype == 1 && hd == 128)
    err = launch(__nv_bfloat16{}, std::integral_constant<int, 128>{});
  else if (dtype == 1 && hd == 256)
    err = launch(__nv_bfloat16{}, std::integral_constant<int, 256>{});
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// the backward's checks and dispatch; VEC: the 16-byte route, which
// refuses operands it cannot read 16 bytes at a time
template <bool VEC, class Launch>
int bwd_entry(int dtype, int hd, const BwdArgs& a, Launch launch) {
  const int elem = dtype == 1 ? 2 : 4;
  if (VEC && !(rows16(a.q, a.qs, elem) && rows16(a.k, a.ks, elem) &&
               rows16(a.v, a.vs, elem) && rows16(a.dout, a.dos, elem)))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, hd, launch);
}

// the forward's checks and dispatch, as bwd_entry
template <bool VEC>
int fwd_entry(int dtype, int hd, const void* q, const void* k, const void* v,
              void* out, void* lse, int batch, int sq, int skv, int n_heads,
              int n_kv_heads, long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh, long long v_sb,
              long long v_ss, long long v_sh, float scale, int causal,
              int window, void* stream) {
  if (bad_shape(batch, sq, skv, n_heads, n_kv_heads) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  const int elem = dtype == 1 ? 2 : 4;
  if (VEC && !(rows16(q, qs, elem) && rows16(k, ks, elem) &&
               rows16(v, vs, elem)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Band band = make_band(causal, window, sq, skv);
  return dispatch(dtype, hd, [&](auto t, auto h) {
    return fwd<decltype(t), decltype(h)::value, VEC>(
        q, k, v, out, lse, batch, sq, n_heads, n_heads / n_kv_heads, qs, ks,
        vs, scale, band, static_cast<cudaStream_t>(stream));
  });
}

template <bool VEC>
int dq_entry(int dtype, int hd, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta,
             void* dq_out, int batch, int sq, int skv, int n_heads,
             int n_kv_heads, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, long long do_sb, long long do_ss,
             long long do_sh, float scale, int causal, int window,
             void* stream) {
  if (bad_shape(batch, sq, skv, n_heads, n_kv_heads) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, lse, delta, batch, sq, n_heads, n_kv_heads,
                  n_heads / n_kv_heads, Strides{q_sb, q_ss, q_sh},
                  Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
                  Strides{do_sb, do_ss, do_sh}, scale,
                  make_band(causal, window, sq, skv),
                  static_cast<cudaStream_t>(stream)};
  return bwd_entry<VEC>(dtype, hd, a, [&](auto t, auto h) {
    return dq<decltype(t), decltype(h)::value, VEC>(a, dq_out);
  });
}

template <bool VEC>
int dkv_entry(int dtype, int hd, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dk,
              void* dv, int batch, int sq, int skv, int n_heads,
              int n_kv_heads, long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh, long long v_sb,
              long long v_ss, long long v_sh, long long do_sb,
              long long do_ss, long long do_sh, float scale, int causal,
              int window, void* stream) {
  if (bad_shape(batch, sq, skv, n_heads, n_kv_heads) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, lse, delta, batch, sq, n_heads, n_kv_heads,
                  n_heads / n_kv_heads, Strides{q_sb, q_ss, q_sh},
                  Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
                  Strides{do_sb, do_ss, do_sh}, scale,
                  make_band(causal, window, sq, skv),
                  static_cast<cudaStream_t>(stream)};
  return bwd_entry<VEC>(dtype, hd, a, [&](auto t, auto h) {
    return dkv<decltype(t), decltype(h)::value, VEC>(a, dk, dv);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike); hd
// is 64, 120, 128 or 256.  q (B,Sq,H,hd), k/v (B,Skv,K,hd), dO (B,Sq,H,hd) are
// read through the given element strides (batch, sequence, head) with unit
// channel stride.  Outputs are contiguous: out and dq (B,Sq,H,hd), dk and dv
// (B,Skv,K,hd), lse and delta (B,H,Sq) f32.  Each returns the cudaError_t of
// its launch.  flash_fwd_launch, flash_dq_launch and flash_dkv_launch stage
// 16 bytes a read and refuse (cudaErrorInvalidValue) operands whose base or
// strides are no multiple of 16 bytes; the *_scalar_launch entry points
// take any strides.
#define FLASH_FWD_PARAMS                                                    \
  int dtype, int hd, const void *q, const void *k, const void *v, void *out, \
      void *lse, int batch, int sq, int skv, int n_heads, int n_kv_heads,   \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,       \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,       \
      long long v_sh, float scale, int causal, int window, void *stream
#define FLASH_FWD_ARGS                                                      \
  dtype, hd, q, k, v, out, lse, batch, sq, skv, n_heads, n_kv_heads, q_sb,  \
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, window, \
      stream

extern "C" int flash_fwd_launch(FLASH_FWD_PARAMS) {
  return fwd_entry<true>(FLASH_FWD_ARGS);
}
extern "C" int flash_fwd_scalar_launch(FLASH_FWD_PARAMS) {
  return fwd_entry<false>(FLASH_FWD_ARGS);
}

#define FLASH_DQ_PARAMS                                                     \
  int dtype, int hd, const void *q, const void *k, const void *v,           \
      const void *dout, const void *lse, const void *delta, void *dq_out,   \
      int batch, int sq, int skv, int n_heads, int n_kv_heads,              \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,       \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,       \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,    \
      float scale, int causal, int window, void *stream
#define FLASH_DQ_ARGS                                                       \
  dtype, hd, q, k, v, dout, lse, delta, dq_out, batch, sq, skv, n_heads,    \
      n_kv_heads, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,     \
      do_sb, do_ss, do_sh, scale, causal, window, stream
#define FLASH_DKV_PARAMS                                                    \
  int dtype, int hd, const void *q, const void *k, const void *v,           \
      const void *dout, const void *lse, const void *delta, void *dk,       \
      void *dv, int batch, int sq, int skv, int n_heads, int n_kv_heads,    \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,       \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,       \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,    \
      float scale, int causal, int window, void *stream
#define FLASH_DKV_ARGS                                                      \
  dtype, hd, q, k, v, dout, lse, delta, dk, dv, batch, sq, skv, n_heads,    \
      n_kv_heads, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,     \
      do_sb, do_ss, do_sh, scale, causal, window, stream

extern "C" int flash_dq_launch(FLASH_DQ_PARAMS) {
  return dq_entry<true>(FLASH_DQ_ARGS);
}
extern "C" int flash_dq_scalar_launch(FLASH_DQ_PARAMS) {
  return dq_entry<false>(FLASH_DQ_ARGS);
}
extern "C" int flash_dkv_launch(FLASH_DKV_PARAMS) {
  return dkv_entry<true>(FLASH_DKV_ARGS);
}
extern "C" int flash_dkv_scalar_launch(FLASH_DKV_PARAMS) {
  return dkv_entry<false>(FLASH_DKV_ARGS);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
