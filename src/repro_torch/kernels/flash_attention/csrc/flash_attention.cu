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
// What the design does about it:
// * One block of 256 threads per (64-row tile, head, batch row).  The TPU's
//   sequential grid axis becomes a loop inside the block over only the tiles
//   that intersect the causal/window band (the TPU kernel's _band), so
//   causal attention does half the tile products.
// * Tiles are staged in shared memory as f32 with rows padded to hd+1
//   floats, so the 16 threads that read 16 different rows at one column hit
//   16 different banks.  Each thread owns a 4x4 block of the 64x64 score
//   tile (rows ty+16i, columns tx+16j) and 4 x hd/16 accumulators, so every
//   shared-memory load feeds 4 FMAs.  Row max and row sums are reduced over
//   the 16 lanes of a half warp by shuffles; the online-softmax state stays
//   in registers in f32.
// * q/k/v/dO are read in the model's (B,S,heads,hd) layout through their
//   strides: no transpose, no padding, no repeat of K/V for GQA.  The ragged
//   sequence edge is masked inside the kernel by the real lengths.
// * dk/dv: one block per (64-key tile, KV head, batch row) walks the G
//   query heads of its group and their band q tiles and sums the group in
//   registers, so no atomics and no second reduction pass are needed (the
//   idea of the TPU kernel's flattened (group, q-block) axis).
//
// Each entry point launches on the given stream and returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kPad = kTile + 1;  // padded row of a 64-wide score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// reductions over the 16 lanes that share a tile row (lanes tx = 0..15)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Band {
  int causal, window, q_off, skv;
  // does the (q tile, k tile) pair hold any (query, key) of the band?
  __device__ __forceinline__ bool tiles(int q_first, int k_first) const {
    if (causal) {
      if (k_first > q_first + q_off + kTile - 1) return false;
      if (window && k_first + kTile - 1 <= q_first + q_off - window)
        return false;
    }
    return true;
  }
  // element mask for query row qi (sequence index) and key kj
  __device__ __forceinline__ bool valid(int qi, int kj) const {
    if (kj >= skv) return false;
    if (!causal) return true;
    const int qpos = qi + q_off;
    return kj <= qpos && (window == 0 || kj > qpos - window);
  }
};

// rows [first, first + 64) of a (S, hd) slice with row stride `rs` into a
// padded f32 tile; rows at or beyond n are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int first, int n) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int row = first + r;
    dst[r * LD + d] = row < n ? to_f32(src[row * rs + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int sq, int n_heads,
    int group, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, Band band) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* sq_t = smem;                 // 64 x LD
  float* sk_t = sq_t + kTile * LD;    // 64 x LD
  float* sv_t = sk_t + kTile * LD;    // 64 x LD
  float* sp_t = sv_t + kTile * LD;    // 64 x kPad

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_first = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  load_tile<T, HD>(sq_t, qb, q_ss, q_first, sq);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (band.skv + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_first = kt * kTile;
    if (!band.tiles(q_first, k_first)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(sk_t, kb, k_ss, k_first, band.skv);
    load_tile<T, HD>(sv_t, vb, v_ss, k_first, band.skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq_t[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk_t[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_first + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = band.valid(qi, k_first + tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sp_t[(ty + 16 * i) * kPad + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sv_t[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp_t[(ty + 16 * i) * kPad + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_first + ty + 16 * i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * sq + qi) * n_heads + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    if (tx == 0)
      lse[(static_cast<long long>(b) * n_heads + h) * sq + qi] =
          m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// backward: dq per (q tile, head, batch row) over the band KV tiles
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq,
    int n_heads, int group, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, Band band) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* sq_t = smem;                  // 64 x LD
  float* sdo_t = sq_t + kTile * LD;    // 64 x LD
  float* sk_t = sdo_t + kTile * LD;    // 64 x LD
  float* sv_t = sk_t + kTile * LD;     // 64 x LD
  float* sds_t = sv_t + kTile * LD;    // 64 x kPad

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_first = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  load_tile<T, HD>(sq_t, q + b * q_sb + h * q_sh, q_ss, q_first, sq);
  load_tile<T, HD>(sdo_t, dout + b * do_sb + h * do_sh, do_ss, q_first, sq);
  float row_lse[4], row_delta[4], acc[4][NJ];
  const long long row0 = (static_cast<long long>(b) * n_heads + h) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_first + ty + 16 * i;
    row_lse[i] = qi < sq ? lse[row0 + qi] : 0.f;
    row_delta[i] = qi < sq ? delta[row0 + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (band.skv + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_first = kt * kTile;
    if (!band.tiles(q_first, k_first)) continue;
    __syncthreads();
    load_tile<T, HD>(sk_t, kb, k_ss, k_first, band.skv);
    load_tile<T, HD>(sv_t, vb, v_ss, k_first, band.skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sq_t[(ty + 16 * i) * LD + d];
        dov[i] = sdo_t[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sk_t[(tx + 16 * j) * LD + d];
        vv[j] = sv_t[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_first + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = band.valid(qi, k_first + tx + 16 * j);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        sds_t[(ty + 16 * i) * kPad + tx + 16 * j] =
            p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = sk_t[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sds_t[(ty + 16 * i) * kPad + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_first + ty + 16 * i;
    if (qi >= sq) continue;
    T* row = dq + ((static_cast<long long>(b) * sq + qi) * n_heads + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dk and dv per (KV tile, KV head, batch row), summed over the G
// query heads of the group and their band q tiles
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int n_heads, int n_kv_heads, int group, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, float scale,
    Band band) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* sk_t = smem;                  // 64 x LD  keys of this block
  float* sv_t = sk_t + kTile * LD;     // 64 x LD
  float* sq_t = sv_t + kTile * LD;     // 64 x LD  current q tile
  float* sdo_t = sq_t + kTile * LD;    // 64 x LD
  float* sp_t = sdo_t + kTile * LD;    // 64 keys x kPad queries

  // keys c_i = ty + 16 i; queries r_j = tx + 16 j; channels tx + 16 j
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k_first = blockIdx.x * kTile;
  const int kvh = blockIdx.y, b = blockIdx.z;
  load_tile<T, HD>(sk_t, k + b * k_sb + kvh * k_sh, k_ss, k_first, band.skv);
  load_tile<T, HD>(sv_t, v + b * v_sb + kvh * v_sh, v_ss, k_first, band.skv);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (sq + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long row0 = (static_cast<long long>(b) * n_heads + h) * sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_first = qt * kTile;
      if (!band.tiles(q_first, k_first)) continue;
      __syncthreads();  // the previous q tile's readers are done
      load_tile<T, HD>(sq_t, q + b * q_sb + h * q_sh, q_ss, q_first, sq);
      load_tile<T, HD>(sdo_t, dout + b * do_sb + h * do_sh, do_ss, q_first,
                       sq);
      float col_lse[4], col_delta[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q_first + tx + 16 * j;
        col_lse[j] = qi < sq ? lse[row0 + qi] : 0.f;
        col_delta[j] = qi < sq ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sk_t[(ty + 16 * i) * LD + d];
          vv[i] = sv_t[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sq_t[(tx + 16 * j) * LD + d];
          dov[j] = sdo_t[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k_first + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q_first + tx + 16 * j;
          const bool ok = qi < sq && band.valid(qi, kj);
          const float p = ok ? expf(s[i][j] * scale - col_lse[j]) : 0.f;
          ds[i][j] = p * (dp[i][j] - col_delta[j]);
          sp_t[(ty + 16 * i) * kPad + tx + 16 * j] = p;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float dov[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) dov[j] = sdo_t[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sp_t[(ty + 16 * i) * kPad + r];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            dv_acc[i][j] = fmaf(p, dov[j], dv_acc[i][j]);
        }
      }
      __syncthreads();  // p is read; the tile now takes ds
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sp_t[(ty + 16 * i) * kPad + tx + 16 * j] = ds[i][j];
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float qv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) qv[j] = sq_t[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dsv = sp_t[(ty + 16 * i) * kPad + r];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            dk_acc[i][j] = fmaf(dsv, qv[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k_first + ty + 16 * i;
    if (kj >= band.skv) continue;
    const long long off =
        ((static_cast<long long>(b) * band.skv + kj) * n_kv_heads + kvh) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv[off + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr size_t fwd_smem(int hd) {
  return sizeof(float) * (3 * kTile * (hd + 1) + kTile * kPad);
}
constexpr size_t bwd_smem(int hd) {
  return sizeof(float) * (4 * kTile * (hd + 1) + kTile * kPad);
}

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

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int sq, int n_heads, int group,
                Strides qs, Strides ks, Strides vs, float scale, Band band,
                cudaStream_t stream) {
  const size_t smem = fwd_smem(HD);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTile - 1) / kTile, n_heads, batch);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, n_heads, group, qs.sb, qs.ss, qs.sh, ks.sb, ks.ss, ks.sh, vs.sb,
      vs.ss, vs.sh, scale, band);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq_out, int batch,
               int sq, int n_heads, int group, Strides qs, Strides ks,
               Strides vs, Strides dos, float scale, Band band,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(HD);
  cudaError_t err = allow_smem(flash_dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTile - 1) / kTile, n_heads, batch);
  flash_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq_out), sq, n_heads, group, qs.sb, qs.ss, qs.sh, ks.sb,
      ks.ss, ks.sh, vs.sb, vs.ss, vs.sh, dos.sb, dos.ss, dos.sh, scale, band);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                int batch, int sq, int n_heads, int n_kv_heads, int group,
                Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                Band band, cudaStream_t stream) {
  const size_t smem = bwd_smem(HD);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((band.skv + kTile - 1) / kTile, n_kv_heads, batch);
  flash_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, n_heads, n_kv_heads,
      group, qs.sb, qs.ss, qs.sh, ks.sb, ks.ss, ks.sh, vs.sb, vs.ss, vs.sh,
      dos.sb, dos.ss, dos.sh, scale, band);
  return cudaGetLastError();
}

bool bad_shape(int batch, int sq, int skv, int n_heads, int n_kv_heads) {
  return batch < 1 || batch > 65535 || sq < 1 || skv < 1 || n_heads < 1 ||
         n_heads > 65535 || n_kv_heads < 1 || n_heads % n_kv_heads != 0;
}

Band make_band(int causal, int window, int sq, int skv) {
  // rows are the LAST sq queries of the skv-long sequence, as in the
  // reference sdpa; a window applies to causal attention only
  return Band{causal != 0, causal ? window : 0, causal ? skv - sq : 0, skv};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike); hd
// is 64 or 128.  q (B,Sq,H,hd), k/v (B,Skv,K,hd), dO (B,Sq,H,hd) are read
// through the given element strides (batch, sequence, head) with unit
// channel stride.  Outputs are contiguous: out and dq (B,Sq,H,hd), dk and dv
// (B,Skv,K,hd), lse and delta (B,H,Sq) f32.  Each returns the cudaError_t of
// its launch.
extern "C" int flash_fwd_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, void* out,
    void* lse, int batch, int sq, int skv, int n_heads, int n_kv_heads,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, int window, void* stream) {
  if (bad_shape(batch, sq, skv, n_heads, n_kv_heads) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = n_heads / n_kv_heads;
  const Band band = make_band(causal, window, sq, skv);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && hd == 64)
    err = fwd<float, 64>(q, k, v, out, lse, batch, sq, n_heads, group, qs, ks,
                         vs, scale, band, s);
  else if (dtype == 0 && hd == 128)
    err = fwd<float, 128>(q, k, v, out, lse, batch, sq, n_heads, group, qs,
                          ks, vs, scale, band, s);
  else if (dtype == 1 && hd == 64)
    err = fwd<__nv_bfloat16, 64>(q, k, v, out, lse, batch, sq, n_heads, group,
                                 qs, ks, vs, scale, band, s);
  else if (dtype == 1 && hd == 128)
    err = fwd<__nv_bfloat16, 128>(q, k, v, out, lse, batch, sq, n_heads,
                                  group, qs, ks, vs, scale, band, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int flash_dq_launch(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dq_out,
    int batch, int sq, int skv, int n_heads, int n_kv_heads, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, float scale,
    int causal, int window, void* stream) {
  if (bad_shape(batch, sq, skv, n_heads, n_kv_heads) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = n_heads / n_kv_heads;
  const Band band = make_band(causal, window, sq, skv);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && hd == 64)
    err = dq<float, 64>(q, k, v, dout, lse, delta, dq_out, batch, sq, n_heads,
                        group, qs, ks, vs, dos, scale, band, s);
  else if (dtype == 0 && hd == 128)
    err = dq<float, 128>(q, k, v, dout, lse, delta, dq_out, batch, sq,
                         n_heads, group, qs, ks, vs, dos, scale, band, s);
  else if (dtype == 1 && hd == 64)
    err = dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq_out, batch, sq,
                                n_heads, group, qs, ks, vs, dos, scale, band,
                                s);
  else if (dtype == 1 && hd == 128)
    err = dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq_out, batch,
                                 sq, n_heads, group, qs, ks, vs, dos, scale,
                                 band, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int flash_dkv_launch(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int batch, int sq, int skv, int n_heads, int n_kv_heads, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, float scale,
    int causal, int window, void* stream) {
  if (bad_shape(batch, sq, skv, n_heads, n_kv_heads) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = n_heads / n_kv_heads;
  const Band band = make_band(causal, window, sq, skv);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && hd == 64)
    err = dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, batch, sq,
                         n_heads, n_kv_heads, group, qs, ks, vs, dos, scale,
                         band, s);
  else if (dtype == 0 && hd == 128)
    err = dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, batch, sq,
                          n_heads, n_kv_heads, group, qs, ks, vs, dos, scale,
                          band, s);
  else if (dtype == 1 && hd == 64)
    err = dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, batch, sq,
                                 n_heads, n_kv_heads, group, qs, ks, vs, dos,
                                 scale, band, s);
  else if (dtype == 1 && hd == 128)
    err = dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, batch,
                                  sq, n_heads, n_kv_heads, group, qs, ks, vs,
                                  dos, scale, band, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
