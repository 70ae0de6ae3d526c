// Single-token decode attention over a ring KV cache, for Hopper (sm_90a).
//
// Replaces: decode_attention_kernel in
//   src/repro/kernels/decode_attention/decode_attention.py (the Pallas TPU
//   kernel; its pallas_call grid is (B, H, R/bk) with the KV axis sequential).
//
// Computes, for every batch row b and query head h (KV head h / (H/K)):
//   out[b,0,h,:] = softmax_s(q·k[b,s]·hd^-0.5) · v[b,s]   over valid slots s,
// valid = (s <= idx[b]) | (idx[b] >= ring).  A row with idx[b] < 0 is a
// masked batch slot and its output is exactly zero.  Softmax and the
// accumulator are f32; the result is rounded to the cache dtype once.
//
// What bounds it on this card: bytes.  Each (row, KV head) must read its
// valid K and V slots once (2 * n_valid * hd * sizeof(T)) and does 4 flops
// per element read for each of the group's query heads, far below the ~295
// flop/byte at which the H100's tensor cores would become the limit.  At
// LLaMA-7B width (B=8, H=K=32, hd=128, ring 160, bf16) K+V are 21 MB,
// ~6.3 us at 3.35 TB/s, so latency and the launch weigh as much.
//
// What the design does about it:
//  * One block per (row, KV head, split): it computes the KV head's query
//    heads from each K/V slot it reads, so every slot is read from device
//    memory once (GQA and MQA included).  Groups of more than 4 query heads
//    go 4 to a block (head chunks along the grid); those blocks read the
//    same slots at the same time, mostly from L2.
//  * Each warp streams its own slots, as flash-decoding does, with no
//    block barrier until the end: a slot's hd channels lie on hd/8 (bf16)
//    or hd/4 (f32) lanes, 16 bytes a load (hd 120 in bf16: 15 of 16 lanes,
//    2 slots a warp instruction); a warp step loads K and V of 4 slots a
//    lane group (2 when the block has 4 heads) into registers, and two
//    steps are in flight while the warp computes.  Per step and head: the
//    scores (reduced over the group's lanes by shuffles), the warp's
//    running max, one rescale of (l, p·V) and the step's p·V.  A warp also
//    prefetches its K and V of 4 steps ahead into L2.  At the end the lane
//    groups, then the 8 warps, are merged in a fixed order.
//    Staging the slots in shared memory first, behind block barriers
//    (cp.async, then bulk copies with mbarriers, in whole-ring or per-chunk
//    two-pass softmax forms) measured 15.6-21.8 us at the serving shape:
//    the arithmetic waited on the copies and on barriers.
//  * Split slots: when B x K blocks would not fill the card (long rings
//    over few KV heads: h2o-danube-3-4b's 4,096 over 8, recurrentgemma-2b's
//    2,048 over 1), the host plan (ops.attn_plan) splits each row's valid
//    slots over S <= 8 blocks, one thread-block cluster, the most whose
//    blocks the card holds in one wave (decode_attention_capacity: the
//    occupancy calculator per cluster size); each keeps its (m, l, acc) in its shared memory and rank z
//    combines its share of the outputs over ranks 0..S-1 in that order
//    through distributed shared memory.  No atomics: the output is bitwise
//    the same from call to call.
//  * Valid slots are a prefix of the ring [0, min(idx+1, ring)), so masked
//    slots are never read.  The ring is read in the model's (B, R, K, hd)
//    layout through its strides; nothing is transposed or padded.  A cache
//    whose base or strides are not 16-byte multiples takes the scalar
//    route: the same kernel, each 16 bytes loaded an element at a time,
//    with the same order of sums (the same bits).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 64;       // query heads a KV head
constexpr int kMaxSplits = 8;       // portable cluster size
constexpr int kL2Ahead = 4;         // steps a warp prefetches into L2
constexpr float kNegInf = -1e30f;

template <int... HDs>
struct HeadDims {};
// the head dims the kernel is built for (ops._ATTN_HEAD_DIMS follows)
using Instantiated = HeadDims<64, 120, 128, 256>;

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

// Lanes of a slot: a slot's NV 16-byte vectors lie on LPS lanes (the
// power of two >= NV, at most 32), VPL vectors a lane; a warp holds SPW
// slot groups.  A warp step takes U slots a group (SPS a warp), K and V in
// registers; HPT heads a block (1 for MHA, else 4, whose q and sums take
// the registers of 3 more slots a step).
template <typename T, int HD, int HPT>
struct Geo {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int NV = HD / VEC;
  static constexpr int LPS = NV > 16 ? 32 : NV > 8 ? 16 : NV > 4 ? 8 : 4;
  static constexpr int VPL = (NV + LPS - 1) / LPS;
  static constexpr int SPW = 32 / LPS;
  static constexpr int CPL = VPL * VEC;   // channels a lane holds
  static constexpr int U = HPT == 1 ? 4 / VPL : 1;
  static constexpr int SPS = SPW * U;
  static_assert(HD % VEC == 0, "hd must be a multiple of 16 bytes");
  static_assert(U >= 1, "a step takes at least one slot a group");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* idx;
  void* out;
  long long k_sb, k_sr, k_sh, v_sb, v_sr, v_sh;
  int idx_stride, n_heads, group, ring;
  float sm_scale;
};

// Heads a block takes: all of a KV head's query heads when there is one,
// else up to 4 (the grid's head chunks split larger groups)
__host__ __device__ constexpr int heads_per_block(int group) {
  return group == 1 ? 1 : 4;
}

// 16 bytes of T at p: one 16-byte load (VEC) or one element at a time
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load16(const T* p) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(T) == 4) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(p);
    return make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(u[2 * i]) |
             (static_cast<uint32_t>(u[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 16 bytes of T (held as a uint4) widened to f32
__device__ __forceinline__ void widen(uint4 r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(uint4 r, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A warp step's K and V: U slots of this lane's group, VPL vectors each
template <typename T, int HD, int HPT>
struct StepBuf {
  uint4 k[Geo<T, HD, HPT>::U][Geo<T, HD, HPT>::VPL];
  uint4 v[Geo<T, HD, HPT>::U][Geo<T, HD, HPT>::VPL];
};

// grid (splits, K x head chunks, B); with splits > 1 a cluster of
// (splits, 1, 1).  Two blocks an SM.
template <typename T, int HD, int HPT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(Args a) {
  using G = Geo<T, HD, HPT>;
  // q of the block's heads; each warp's (m, l, acc); the block's (m, l,
  // acc), which the cluster's ranks read
  __shared__ __align__(16) float q_s[HPT][HD];
  __shared__ float wm[kWarps][HPT], wl[kWarps][HPT];
  __shared__ __align__(16) float wacc[kWarps][HPT][HD];
  __shared__ float bm[HPT], bl[HPT];
  __shared__ __align__(16) float bacc[HPT][HD];

  const int chunks = (a.group + HPT - 1) / HPT;
  const int z = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / chunks;
  const int h0 = (blockIdx.y % chunks) * HPT;       // first head in group
  const int hcount = min(HPT, a.group - h0);
  const int splits = static_cast<int>(gridDim.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_out = hcount * HD;
  const long long head0 =
      static_cast<long long>(b) * a.n_heads + kvh * a.group + h0;
  T* o = static_cast<T*>(a.out) + head0 * HD;      // adjacent heads
  const int row_idx = a.idx[b * a.idx_stride];
  const T* qp = static_cast<const T*>(a.q) + head0 * HD;
  for (int e = tid; e < HPT * HD; e += kThreads)
    q_s[e / HD][e % HD] = e < n_out ? to_f32(qp[e]) : 0.f;
  if (row_idx < 0) {  // masked batch slot: exactly zero (rank z its share)
    const int share = (n_out + splits - 1) / splits;
    const int end = min(n_out, (z + 1) * share);
    for (int e = z * share + tid; e < end; e += kThreads)
      o[e] = from_f32<T>(0.f);
    return;
  }
  const int n_valid = row_idx >= a.ring ? a.ring : row_idx + 1;
  const int span = (n_valid + splits - 1) / splits;
  const int s_begin = min(n_valid, z * span);
  const int s_end = min(n_valid, s_begin + span);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  __syncthreads();                                 // q

  // this lane's slot group and vectors; warp w takes the block's steps
  // w, w + 8, ...; a step's slot (group gq, u) is base + u*SPW + gq
  const int lg = lane % G::LPS, gq = lane / G::LPS;
  auto base_of = [&](int i) { return s_begin + (warp + kWarps * i) * G::SPS; };
  // step i's K and V into registers; step i + kL2Ahead's into L2
  auto load = [&](StepBuf<T, HD, HPT>& buf, int i) {
    const int base = base_of(i);
    const int ahead = base_of(i + kL2Ahead);
#pragma unroll
    for (int u = 0; u < G::U; ++u) {
      const int s = base + u * G::SPW + gq;
      const int sa = ahead + u * G::SPW + gq;
#pragma unroll
      for (int vi = 0; vi < G::VPL; ++vi) {
        const int vv = lg + G::LPS * vi;
        const bool ok = s < s_end && vv < G::NV;
        buf.k[u][vi] = ok ? load16<T, VEC>(kb + s * a.k_sr + vv * G::VEC)
                          : make_uint4(0u, 0u, 0u, 0u);
        buf.v[u][vi] = ok ? load16<T, VEC>(vb + s * a.v_sr + vv * G::VEC)
                          : make_uint4(0u, 0u, 0u, 0u);
        if (kL2Ahead > 0 && sa < s_end && vv < G::NV) {
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              kb + sa * a.k_sr + vv * G::VEC));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              vb + sa * a.v_sr + vv * G::VEC));
        }
      }
    }
  };

  float qr[HPT][G::CPL];                          // this lane's q channels
#pragma unroll
  for (int j = 0; j < HPT; ++j)
#pragma unroll
    for (int vi = 0; vi < G::VPL; ++vi)
#pragma unroll
      for (int c = 0; c < G::VEC; ++c) {
        const int d = (lg + G::LPS * vi) * G::VEC + c;
        qr[j][vi * G::VEC + c] = d < HD ? q_s[j][d] : 0.f;
      }
  float m[HPT], l[HPT], acc[HPT][G::CPL];
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < G::CPL; ++c) acc[j][c] = 0.f;
  }

  // one step: the U slots' scores for each head (reduced over the group's
  // lanes), the running max over the warp, p, l and p·V of this group
  auto compute = [&](const StepBuf<T, HD, HPT>& buf, int i) {
    const int base = base_of(i);
    float d[G::U][HPT];
#pragma unroll
    for (int u = 0; u < G::U; ++u) {
      float kf[G::CPL];
#pragma unroll
      for (int vi = 0; vi < G::VPL; ++vi)
        widen(buf.k[u][vi], kf + vi * G::VEC, T());
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int vi = 0; vi < G::VPL; ++vi) {
          const int d0 = (lg + G::LPS * vi) * G::VEC;
          if (d0 < HD) {
#pragma unroll
            for (int c = 0; c < G::VEC; ++c)
              dot = fmaf(qr[j][vi * G::VEC + c], kf[vi * G::VEC + c], dot);
          }
        }
        d[u][j] = dot;
      }
    }
#pragma unroll
    for (int u = 0; u < G::U; ++u)
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
#pragma unroll
        for (int o2 = G::LPS / 2; o2 > 0; o2 >>= 1)
          d[u][j] += __shfl_xor_sync(0xffffffffu, d[u][j], o2);
        d[u][j] = base + u * G::SPW + gq < s_end ? d[u][j] * a.sm_scale
                                                 : kNegInf;
      }
#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      if (j < hcount) {
        float mx = d[0][j];
#pragma unroll
        for (int u = 1; u < G::U; ++u) mx = fmaxf(mx, d[u][j]);
#pragma unroll
        for (int o2 = G::LPS; o2 < 32; o2 <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
        const float m_new = fmaxf(m[j], mx);
        const float alpha = expf(m[j] - m_new);
        m[j] = m_new;
        l[j] *= alpha;
#pragma unroll
        for (int c = 0; c < G::CPL; ++c) acc[j][c] *= alpha;
#pragma unroll
        for (int u = 0; u < G::U; ++u) {
          d[u][j] = expf(d[u][j] - m_new);     // p
          l[j] += d[u][j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < G::U; ++u) {
      float vf[G::CPL];
#pragma unroll
      for (int vi = 0; vi < G::VPL; ++vi)
        widen(buf.v[u][vi], vf + vi * G::VEC, T());
#pragma unroll
      for (int j = 0; j < HPT; ++j)
        if (j < hcount)
#pragma unroll
          for (int c = 0; c < G::CPL; ++c)
            acc[j][c] = fmaf(d[u][j], vf[c], acc[j][c]);
    }
  };

  // two steps in flight: load i+2 into the buffer step i just freed
  auto exists = [&](int i) { return base_of(i) < s_end; };
  StepBuf<T, HD, HPT> b0, b1;
  if (exists(0)) load(b0, 0);
  if (exists(1)) load(b1, 1);
  for (int i = 0; exists(i); i += 2) {
    compute(b0, i);
    if (exists(i + 2)) load(b0, i + 2);
    if (!exists(i + 1)) break;
    compute(b1, i + 1);
    if (exists(i + 3)) load(b1, i + 3);
  }

  // the warp's groups summed in a fixed order (m is the warp's already)
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
#pragma unroll
    for (int o2 = G::LPS; o2 < 32; o2 <<= 1) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], o2);
#pragma unroll
      for (int c = 0; c < G::CPL; ++c)
        acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], o2);
    }
  }
  if (lane < G::LPS) {
#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      if (lane == 0) {
        wm[warp][j] = m[j];
        wl[warp][j] = l[j];
      }
#pragma unroll
      for (int vi = 0; vi < G::VPL; ++vi) {
        const int d0 = (lg + G::LPS * vi) * G::VEC;
        if (d0 < HD)
#pragma unroll
          for (int c = 0; c < G::VEC; ++c)
            wacc[warp][j][d0 + c] = acc[j][vi * G::VEC + c];
      }
    }
  }
  __syncthreads();

  // the block's (m, l, acc): the warps in order; a warp that saw no slot
  // has l = acc = 0 and m = -1e30, so its weight exp(m - max) is zero
  for (int e = tid; e < n_out; e += kThreads) {
    const int j = e / HD, dd = e % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][j]);
    float lsum = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w][j] - mx);
      lsum += wl[w][j] * c;
      s += wacc[w][j][dd] * c;
    }
    if (splits == 1) {
      o[e] = from_f32<T>(s / lsum);
    } else {
      bacc[j][dd] = s;
      if (dd == 0) {
        bm[j] = mx;
        bl[j] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // combine the splits' (m, l, acc) in split order; a split that saw no
  // slot has l = acc = 0 and m = -1e30, so its weight is exactly zero
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (n_out + splits - 1) / splits;
  const int end = min(n_out, (z + 1) * share);
  for (int e = z * share + tid; e < end; e += kThreads) {
    const int j = e / HD, dd = e % HD;
    float mx = kNegInf;
    for (int rk = 0; rk < splits; ++rk)
      mx = fmaxf(mx, cluster.map_shared_rank(&bm[0], rk)[j]);
    float lsum = 0.f, s = 0.f;
    for (int rk = 0; rk < splits; ++rk) {
      const float w = expf(cluster.map_shared_rank(&bm[0], rk)[j] - mx);
      lsum += cluster.map_shared_rank(&bl[0], rk)[j] * w;
      s += cluster.map_shared_rank(&bacc[0][0], rk)[j * HD + dd] * w;
    }
    o[e] = from_f32<T>(s / lsum);
  }
  cluster.sync();                              // no block leaves while read
}

template <typename T, int HD, int HPT, bool VEC>
cudaError_t launch(const Args& a, int batch, int n_kv_heads, int splits,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n_kv_heads * ((a.group + HPT - 1) / HPT),
                     batch);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, HD, HPT, VEC>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HD, int... Rest>
cudaError_t dispatch(HeadDims<HD, Rest...>, int hd, bool vec, const Args& a,
                     int batch, int n_kv_heads, int splits, cudaStream_t s) {
  if (hd == HD && heads_per_block(a.group) == 1)
    return vec ? launch<T, HD, 1, true>(a, batch, n_kv_heads, splits, s)
               : launch<T, HD, 1, false>(a, batch, n_kv_heads, splits, s);
  if (hd == HD)
    return vec ? launch<T, HD, 4, true>(a, batch, n_kv_heads, splits, s)
               : launch<T, HD, 4, false>(a, batch, n_kv_heads, splits, s);
  if constexpr (sizeof...(Rest) > 0)
    return dispatch<T>(HeadDims<Rest...>{}, hd, vec, a, batch, n_kv_heads,
                       splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and out are contiguous (B, 1, H, hd);
// k and v are (B, R, K, hd) with unit channel stride and the given element
// strides for the batch, slot and head axes; idx is int32, read at
// idx[b * idx_stride] (stride 0 broadcasts one position to every row).
// vec: 1 for the 16-byte route (k and v bases and strides multiples of 16
// bytes), 0 for the scalar route.  Each row's valid slots are split over
// `splits` blocks, one cluster (splits <= 8; attn_plan in ops.py).
// Returns the cudaError_t of the launch.
extern "C" int decode_attention_launch(
    int dtype, int hd, int vec, const void* q, const void* k, const void* v,
    const void* idx, int idx_stride, void* out, int batch, int n_heads,
    int n_kv_heads, int ring, long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh, float sm_scale,
    int splits, void* stream) {
  if (batch < 1 || batch > 65535 || n_kv_heads < 1 || ring < 1 ||
      n_heads % n_kv_heads != 0 || n_heads / n_kv_heads > kMaxGroup ||
      n_heads > 65535 ||
      splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.idx = static_cast<const int*>(idx);
  a.out = out;
  a.k_sb = k_sb;
  a.k_sr = k_sr;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_sr = v_sr;
  a.v_sh = v_sh;
  a.idx_stride = idx_stride;
  a.n_heads = n_heads;
  a.group = n_heads / n_kv_heads;
  a.ring = ring;
  a.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(Instantiated{}, hd, vec != 0, a,
                                            batch, n_kv_heads, splits, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        Instantiated{}, hd, vec != 0, a, batch, n_kv_heads, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The decode-attention blocks the current device holds at once when they
// are launched in clusters of `splits` blocks (bf16, hd 128, the 16-byte
// route; the other instantiations hold as many, two an SM), from the
// occupancy calculator; -1 when it fails.  Clusters of 3 or more blocks
// reach fewer SMs than the card has, so this falls with the cluster size.
extern "C" int decode_attention_capacity(int splits) {
  auto kernel = decode_attention_kernel<__nv_bfloat16, 128, 1, true>;
  if (splits < 1 || splits > kMaxSplits) return -1;
  if (splits == 1) {
    int per_sm = 0, device = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess ||
        cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return -1;
    return per_sm * sms;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters * splits;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
