// Grouped heterogeneous tri-LoRA decode GEMV, for Hopper (sm_90a).
//
// Replaces: grouped_tri_lora_gemv_kernel in
//   src/repro/kernels/decode_attention/grouped.py (the Pallas TPU kernel;
//   grid (B, N/bn, K/bk), bank rows picked by scalar prefetch).
//
// Computes, for every batch row i with bank row g = rows[i]:
//   y[i] = x[i]·W + s·((x[i]·A[g])·C[g])·B[g]
// with x (B,K) and W (K,N) in T (bf16 or f32; W read through its row
// stride), the stacked bank A (m,K,r), C (m,r,r), B (m,r,N) in f32.
// Everything accumulates in f32 and is rounded to T once.  A masked row
// (rows[i] < 0) is exactly zero, base product included.
//
// What bounds it on this card: bytes.  At a decode batch of B rows the
// base product does 2B flops per element of W, so W must stream from
// device memory once: 33.6 MB for a 4096x4096 bf16 projection, ~10 us at
// 3.35 TB/s.  Beyond 32 rows the rows go in groups of 32 and W is read
// once per group.  The bank adds r*(K+N)*4 bytes per distinct user.
//
// What the design does about it:
//  * W streams once per row group in 16-byte copies: a block owns a tile
//    of TN = 32 * (16 / sizeof(T)) columns (512 bytes of a W row) and a
//    K slice; `cp.async` fills a ring of kStages stages of kStageK W rows
//    (each warp copies whole 512-byte row segments), so two stages are in
//    flight while one is consumed.  The same stages carry the rows' x
//    values for those K rows, so x needs no staging pass of its own.
//  * bf16 runs on the tensor cores.  On FFMA the 8 rows' 8 FMAs a W
//    element, with the widening and shared-memory reads, made the loop
//    issue-bound (~47 FMA/clk an SM, 40 us at the serving shape), so
//    mma.sync.m16n8k16 takes the rows as A (padded to 16 with zeros; x's
//    staged rows through ldmatrix) and W as B (its staged [k][n] rows
//    through ldmatrix.trans): each warp owns 32 columns and all of the
//    stage's K, f32 accumulators, products exact.  f32 (the oracle
//    precision) stays on FFMA, where TF32 would break its parity: a warp
//    holds 8 rows x 4 columns a lane and a share of the stage's K rows,
//    the shares summed in warp order.
//  * Split K fills the card: the host plan (ops.gemv_plan) cuts K into
//    S slices, one block each per column tile and row group, about one
//    block an SM.  Each block writes its f32 partial tile to a scratch
//    buffer; a second kernel sums the S partials of each output in slice
//    order (no atomics: the output is bitwise the same from call to call).
//    Summing them in a thread-block cluster over distributed shared memory
//    instead cost ~5 us at the serving shape: clusters put two blocks on
//    some SMs and the slowest block of each cluster held the rest.
//  * The rank-r down projection P = s·(x·A[g])·C[g] rides along: while its
//    first W stages are in flight, each block sums x·A[g] over its own K
//    slice for the rows that fall to its column tile (row i to tile
//    i % tiles), so A is read once; the second kernel sums those slices in
//    order, applies C[g] and s, and adds P·B[g] before the single rounding.
//    It is launched as a programmatic dependent of the first, so its launch
//    overlaps the first kernel's run.
//  * K and N need not be tile multiples: the ring's copies zero-fill past
//    the edges, and no padded copy of any operand is made.  A W or x whose
//    base or row stride is not a multiple of 16 bytes takes the scalar
//    route: the same kernel, the ring filled one element a copy, with the
//    same accumulation order (the same bits).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;   // rows a warp accumulates
constexpr int kStageK = 64;       // K rows a ring stage
constexpr int kStages = 3;
constexpr int kMaxRank = 32;
constexpr int kMaxSplits = 16;    // K slices
constexpr int kCombineThreads = 128;
constexpr int kMaxBatch = 65535 * 32;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; `bytes` below 16 zero-fills the rest (0: zeros, the
// source unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// programmatic dependent launch: the down kernel lets the main kernel
// start at once; the main kernel waits for the down kernel's writes
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of f32 held raw, read as floats (the FFMA path)
template <typename T>
struct Vec16 {
  uint4 raw;
  __device__ __forceinline__ float at(int c) const;
};
template <>
__device__ __forceinline__ float Vec16<float>::at(int c) const {
  const uint32_t w = c == 0 ? raw.x : c == 1 ? raw.y : c == 2 ? raw.z : raw.w;
  return __uint_as_float(w);
}

// A ring stage holds W as [kStageK][WLD] and x as [MAXB][XLD] in T; the
// rows are padded by 16 bytes so that the 8 rows of an ldmatrix (bf16)
// fall on 8 disjoint groups of banks.  bf16 runs on the tensor cores (MMA:
// each warp owns 32 columns of the tile), f32 on FFMA (each warp holds 8
// rows x 4 columns a lane and a share of the stage's K rows).
template <typename T, int MAXB>
struct Geo {
  static constexpr bool MMA = sizeof(T) == 2;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // cols/lane
  static constexpr int TN = 32 * VEC;              // columns a block
  static constexpr int WLD = TN + VEC;             // padded W row
  static constexpr int XLD = kStageK + VEC;        // padded x row
  static constexpr int MT = MAXB < 16 ? 1 : MAXB / 16;  // MMA row tiles
  static constexpr int RG = MAXB / kRowsPerWarp;   // FFMA: warps across rows
  static constexpr int NK = kWarps / RG;           // FFMA: warps across K
  static constexpr int KPW = kStageK / NK;         // K rows a warp a stage
  static constexpr int XK = 16 / static_cast<int>(sizeof(T));  // x per read
  static constexpr int kWBytes = kStageK * WLD * static_cast<int>(sizeof(T));
  static constexpr int kXBytes = MAXB * XLD * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the tile's f32 partial [MAXB][TN] (FFMA: one per K share of warps)
  static constexpr int kRedBytes = (MMA ? 1 : NK) * MAXB * TN * 4;
  static constexpr int kMainBytes =
      kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  // + the down projection's warp sums, f32 [kWarps][kMaxRank]
  static constexpr int kSmem = kMainBytes + kWarps * kMaxRank * 4;
  static_assert(MAXB % kRowsPerWarp == 0 && kWarps % RG == 0, "rows");
  static_assert(MMA || KPW % XK == 0, "x reads");
  static_assert(kStageK % XK == 0, "x chunks");
};

// x·A[g] over this block's K slice [k0, kend) for the group's rows that
// fall to this column tile (row i to tile i % tiles), into
// xa_part[z][row][:]; zero for a masked row.  `red` is [kWarps][kMaxRank]
// f32 of shared memory.  Sums: each thread's K values in order, then the
// lanes and the warps in a fixed order.
template <typename T>
__device__ void down_slice(const int* __restrict__ rows,
                           const T* __restrict__ xg,
                           const float* __restrict__ a,
                           float* __restrict__ xa_part, float* red, int B,
                           int K, int r, int m, int r0, int nrows, int k0,
                           int kend, int z, int tile, int tiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = tile; row < nrows; row += tiles) {
    const int g = min(rows[r0 + row], m - 1);  // >= m clamped, not checked
    float part[kMaxRank];
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) part[j] = 0.f;
    if (g >= 0) {
      const T* xi = xg + static_cast<long long>(row) * K;
      const float* ag = a + static_cast<long long>(g) * K * r;
      for (int kk = k0 + threadIdx.x; kk < kend; kk += kThreads) {
        const float xv = to_f32(xi[kk]);
        const float* arow = ag + static_cast<long long>(kk) * r;
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j)
          if (j < r) part[j] += xv * arow[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) {
      if (j < r) {  // r is uniform: every lane takes part in the shuffle
        const float v = warp_sum(part[j]);
        if (lane == 0) red[warp * kMaxRank + j] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < r) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * kMaxRank + threadIdx.x];
      xa_part[(static_cast<long long>(z) * B + r0 + row) * r + threadIdx.x] =
          v;
    }
    __syncthreads();
  }
}

// One ring stage: W rows [k, k + kStageK) of the tile's columns as
// [kStageK][TN], then x of the group's rows for the same K as
// [MAXB][kStageK].  Rows past `kend`, columns past N and rows past the
// group are zero.  VEC: 16-byte cp.async (W, x and their row strides
// 16-byte aligned); else one element a copy through registers.
template <typename T, int MAXB, bool VEC>
__device__ __forceinline__ void load_stage(
    T* __restrict__ st, const T* __restrict__ w, long long ldw,
    const T* __restrict__ x, int K, int N, int n0, int k, int kend,
    int nrows) {
  using G = Geo<T, MAXB>;
  T* xs = st + kStageK * G::WLD;
  if constexpr (VEC) {
    constexpr int kWChunks = kStageK * 32;            // 16-byte chunks
    for (int e = threadIdx.x; e < kWChunks; e += kThreads) {
      const int kk = e / 32, col = n0 + (e % 32) * G::VEC;
      const int kg = k + kk;
      const int n_ok = (kg < kend) ? min(G::VEC, N - col) : 0;
      const bool ok = n_ok > 0;
      const T* src = ok ? w + kg * ldw + col : w;
      cp_async16(smem_u32(st + kk * G::WLD + (e % 32) * G::VEC), src,
                 ok ? n_ok * static_cast<int>(sizeof(T)) : 0);
    }
    constexpr int kXPerRow = kStageK / G::VEC;
    for (int e = threadIdx.x; e < MAXB * kXPerRow; e += kThreads) {
      const int row = e / kXPerRow, kc = (e % kXPerRow) * G::VEC;
      const int kg = k + kc;
      const int k_ok = (row < nrows && kg < kend) ? min(G::VEC, kend - kg) : 0;
      const bool ok = k_ok > 0;
      const T* src = ok ? x + static_cast<long long>(row) * K + kg : x;
      cp_async16(smem_u32(xs + row * G::XLD + kc), src,
                 ok ? k_ok * static_cast<int>(sizeof(T)) : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kStageK * G::TN; e += kThreads) {
      const int kk = e / G::TN, cc = e % G::TN;
      const int kg = k + kk, col = n0 + cc;
      st[kk * G::WLD + cc] =
          (kg < kend && col < N) ? w[kg * ldw + col] : from_f32<T>(0.f);
    }
    for (int e = threadIdx.x; e < MAXB * kStageK; e += kThreads) {
      const int row = e / kStageK, kk = e % kStageK, kg = k + kk;
      xs[row * G::XLD + kk] = (row < nrows && kg < kend)
                  ? x[static_cast<long long>(row) * K + kg]
                  : from_f32<T>(0.f);
    }
  }
}

// This warp's K rows of one stage: acc[row][col] += x[row][k] * W[k][col]
// for its 8 rows and its lane's VEC columns, K rows in increasing order.
template <typename T, int MAXB>
__device__ __forceinline__ void consume_stage(const T* __restrict__ st,
                                              float (&acc)[kRowsPerWarp]
                                                          [16 / sizeof(T)][1],
                                              int rg, int ksub, int lane) {
  using G = Geo<T, MAXB>;
  const T* xs = st + kStageK * G::WLD + rg * kRowsPerWarp * G::XLD;
#pragma unroll
  for (int q = 0; q < G::KPW; q += G::XK) {
    const int kk0 = ksub * G::KPW + q;
    Vec16<T> xr[kRowsPerWarp];                 // XK k values of each row
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
      xr[rr].raw = *reinterpret_cast<const uint4*>(xs + rr * G::XLD + kk0);
#pragma unroll
    for (int u = 0; u < G::XK; ++u) {
      Vec16<T> wv;
      wv.raw = *reinterpret_cast<const uint4*>(st + (kk0 + u) * G::WLD +
                                               lane * G::VEC);
      float wf[G::VEC];
#pragma unroll
      for (int c = 0; c < G::VEC; ++c) wf[c] = wv.at(c);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float xv = xr[rr].at(u);
#pragma unroll
        for (int c = 0; c < G::VEC; ++c)
          acc[rr][c][0] = fmaf(xv, wf[c], acc[rr][c][0]);
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 on the tensor cores: this warp's 32 columns of the stage, for the
// group's rows in MT tiles of 16 (rows past MAXB are zero), K in steps of
// 16 in increasing order.  B fragments come from W's [k][n] rows through
// ldmatrix.trans, A fragments from x's [row][k] rows.
template <int MAXB>
__device__ __forceinline__ void consume_stage_mma(
    const __nv_bfloat16* __restrict__ st,
    float (&acc)[Geo<__nv_bfloat16, MAXB>::MT][4][4], int warp, int lane) {
  using G = Geo<__nv_bfloat16, MAXB>;
  const __nv_bfloat16* xs = st + kStageK * G::WLD;
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int k0 = 0; k0 < kStageK; k0 += 16) {
    uint32_t b[2][4];                          // 2 x (k16 x n16)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldsm_x4_trans(b[h], smem_u32(st + (k0 + ri + 8 * (mi & 1)) * G::WLD +
                                   warp * 32 + 16 * h + 8 * (mi >> 1)));
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      uint32_t a[4];
      if constexpr (MAXB < 16) {               // rows 8..15 do not exist
        ldsm_x2(a[0], a[2], smem_u32(xs + ri * G::XLD + k0 + 8 * (mi & 1)));
        a[1] = a[3] = 0u;
      } else {
        ldsm_x4(a, smem_u32(xs + (mt * 16 + ri + 8 * (mi & 1)) * G::XLD +
                            k0 + 8 * (mi >> 1)));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[mt][nt], a, b[nt >> 1][2 * (nt & 1)],
                 b[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
}

// The f32 partial of K slice blockIdx.x for the rows of group blockIdx.z
// and the columns of tile blockIdx.y, into part[z][row][col] (row stride
// np); the slice's x·A[g] of the rows that fall to this tile into
// xa_part[z][row][:].
template <typename T, int MAXB, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) grouped_gemv_kernel(
    const int* __restrict__ rows, const T* __restrict__ x,
    const T* __restrict__ w, long long ldw, const float* __restrict__ a,
    float* __restrict__ part, float* __restrict__ xa_part, int B, int K,
    int N, int np, int r, int m, int depth) {
  using G = Geo<T, MAXB>;
  pdl_launch_dependents();                     // the combine kernel may wait
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* down_red = reinterpret_cast<float*>(smem_raw + G::kMainBytes);

  const int z = blockIdx.x;
  const int n0 = blockIdx.y * G::TN;
  const int r0 = blockIdx.z * MAXB;
  const int nrows = min(MAXB, B - r0);
  const int k0 = z * depth;
  const int kend = min(K, k0 + depth);
  const T* xg = x + static_cast<long long>(r0) * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp % G::RG;
  const int ksub = warp / G::RG;
  const int n_stages = (kend - k0 + kStageK - 1) / kStageK;
  constexpr int kStageElems = G::kStageBytes / static_cast<int>(sizeof(T));

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages)
      load_stage<T, MAXB, VEC>(ring + s * kStageElems, w, ldw, xg, K, N, n0,
                               k0 + s * kStageK, kend, nrows);
    cp_async_commit();
  }
  // while the first stages are in flight: this slice's share of x·A[g]
  down_slice<T>(rows, xg, a, xa_part, down_red, B, K, r, m, r0, nrows, k0,
                kend, z, blockIdx.y, gridDim.y);

  // MMA: [row tile][n8 tile][fragment]; FFMA: [row][column]
  float acc[G::MMA ? G::MT : kRowsPerWarp][G::MMA ? 4 : G::VEC]
           [G::MMA ? 4 : 1];
#pragma unroll
  for (int i = 0; i < (G::MMA ? G::MT : kRowsPerWarp); ++i)
#pragma unroll
    for (int j = 0; j < (G::MMA ? 4 : G::VEC); ++j)
#pragma unroll
      for (int f = 0; f < (G::MMA ? 4 : 1); ++f) acc[i][j][f] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();              // stage s has landed
    __syncthreads();                           // and stage s-1 is consumed
    const int next = s + kStages - 1;
    if (next < n_stages)
      load_stage<T, MAXB, VEC>(ring + (next % kStages) * kStageElems, w, ldw,
                               xg, K, N, n0, k0 + next * kStageK, kend,
                               nrows);
    cp_async_commit();                         // empty groups keep the count
    if constexpr (G::MMA)
      consume_stage_mma<MAXB>(ring + (s % kStages) * kStageElems, acc, warp,
                              lane);
    else
      consume_stage<T, MAXB>(ring + (s % kStages) * kStageElems, acc, rg,
                             ksub, lane);
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is free

  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int kTileV = MAXB * G::TN / 4;     // float4s of the tile
  if constexpr (G::MMA) {
    // the tile [row][col]: fragment f of n8 tile nt holds row
    // lane/4 (+8 for f >= 2) and columns 2*(lane%4) + f%2
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int f = 0; f < 4; f += 2) {
          const int row = mt * 16 + lane / 4 + 4 * f;
          if (row < MAXB)
            *reinterpret_cast<float2*>(
                red + row * G::TN + warp * 32 + nt * 8 + 2 * (lane % 4)) =
                make_float2(acc[mt][nt][f], acc[mt][nt][f + 1]);
        }
  } else {
    // the warps' partials [ksub][row][col]
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      float* dst = red + (ksub * MAXB + rg * kRowsPerWarp + rr) * G::TN +
                   lane * G::VEC;
#pragma unroll
      for (int c = 0; c < G::VEC; c += 4)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[rr][c][0], acc[rr][c + 1][0], acc[rr][c + 2][0],
                        acc[rr][c + 3][0]);
    }
  }
  __syncthreads();
  // the tile's partial to part[z], the warps' K shares summed in order
  for (int e = threadIdx.x; e < kTileV; e += kThreads) {
    const int row = e / (G::TN / 4);
    const int col = n0 + 4 * (e % (G::TN / 4));
    if (row >= nrows || col >= N) continue;
    float4 v = reinterpret_cast<const float4*>(red)[e];
#pragma unroll
    for (int q = 1; q < (G::MMA ? 1 : G::NK); ++q) {
      const float4 u = reinterpret_cast<const float4*>(red)[q * kTileV + e];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(
        part + (static_cast<long long>(z) * B + r0 + row) * np + col) = v;
  }
}

// y[i, col] for row i = blockIdx.x and col = blockIdx.y * kCombineThreads
// + threadIdx.x: the K slices' partials summed in slice order, then
// + P·B[g] with P = s · (sum of the slices' x·A[g]) · C[g]; exactly zero
// for a masked row.  Launched as the GEMV kernel's programmatic dependent:
// it loads B[g]'s column and C[g] before it waits for that kernel's
// writes, then issues every load of the partials and forms P while they
// are in flight.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads) grouped_gemv_combine_kernel(
    const int* __restrict__ rows, const float* __restrict__ part,
    const float* __restrict__ xa_part, const float* __restrict__ c_bank,
    const float* __restrict__ b_bank, T* __restrict__ out, int B, int N,
    int np, int r, int m, float scaling, int splits) {
  __shared__ float xa[kMaxRank], p[kMaxRank];
  const int i = blockIdx.x;
  const int col = blockIdx.y * kCombineThreads + threadIdx.x;
  const bool ok = col < N;
  const int g = min(rows[i], m - 1);           // >= m clamped, not checked
  T* dst = out + static_cast<long long>(i) * N + col;
  if (g < 0) {                                 // masked row: exactly zero
    if (ok) *dst = from_f32<T>(0.f);
    return;
  }
  float bv[kMaxRank];                          // B[g][:, col]: no dependence
  const float* bg = b_bank + static_cast<long long>(g) * r * N + col;
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j)
    bv[j] = (j < r && ok) ? bg[static_cast<long long>(j) * N] : 0.f;
  float cv[kMaxRank];                          // thread j < r: C[g][:, j]
  const float* cg_ = c_bank + static_cast<long long>(g) * r * r;
#pragma unroll
  for (int l = 0; l < kMaxRank; ++l)
    cv[l] = (l < r && threadIdx.x < r) ? cg_[l * r + threadIdx.x] : 0.f;
  pdl_wait();                                  // the partials are written
  float pv[kMaxSplits];
#pragma unroll
  for (int zz = 0; zz < kMaxSplits; ++zz)
    pv[zz] = (zz < splits && ok)
                 ? part[(static_cast<long long>(zz) * B + i) * np + col]
                 : 0.f;
  if (threadIdx.x < r) {
    float v = 0.f;
    for (int zz = 0; zz < splits; ++zz)
      v += xa_part[(static_cast<long long>(zz) * B + i) * r + threadIdx.x];
    xa[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x < r) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxRank; ++l)
      if (l < r) v += xa[l] * cv[l];
    p[threadIdx.x] = scaling * v;
  }
  __syncthreads();
  if (!ok) return;
  float y = pv[0];
#pragma unroll
  for (int zz = 1; zz < kMaxSplits; ++zz)
    if (zz < splits) y += pv[zz];
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j)
    if (j < r) y += p[j] * bv[j];
  *dst = from_f32<T>(y);
}

template <typename T, int MAXB, bool VEC>
cudaError_t launch_main(const int* rows, const T* x, const T* w,
                        long long ldw, const float* a, float* part,
                        float* xa_part, int B, int K, int N, int np, int r,
                        int m, int splits, int depth, cudaStream_t s) {
  using G = Geo<T, MAXB>;
  auto kernel = grouped_gemv_kernel<T, MAXB, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(splits, (N + G::TN - 1) / G::TN, (B + MAXB - 1) / MAXB);
  kernel<<<grid, kThreads, G::kSmem, s>>>(rows, x, w, ldw, a, part, xa_part,
                                          B, K, N, np, r, m, depth);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const int* rows, const float* part,
                           const float* xa_part, const float* c,
                           const float* bmat, T* out, int B, int N, int np,
                           int r, int m, float scaling, int splits,
                           cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (N + kCombineThreads - 1) / kCombineThreads);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, grouped_gemv_combine_kernel<T>, rows, part, xa_part, c, bmat, out,
      B, N, np, r, m, scaling, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(bool vec, const void* rows_, const void* x_, const void* w_,
           long long ldw, const void* a_, const void* c, const void* bmat,
           void* part_, void* xa_part_, void* out_, int B, int K, int N,
           int r, int m, float scaling, int splits, int depth,
           cudaStream_t s) {
  const int* rows = static_cast<const int*>(rows_);
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  const float* a = static_cast<const float*>(a_);
  float* part = static_cast<float*>(part_);
  float* xa_part = static_cast<float*>(xa_part_);
  const int np = (N + 3) / 4 * 4;
  cudaError_t err;
  if (B <= 8)
    err = vec ? launch_main<T, 8, true>(rows, x, w, ldw, a, part, xa_part, B,
                                        K, N, np, r, m, splits, depth, s)
              : launch_main<T, 8, false>(rows, x, w, ldw, a, part, xa_part,
                                         B, K, N, np, r, m, splits, depth, s);
  else if (B <= 16)
    err = vec ? launch_main<T, 16, true>(rows, x, w, ldw, a, part, xa_part,
                                         B, K, N, np, r, m, splits, depth, s)
              : launch_main<T, 16, false>(rows, x, w, ldw, a, part, xa_part,
                                          B, K, N, np, r, m, splits, depth,
                                          s);
  else  // groups of 32 rows
    err = vec ? launch_main<T, 32, true>(rows, x, w, ldw, a, part, xa_part,
                                         B, K, N, np, r, m, splits, depth, s)
              : launch_main<T, 32, false>(rows, x, w, ldw, a, part, xa_part,
                                          B, K, N, np, r, m, splits, depth,
                                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_combine<T>(
      rows, part, xa_part, static_cast<const float*>(c),
      static_cast<const float*>(bmat), static_cast<T*>(out_), B, N, np, r, m,
      scaling, splits, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, W and out).  vec: 1 for the
// 16-byte route (x and W bases, W's row stride ldw and x's K, all
// multiples of 16 bytes), 0 for the scalar route.  rows int32 (B,); x
// (B,K) and out (B,N) contiguous; W (K,N) with unit column stride and row
// stride ldw; bank a (m,K,r), c (m,r,r), b (m,r,N) contiguous float32.
// Scratch, float32: part of splits*B*np elements (np = N rounded up to a
// multiple of 4) and xa_part of splits*B*r.  K is cut into `splits`
// slices of `depth` rows (depth a multiple of 64, splits*depth >= K and no
// slice empty; gemv_plan in ops.py).  Row indices >= m are not checked:
// they are clamped to m-1 so that no read leaves the bank.  Any batch >= 1
// is taken.  Returns the cudaError_t of the launches.
extern "C" int grouped_gemv_launch(int dtype, int vec, const void* rows,
                                   const void* x, const void* w,
                                   long long ldw, const void* a,
                                   const void* c, const void* b, void* part,
                                   void* xa_part, void* out, int batch, int K,
                                   int N, int r, int m, float scaling,
                                   int splits, int depth, void* stream) {
  if (batch < 1 || batch > kMaxBatch || r < 1 || r > kMaxRank || K < 1 ||
      N < 1 || m < 1 || ldw < N || splits < 1 || splits > kMaxSplits ||
      depth < 1 || depth % kStageK != 0 ||
      static_cast<long long>(splits) * depth < K ||
      static_cast<long long>(splits - 1) * depth >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(vec != 0, rows, x, w, ldw, a, c, b, part, xa_part,
                         out, batch, K, N, r, m, scaling, splits, depth, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vec != 0, rows, x, w, ldw, a, c, b, part,
                                 xa_part, out, batch, K, N, r, m, scaling,
                                 splits, depth, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The second of grouped_gemv_launch's two kernels alone (the split sum and
// the rank-r epilogue over partials already written), for timing it on its
// own; the same arguments.
extern "C" int grouped_gemv_combine_launch(int dtype, const void* rows,
                                           const void* c, const void* b,
                                           const void* part,
                                           const void* xa_part, void* out,
                                           int batch, int N, int r, int m,
                                           float scaling, int splits,
                                           void* stream) {
  if (batch < 1 || batch > kMaxBatch || r < 1 || r > kMaxRank || N < 1 ||
      m < 1 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np = (N + 3) / 4 * 4;
  const int* rw = static_cast<const int*>(rows);
  const float* pt = static_cast<const float*>(part);
  const float* xp = static_cast<const float*>(xa_part);
  const float* cc = static_cast<const float*>(c);
  const float* bb = static_cast<const float*>(b);
  if (dtype == 0)
    return static_cast<int>(launch_combine<float>(
        rw, pt, xp, cc, bb, static_cast<float*>(out), batch, N, np, r, m,
        scaling, splits, s));
  if (dtype == 1)
    return static_cast<int>(launch_combine<__nv_bfloat16>(
        rw, pt, xp, cc, bb, static_cast<__nv_bfloat16*>(out), batch, N, np,
        r, m, scaling, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grouped_gemv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
