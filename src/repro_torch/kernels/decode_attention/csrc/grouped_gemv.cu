// Grouped heterogeneous tri-LoRA decode GEMV, for Hopper (sm_90a).
//
// Replaces: grouped_tri_lora_gemv_kernel in
//   src/repro/kernels/decode_attention/grouped.py (the Pallas TPU kernel;
//   grid (B, N/bn, K/bk), bank rows picked by scalar prefetch).
//
// Computes, for every batch row i with bank row g = rows[i]:
//   y[i] = x[i]·W + s·((x[i]·A[g])·C[g])·B[g]
// with x (B,K) and W (K,N) in T (bf16 or f32), the stacked bank A (m,K,r),
// C (m,r,r), B (m,r,N) in f32.  Everything accumulates in f32 and is rounded
// to T once.  A masked row (rows[i] < 0) is exactly zero, base GEMV included.
//
// What bounds it on this card: bytes.  At batch B the base product does 2B
// flops per element of W, so for decode batches W must simply stream from
// device memory once: 33.6 MB for a 4096x4096 bf16 projection, ~10 us at
// 3.35 TB/s.  Beyond 32 rows the rows are tiled in groups of 32 (one grid
// row of blocks each), so W is read once per group.  The bank rows add r*(K+N)*4 bytes per
// distinct user (~0.26 MB at r=8).
//
// What the design does about it:
//  * W is read once per group of up to 32 rows, not once per batch row: each
//    block owns a 16-column tile of the output for all rows of its group, so
//    N=4096 gives 256 blocks (more than the card's 132 SMs) and every W
//    element feeds one FMA per row of the group from registers.  Within a block, 8 threads cover the 16 columns (2 adjacent
//    columns each, one 4- or 8-byte load) and the 32 thread rows split K;
//    each thread issues all its W loads of a K chunk before any arithmetic.
//  * x is staged per K chunk in shared memory as f32, transposed to
//    [k][row], so one float4 read feeds four rows.
//  * The rank-r down projection P = s·(x·A[g])·C[g] is computed once per row
//    by a small first kernel (one block per row), not once per N tile; the
//    main kernel adds P·B[g] in its epilogue before the single rounding.
//  * K and N need not be tile multiples: the ragged edges are masked in the
//    kernel and no padded copy of any operand is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 16;                              // columns per block
constexpr int kThreadsPerRow = kTileN / 2;              // 2 columns a thread
constexpr int kRowsPerPass = kThreads / kThreadsPerRow;  // 32 K rows a pass
constexpr int kStageFloats = 4096;                      // 16 KB of staged x
constexpr int kMaxRank = 32;
constexpr int kMaxBatch = 65535 * 32;  // grid.y limit x 32-row groups

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

// two adjacent elements of W; PAIR means one aligned vector load is legal
template <typename T, bool PAIR>
__device__ __forceinline__ void load_pair(const T* __restrict__ p, bool ok0,
                                          bool ok1, float& w0, float& w1);
template <>
__device__ __forceinline__ void load_pair<float, true>(
    const float* __restrict__ p, bool ok0, bool, float& w0, float& w1) {
  if (ok0) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    w0 = v.x;
    w1 = v.y;
  } else {
    w0 = w1 = 0.f;
  }
}
template <>
__device__ __forceinline__ void load_pair<__nv_bfloat16, true>(
    const __nv_bfloat16* __restrict__ p, bool ok0, bool, float& w0,
    float& w1) {
  if (ok0) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    w0 = __low2float(v);
    w1 = __high2float(v);
  } else {
    w0 = w1 = 0.f;
  }
}
template <>
__device__ __forceinline__ void load_pair<float, false>(
    const float* __restrict__ p, bool ok0, bool ok1, float& w0, float& w1) {
  w0 = ok0 ? p[0] : 0.f;
  w1 = ok1 ? p[1] : 0.f;
}
template <>
__device__ __forceinline__ void load_pair<__nv_bfloat16, false>(
    const __nv_bfloat16* __restrict__ p, bool ok0, bool ok1, float& w0,
    float& w1) {
  w0 = ok0 ? __bfloat162float(p[0]) : 0.f;
  w1 = ok1 ? __bfloat162float(p[1]) : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// P[i, :] = s · (x[i]·A[g]) · C[g]; zero for a masked row.  One block a row.
template <typename T>
__global__ void __launch_bounds__(kThreads) lora_down_kernel(
    const int* __restrict__ rows, const T* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ c,
    float* __restrict__ p, int K, int r, int m, float scaling) {
  const int i = blockIdx.x;
  const int g = min(rows[i], m - 1);  // rows >= m are clamped, not checked
  if (g < 0) {
    if (threadIdx.x < r) p[i * r + threadIdx.x] = 0.f;
    return;
  }
  const T* xi = x + static_cast<long long>(i) * K;
  const float* ag = a + static_cast<long long>(g) * K * r;
  float part[kMaxRank];
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j) part[j] = 0.f;
  for (int kk = threadIdx.x; kk < K; kk += kThreads) {
    const float xv = to_f32(xi[kk]);
    const float* arow = ag + static_cast<long long>(kk) * r;
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j)
      if (j < r) part[j] += xv * arow[j];
  }
  __shared__ float red[kWarps][kMaxRank];
  __shared__ float xa[kMaxRank];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j) {
    if (j < r) {  // r is uniform: every lane takes part in the shuffle
      const float s = warp_sum(part[j]);
      if (lane == 0) red[warp][j] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < r) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    xa[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < r) {
    const float* cg = c + static_cast<long long>(g) * r * r;
    float s = 0.f;
    for (int j = 0; j < r; ++j) s += xa[j] * cg[j * r + threadIdx.x];
    p[i * r + threadIdx.x] = scaling * s;
  }
}

// y[i, n0:n0+16] for the rows i of this block's group (blockIdx.y, MAXB rows
// each): x·W over all of K, then + P·B[g], masked.
template <typename T, int MAXB, bool PAIR>
__global__ void __launch_bounds__(kThreads) grouped_gemv_kernel(
    const int* __restrict__ rows, const T* __restrict__ x,
    const T* __restrict__ w, const float* __restrict__ bmat,
    const float* __restrict__ p, T* __restrict__ out, int B, int K, int N,
    int r, int m) {
  const int r0 = blockIdx.y * MAXB;  // first row of this block's group
  rows += r0;
  x += static_cast<long long>(r0) * K;
  p += r0 * r;
  out += static_cast<long long>(r0) * N;
  B = min(MAXB, B - r0);
  constexpr int kChunk = kStageFloats / MAXB;        // K values per stage
  constexpr int kIters = kChunk / kRowsPerPass;      // K rows a thread/stage
  static_assert(kIters * kRowsPerPass == kChunk, "chunk must fill passes");
  static_assert(kWarps * MAXB * kTileN <= kStageFloats, "reduction fits");
  __shared__ __align__(16) float xs[kStageFloats];   // [kChunk][MAXB]

  const int n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x % kThreadsPerRow;
  const int ty = threadIdx.x / kThreadsPerRow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = n0 + 2 * tx;
  const bool ok0 = n < N, ok1 = n + 1 < N;

  float acc[MAXB][2];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b][0] = acc[b][1] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    // stage x[:, k0:k0+kChunk] as f32 [k][row]; rows >= B and k >= K are 0
    for (int e = threadIdx.x; e < kChunk * MAXB; e += kThreads) {
      const int kk = e % kChunk;
      const int bb = e / kChunk;
      const int kg = k0 + kk;
      xs[kk * MAXB + bb] =
          (bb < B && kg < K) ? to_f32(x[static_cast<long long>(bb) * K + kg])
                             : 0.f;
    }
    __syncthreads();
    float w0[kIters], w1[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int kg = k0 + ty + it * kRowsPerPass;
      const bool krow = kg < K;
      load_pair<T, PAIR>(w + static_cast<long long>(kg) * N + n,
                         krow && ok0, krow && ok1, w0[it], w1[it]);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const float4* xv =
          reinterpret_cast<const float4*>(xs + (ty + it * kRowsPerPass) * MAXB);
#pragma unroll
      for (int q = 0; q < MAXB / 4; ++q) {
        const float4 xx = xv[q];
        acc[4 * q + 0][0] += xx.x * w0[it];
        acc[4 * q + 0][1] += xx.x * w1[it];
        acc[4 * q + 1][0] += xx.y * w0[it];
        acc[4 * q + 1][1] += xx.y * w1[it];
        acc[4 * q + 2][0] += xx.z * w0[it];
        acc[4 * q + 2][1] += xx.z * w1[it];
        acc[4 * q + 3][0] += xx.w * w0[it];
        acc[4 * q + 3][1] += xx.w * w1[it];
      }
    }
    __syncthreads();
  }

  // reduce the 32 K-row partials of each (row, column): the 4 thread rows of
  // a warp by shuffles, then the 8 warps through shared memory
  float* red = xs;  // [warp][row][column], free after the last stage
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      float v = acc[b][cc];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < kThreadsPerRow)
        red[(warp * MAXB + b) * kTileN + 2 * tx + cc] = v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < B * kTileN; e += kThreads) {
    const int bb = e / kTileN;
    const int col = e % kTileN;
    const int nn = n0 + col;
    if (nn >= N) continue;
    const int g = min(rows[bb], m - 1);
    float y = 0.f;
    if (g >= 0) {
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) y += red[(wp * MAXB + bb) * kTileN + col];
      const float* bg = bmat + static_cast<long long>(g) * r * N + nn;
      const float* pb = p + bb * r;
      for (int j = 0; j < r; ++j) y += pb[j] * bg[static_cast<long long>(j) * N];
    }
    out[static_cast<long long>(bb) * N + nn] = from_f32<T>(y);
  }
}

template <typename T, int MAXB>
void launch_main(bool pair, const int* rows, const T* x, const T* w,
                 const float* bmat, const float* p, T* out, int B, int K,
                 int N, int r, int m, cudaStream_t s) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + MAXB - 1) / MAXB);
  if (pair)
    grouped_gemv_kernel<T, MAXB, true>
        <<<grid, kThreads, 0, s>>>(rows, x, w, bmat, p, out, B, K, N, r, m);
  else
    grouped_gemv_kernel<T, MAXB, false>
        <<<grid, kThreads, 0, s>>>(rows, x, w, bmat, p, out, B, K, N, r, m);
}

template <typename T>
int launch(const void* rows_, const void* x_, const void* w_, const void* a,
           const void* c, const void* bmat, void* p, void* out_, int B, int K,
           int N, int r, int m, float scaling, cudaStream_t s) {
  const int* rows = static_cast<const int*>(rows_);
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  T* out = static_cast<T*>(out_);
  lora_down_kernel<T><<<B, kThreads, 0, s>>>(
      rows, x, static_cast<const float*>(a), static_cast<const float*>(c),
      static_cast<float*>(p), K, r, m, scaling);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool pair = (N % 2 == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % (2 * sizeof(T)) == 0);
  const float* bm = static_cast<const float*>(bmat);
  const float* pp = static_cast<const float*>(p);
  if (B <= 8)
    launch_main<T, 8>(pair, rows, x, w, bm, pp, out, B, K, N, r, m, s);
  else if (B <= 16)
    launch_main<T, 16>(pair, rows, x, w, bm, pp, out, B, K, N, r, m, s);
  else  // groups of 32 rows
    launch_main<T, 32>(pair, rows, x, w, bm, pp, out, B, K, N, r, m, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, W and out).  rows int32 (B,);
// x (B,K), W (K,N), out (B,N) contiguous; bank a (m,K,r), c (m,r,r),
// b (m,r,N) contiguous float32; p is float32 scratch of B*r elements.
// Row indices >= m are not checked: they are clamped to m-1 so that no read
// leaves the bank.  Any batch >= 1 is taken.
// Returns the cudaError_t of the launches.
extern "C" int grouped_gemv_launch(int dtype, const void* rows, const void* x,
                                   const void* w, const void* a, const void* c,
                                   const void* b, void* p, void* out,
                                   int batch, int K, int N, int r, int m,
                                   float scaling, void* stream) {
  if (batch < 1 || batch > kMaxBatch || r < 1 || r > kMaxRank || K < 1 ||
      N < 1 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(rows, x, w, a, c, b, p, out, batch, K, N, r, m,
                         scaling, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rows, x, w, a, c, b, p, out, batch, K, N, r,
                                 m, scaling, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grouped_gemv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
