// The tri-LoRA projection for Hopper (sm_90a): the forward and the two
// big-product cotangents of its backward.
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/tri_lora/tri_lora.py:
//   tri_lora_matmul_kernel  (_kernel,    pallas_call grid (M/bm, N/bn, K/bk))
//   tri_lora_dx_kernel      (_dx_kernel, pallas_call grid (M/bm, K/bk, N/bn))
//   tri_lora_dw_kernel      (_dw_kernel, pallas_call grid (K/bk, N/bn, M/bm))
// each with the contraction as its sequential innermost grid axis and an
// f32 VMEM accumulator.
//
// Computes, with P = s*(x@A)@C and Q = s*(g@B^T)@C^T the (M, r) rank-r
// inputs made outside (plain PyTorch, as the TPU wrapper leaves them to XLA):
//   forward  y  = P@B   + x@W     x (M,K), W (K,N), P (M,r), B (r,N) -> (M,N)
//   dx       dx = Q@A^T + g@W^T   g (M,N), W (K,N), Q (M,r), A (K,r) -> (M,K)
//   dW       dW = x^T@g           x (M,K), g (M,N)                   -> (K,N)
// The f32 accumulator is seeded with the rank-r term first and the large
// product accumulates onto it, the order of the TPU kernels.  Outputs are
// written in the large operands' type (x / g / W share one type); the rank-r
// factor B or A may be of another type (f32 adapters in a bf16 model).
//
// What bounds it on this card: operations.  At the training shape (fed-100m
// wq: M=2048, K=N=768, r=8, f32) the forward does 2.4 GFLOP on ~11 MB of
// operands (~215 flop/byte, far above the f32 ridge of ~20), and f32
// operands must not go through TF32 tensor cores (the parity tolerance is
// 2e-5), so the ceiling is the 67 TFLOP/s of f32 FMAs: 36 us for the
// forward (kernels/bounds.py).  At decode (M = batch rows, K=N=4096, bf16)
// it is the bytes of W.
//
// What the design does about it (a simple kernel; wgmma/TMA tiles for bf16
// are later work):
// * One block of 256 threads per 64x64 output tile.  The TPU's sequential
//   contraction axis becomes a loop inside the block over 32-deep slabs;
//   each thread keeps a 4x4 block of the tile (rows ty+16i, columns tx+16j)
//   in f32 registers, so every pair of shared-memory loads feeds 16 FMAs.
// * Each slab of each operand is staged in shared memory as f32 in
//   [depth][64+1] layout.  The global read runs along whichever axis of the
//   operand is contiguous: along the contraction for x, g and the W^T / A^T
//   operands of dx (W and A are read in place, never transposed in memory,
//   the point of the TPU kernel's transposed index maps), and along the
//   tile's rows for W and B in the forward and for x^T and g in dW.  The
//   padded row keeps both store patterns and the compute reads free of
//   bank conflicts.
// * The rank-r term is one more run of the same slab loop (r <= 64: at
//   most two slabs) over (P, B) or (Q, A^T) before the main product.
// * Operands are read by row strides (unit inner stride).  Rows, columns
//   and depth beyond the real extents read as zero and are not stored, so
//   the ragged M, K and N edges are masked here and nothing is padded.
//
// Each entry point launches on the given stream and returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output rows and columns per block
constexpr int kDepth = 32;    // contraction slab
constexpr int kThreads = 256;
constexpr int kLd = kTile + 1;  // padded shared-memory row

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

// Stage the slab [k0, k0 + 32) of the contraction for tile rows
// [i0, i0 + 64) of an operand into dst[kk * kLd + i] as f32.  DEPTH_CONTIG:
// element (i, kk) lies at src[i * ld + kk] (contiguous along the
// contraction); otherwise at src[kk * ld + i] (contiguous along the rows).
// Positions at or beyond n_i rows or n_k depth read as zero.
template <typename T, bool DEPTH_CONTIG>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src,
                                      long long ld, int i0, int n_i, int k0,
                                      int n_k) {
  for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
    int i, kk;
    if (DEPTH_CONTIG) {
      i = e / kDepth;
      kk = e % kDepth;
    } else {
      kk = e / kTile;
      i = e % kTile;
    }
    const int gi = i0 + i, gk = k0 + kk;
    float v = 0.f;
    if (gi < n_i && gk < n_k)
      v = to_f32(DEPTH_CONTIG ? src[gi * ld + gk] : src[gk * ld + gi]);
    dst[kk * kLd + i] = v;
  }
}

// acc += L[rows, :depth] @ R[:depth, cols] over 32-deep slabs.  L's tile
// rows are the output rows, R's tile rows are the output columns.
template <typename TL, bool L_DEPTH_CONTIG, typename TR, bool R_DEPTH_CONTIG>
__device__ __forceinline__ void accumulate(
    float (&acc)[4][4], float* __restrict__ sl, float* __restrict__ sr,
    const TL* __restrict__ l, long long ldl, const TR* __restrict__ r,
    long long ldr, int row0, int n_rows, int col0, int n_cols, int depth) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k0 = 0; k0 < depth; k0 += kDepth) {
    stage<TL, L_DEPTH_CONTIG>(sl, l, ldl, row0, n_rows, k0, depth);
    stage<TR, R_DEPTH_CONTIG>(sr, r, ldr, col0, n_cols, k0, depth);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sl[kk * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sr[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ out, long long ld,
                                      const float (&acc)[4][4], int row0,
                                      int n_rows, int col0, int n_cols) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < n_cols) out[row * ld + col] = from_f32<T>(acc[i][j]);
    }
  }
}

// y (M,N) = P (M,r) @ B (r,N) + x (M,K) @ W (K,N)
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) tri_lora_fwd_kernel(
    const T* __restrict__ x, long long ldx, const T* __restrict__ w,
    long long ldw, const T* __restrict__ p, long long ldp,
    const S* __restrict__ b, long long ldb, T* __restrict__ y, long long ldy,
    int m, int k, int n, int r) {
  __shared__ float sl[kDepth * kLd], sr[kDepth * kLd];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  accumulate<T, true, S, false>(acc, sl, sr, p, ldp, b, ldb, row0, m, col0,
                                n, r);
  accumulate<T, true, T, false>(acc, sl, sr, x, ldx, w, ldw, row0, m, col0,
                                n, k);
  store(y, ldy, acc, row0, m, col0, n);
}

// dx (M,K) = Q (M,r) @ A^T + g (M,N) @ W^T, with A (K,r) and W (K,N) read
// in place: the element (column kc, depth d) of W^T is w[kc * ldw + d]
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) tri_lora_dx_kernel(
    const T* __restrict__ g, long long ldg, const T* __restrict__ w,
    long long ldw, const T* __restrict__ q, long long ldq,
    const S* __restrict__ a, long long lda, T* __restrict__ dx,
    long long lddx, int m, int k, int n, int r) {
  __shared__ float sl[kDepth * kLd], sr[kDepth * kLd];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  accumulate<T, true, S, true>(acc, sl, sr, q, ldq, a, lda, row0, m, col0,
                               k, r);
  accumulate<T, true, T, true>(acc, sl, sr, g, ldg, w, ldw, row0, m, col0,
                               k, n);
  store(dx, lddx, acc, row0, m, col0, k);
}

// dW (K,N) = x^T @ g with x (M,K) read in place: the element (row kr,
// depth d) of x^T is x[d * ldx + kr]; M is the contraction
template <typename T>
__global__ void __launch_bounds__(kThreads) tri_lora_dw_kernel(
    const T* __restrict__ x, long long ldx, const T* __restrict__ g,
    long long ldg, T* __restrict__ dw, long long lddw, int m, int k, int n) {
  __shared__ float sl[kDepth * kLd], sr[kDepth * kLd];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  accumulate<T, false, T, false>(acc, sl, sr, x, ldx, g, ldg, row0, k, col0,
                                 n, m);
  store(dw, lddw, acc, row0, k, col0, n);
}

dim3 grid_of(int rows, int cols) {
  return dim3((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
}

bool bad_extent(int rows, int cols) {
  return rows < 1 || cols < 1 || (rows + kTile - 1) / kTile > 65535;
}

template <typename T, typename S>
cudaError_t fwd(const void* x, long long ldx, const void* w, long long ldw,
                const void* p, long long ldp, const void* b, long long ldb,
                void* y, long long ldy, int m, int k, int n, int r,
                cudaStream_t s) {
  tri_lora_fwd_kernel<T, S><<<grid_of(m, n), kThreads, 0, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(w), ldw,
      static_cast<const T*>(p), ldp, static_cast<const S*>(b), ldb,
      static_cast<T*>(y), ldy, m, k, n, r);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dx(const void* g, long long ldg, const void* w, long long ldw,
               const void* q, long long ldq, const void* a, long long lda,
               void* out, long long ldo, int m, int k, int n, int r,
               cudaStream_t s) {
  tri_lora_dx_kernel<T, S><<<grid_of(m, k), kThreads, 0, s>>>(
      static_cast<const T*>(g), ldg, static_cast<const T*>(w), ldw,
      static_cast<const T*>(q), ldq, static_cast<const S*>(a), lda,
      static_cast<T*>(out), ldo, m, k, n, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw(const void* x, long long ldx, const void* g, long long ldg,
               void* out, long long ldo, int m, int k, int n,
               cudaStream_t s) {
  tri_lora_dw_kernel<T><<<grid_of(k, n), kThreads, 0, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(g), ldg,
      static_cast<T*>(out), ldo, m, k, n);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `dtype` is the type of x, W, P
// and y; `small_dtype` the type of B.
extern "C" int tri_lora_fwd_launch(int dtype, int small_dtype, const void* x,
                                   long long ldx, const void* w,
                                   long long ldw, const void* p,
                                   long long ldp, const void* b,
                                   long long ldb, void* y, long long ldy,
                                   int m, int k, int n, int r, void* stream) {
  if (bad_extent(m, n) || k < 1 || r < 1 || r > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && small_dtype == 0)
    err = fwd<float, float>(x, ldx, w, ldw, p, ldp, b, ldb, y, ldy, m, k, n,
                            r, s);
  else if (dtype == 0 && small_dtype == 1)
    err = fwd<float, __nv_bfloat16>(x, ldx, w, ldw, p, ldp, b, ldb, y, ldy,
                                    m, k, n, r, s);
  else if (dtype == 1 && small_dtype == 0)
    err = fwd<__nv_bfloat16, float>(x, ldx, w, ldw, p, ldp, b, ldb, y, ldy,
                                    m, k, n, r, s);
  else if (dtype == 1 && small_dtype == 1)
    err = fwd<__nv_bfloat16, __nv_bfloat16>(x, ldx, w, ldw, p, ldp, b, ldb,
                                            y, ldy, m, k, n, r, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// `dtype` is the type of g, W, Q and dx; `small_dtype` the type of A.
extern "C" int tri_lora_dx_launch(int dtype, int small_dtype, const void* g,
                                  long long ldg, const void* w, long long ldw,
                                  const void* q, long long ldq, const void* a,
                                  long long lda, void* out, long long ldo,
                                  int m, int k, int n, int r, void* stream) {
  if (bad_extent(m, k) || n < 1 || r < 1 || r > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && small_dtype == 0)
    err = dx<float, float>(g, ldg, w, ldw, q, ldq, a, lda, out, ldo, m, k, n,
                           r, s);
  else if (dtype == 0 && small_dtype == 1)
    err = dx<float, __nv_bfloat16>(g, ldg, w, ldw, q, ldq, a, lda, out, ldo,
                                   m, k, n, r, s);
  else if (dtype == 1 && small_dtype == 0)
    err = dx<__nv_bfloat16, float>(g, ldg, w, ldw, q, ldq, a, lda, out, ldo,
                                   m, k, n, r, s);
  else if (dtype == 1 && small_dtype == 1)
    err = dx<__nv_bfloat16, __nv_bfloat16>(g, ldg, w, ldw, q, ldq, a, lda,
                                           out, ldo, m, k, n, r, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// `dtype` is the type of x, g and dW.
extern "C" int tri_lora_dw_launch(int dtype, const void* x, long long ldx,
                                  const void* g, long long ldg, void* out,
                                  long long ldo, int m, int k, int n,
                                  void* stream) {
  if (bad_extent(k, n) || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dw<float>(x, ldx, g, ldg, out, ldo, m, k, n, s);
  else if (dtype == 1)
    err = dw<__nv_bfloat16>(x, ldx, g, ldg, out, ldo, m, k, n, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* tri_lora_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
