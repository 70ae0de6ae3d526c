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
// factor B or A may be of another type (f32 adapters in a bf16 model) and is
// never rounded to the large operands' type.
//
// What bounds it on this card: operations.  In bf16 (the rwkv6-1.6b
// prefill, M=4096 K=N=2048 r=8) the forward does 34.5 GFLOP on 42 MB: 34.9
// us at the 989 TFLOP/s of the bf16 tensor cores.  In f32 (fed-100m wq,
// M=2048 K=N=768) it does 2.4 GFLOP on ~15 MB, and f32 operands must not go
// through TF32 (the parity tolerance is 2e-5), so the ceiling is the 67
// TFLOP/s of f32 FMAs: 36 us for the forward, dx and dW (12 us for dx and
// dW at wk/wv, N = 256).  At decode (M = 8 rows) the forward is bound by
// the bytes of W (kernels/bounds.py).
//
// What the designs do about it.  The forward has two routes, chosen by the
// caller from the operands' type and layout before the launch (ops.py):
// * wgmma (bf16 x and W whose base and row stride TMA can address: 16-byte
//   aligned): a 128x256 output tile per block (64x128 for M <= 64, which
//   spreads W over more blocks).  One producer warp issues TMA loads
//   (cp.async.bulk.tensor) of the x tile (K-major) and of W in 64-column
//   boxes (N-major: W is read in place, never transposed) into a ring of 4
//   shared-memory stages of 64-deep slabs, each guarded by a full and an
//   empty mbarrier; one or two consumer warpgroups run wgmma.mma_async
//   m64nNk16 (bf16 -> f32) on the stages that have arrived, one stage's
//   products in flight while the next is waited for.  The tensor maps and
//   the wgmma descriptors both use the 128-byte swizzle.  Before the first
//   wgmma the consumers write P@B into the accumulator registers with f32
//   FMAs, at the (row, column) the wgmma fragment layout gives each
//   register: 8 ranks at a time, P and B (f32 or bf16 as given, never
//   rounded) are staged as f32 in shared memory with one round of loads,
//   so the seed pays one load latency per 8 ranks, not one per rank.  The
//   first stage is issued before the main loop, so the loop carries only
//   accumulators that wgmma defined and ptxas does not serialise the
//   wgmmas.  TMA fills loads beyond M, N or K with zeros; the epilogue
//   casts to bf16 and masks the ragged M and N edges.  The tensor maps are
//   encoded on the host at each call (~2 us), through the driver's
//   cuTensorMapEncodeTiled found by cudaGetDriverEntryPoint (no -lcuda).
//   What paces it: the L2 reads of the tiles (a 128x256 tile reads 3/4 of
//   the bytes per product that a 128x128 tile reads).
// * simt (f32, and bf16 that TMA cannot address): register-tiled f32 FMAs.
//   A block of 128 threads owns a 64x64 output tile and each thread a 4x8
//   micro-tile, so three float4 shared-memory reads feed 32 FMAs and the
//   fed-100m shapes still give each SM 4-12 warps.  The contraction runs
//   in 32-deep slabs through a ring of 3 (two in flight, one barrier a
//   slab), filled with cp.async: W along its rows and x along its rows as
//   [row][depth], 16 bytes a copy where aligned (4 otherwise), so neither
//   is transposed; a thread's 4 rows lie 16 apart, which keeps its float4
//   reads of x along the depth free of bank conflicts.  bf16 is widened to
//   f32 through registers.  Each thread fixes its copy offsets and edge
//   masks once, so a slab costs it a few instructions per copy.  The seed
//   P@B comes first, read from L2 in B's own type.
// dx runs the same SIMT micro-kernel with W^T as its right-hand operand:
// dx's output column kc is W's row kc and the contraction runs along W's
// rows, so g and W are both staged as [row][depth] by 16-byte cp.async
// along N (neither is transposed).  Each thread owns the columns t%8 + 8j
// (j < 8), so the 8 threads of a quarter-warp read float4s of 8 W rows
// kLdX = 36 floats apart, on 8 disjoint groups of banks; 12 float4 reads
// feed 128 FMAs, the forward's ratio.  The seed Q@A^T comes first, A read
// in its own type.
// dW splits the M contraction over S <= 8 blocks per output tile, so that
// the tiles x S blocks fill the card in one wave (the caller picks S from
// the occupancy calculator, ops.dw_plan and tri_lora_dw_capacity): each
// block runs the SIMT micro-kernel over its M range in 32-deep slabs, one
// in flight (x^T and g both staged along their rows, 16 bytes a copy, so x
// is read in place).  The S blocks of a tile form one thread-block
// cluster: each writes its f32 partial into its own shared memory, and
// block q sums its share of the tile over the blocks 0..S-1 in rank order
// through distributed shared memory, casts and stores.  No scratch, no
// atomics, one launch; dW is bitwise the same from run to run (the TPU
// carried this sum sequentially).  One split writes dW directly.  dW stays
// on f32 FMAs in both types.  What paces it beside cuBLAS: clusters of 3
// or more blocks run on at most 124 of the H100's 132 SMs, and the tiles
// x S blocks do not spread evenly over them.
//
// Grouped forms (vectorized clients): the forward and dx also run with one
// rank-r factor per group of rows, where the M rows are the folded batches
// of m clients and row i applies client groups[i / rows] (the TPU side runs
// one kernel per client under jax.vmap; here the clients share one launch).
// Only the seed changes: y[i] = x[i]@W + P[i]@B[g(i)] and dx[i] = g[i]@W^T
// + Q[i]@A[g(i)]^T, with P and Q made per client outside.  The factor of
// group g lies a client stride past group 0's, so a strided view of a
// stacked client state is read in place.  A SIMT tile whose 64 rows lie in
// one group (a vote of the block) reads that group's factor as the
// single-adapter seed does; a tile that straddles two groups reads each
// row's own.  The wgmma forward takes groups only where its tiles cannot
// straddle (rows a multiple of the tile's rows; the caller routes other
// shapes to SIMT) and stages its block's group's B.  A row whose group is
// negative gets no delta and keeps x@W (the JAX dense semantics; unlike
// the grouped GEMV's zero rows, this is a training path).
//
// Operands are read by row strides (unit inner stride).  Rows, columns and
// depth beyond the real extents read as zero and are not stored, so the
// ragged M, K and N edges are masked here and nothing is padded.
//
// Each entry point launches on the given stream and returns the
// cudaError_t of the launch.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

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

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// The rank-r factor (B of the forward, A of dx) each row applies.  Row i
// applies group idx[i / rows] (a client), whose factor lies `stride`
// elements past group 0's; a negative group applies none, so the row's
// seed is zero and it keeps x@W (g@W^T).  idx == nullptr: every row
// applies the one factor given.
struct Groups {
  const int* idx;
  int rows;
  long long stride;
};

__device__ __forceinline__ int group_of(const Groups& gr, int row) {
  return gr.idx == nullptr ? 0 : __ldg(gr.idx + row / gr.rows);
}

// ---------------------------------------------------------------------------
// Register-tiled SIMT product: the forward in f32 (and in bf16 that TMA
// cannot address), dx, and dW
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kThreads = 128;  // a 4x8 micro-tile each
constexpr int kLd = 64 + 4;    // shared row: 64 floats, 16-byte aligned pad

// BK-deep slabs in a ring of ST stages (ST - 1 in flight).  XR: the row
// operand is staged as [row][depth] (the forward's x and dx's g, read in
// place along their rows), else as [depth][row] (dW's x^T, read along x's
// rows).  WR: the column operand too is staged as [column][depth] (dx's
// W^T: W's rows are dx's columns), else as [depth][column].
template <int BK_, int ST_, bool XR_, bool WR_ = false>
struct Geo {
  static constexpr int BK = BK_, ST = ST_;
  static constexpr bool XR = XR_, WR = WR_;
  static constexpr int kLdX = BK + 4;
  static constexpr int kABuf = XR ? kBM * kLdX : BK * kLd;
  static constexpr int kBuf = WR ? kBN * kLdX : BK * kLd;
  static constexpr int kSmem = ST * (kABuf + kBuf) * 4;
};
// The forward and dx: 32-deep slabs, two in flight (their grids are small,
// so each block needs more bytes in flight).  dW: 32-deep slabs, one in
// flight, so that 6 blocks fit an SM (measured best of 16- and 32-deep
// slabs in rings of 2 to 4).
using FwdGeo = Geo<32, 3, true>;
using DxGeo = Geo<32, 3, true, true>;
using DwGeo = Geo<32, 2, false>;

// Thread t owns rows t/8 + 16*i (XR) or 4*(t/8) + i (i < 4) of the tile,
// and columns t%8 + 8*j (WR) or {4*(t%8) + j, 32 + 4*(t%8) + j} (j < 4).
// A warp's float4 reads of a slab row of B (as [depth][column]) touch 8
// consecutive float4s and of A (as [depth][row]) 4, broadcast.  As
// [row][depth] a quarter-warp reads one row of A (broadcast) and, for WR,
// 8 rows of B kLdX = BK + 4 floats apart, on 8 disjoint groups of banks.
template <class G>
__device__ __forceinline__ int row_of(int i) {
  if constexpr (G::XR) return static_cast<int>(threadIdx.x) / 8 + 16 * i;
  return 4 * (static_cast<int>(threadIdx.x) / 8) + i;
}
template <class G>
__device__ __forceinline__ int col_of(int j) {
  if constexpr (G::WR) return static_cast<int>(threadIdx.x) % 8 + 8 * j;
  return (j < 4 ? 0 : 32) + 4 * (static_cast<int>(threadIdx.x) % 8) + (j & 3);
}

// cp.async of 4 or 16 bytes; `bytes` below the copy's size zero-fills the
// rest (bytes = 0: zeros, the source unread)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
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

// This thread's share of staging one operand's slab along the tile's
// columns: the element (depth d, column c) lies at src[d * ld + c] (the
// forward's W, dW's x^T and g) and goes to [d - d0][c - c0].  VEC: 16-byte
// copies (f32, base and row stride 16-byte aligned); otherwise one element
// a copy.  f32 by cp.async, bf16 widened through registers.  Offsets and
// the column mask are fixed once; a slab adds only its depth.
template <class G, typename T, bool VEC>
struct AlongRows {
  static constexpr int kE = VEC ? 4 : 1;               // elements a copy
  static constexpr int kPerRow = 64 / kE;              // copies a slab row
  static constexpr int kStep = kThreads / kPerRow;     // slab rows apart
  static constexpr int kN = G::BK / kStep;             // copies a slab
  const T* base;          // the operand (a valid address for masked copies)
  const T* col;           // this thread's first element of depth 0
  long long ld;
  int kk0, bytes;         // first slab row; bytes of the column chunk
  int dst;                // float offset in a stage
  __device__ __forceinline__ AlongRows(const T* src, long long ld_, int c0,
                                       int n_cols)
      : base(src), ld(ld_) {
    const int t = threadIdx.x, c = (t % kPerRow) * kE;
    kk0 = t / kPerRow;
    col = src + c0 + c;
    bytes = static_cast<int>(sizeof(T)) * max(0, min(kE, n_cols - c0 - c));
    dst = kk0 * kLd + c;
  }
  __device__ __forceinline__ void copy(float* stage, int d0, int n_depth) {
    const T* p = col + (d0 + kk0) * ld;
#pragma unroll
    for (int i = 0; i < kN; ++i, p += kStep * ld) {
      const int b = d0 + kk0 + i * kStep < n_depth ? bytes : 0;
      float* to = stage + dst + i * kStep * kLd;
      if constexpr (sizeof(T) == 2)
        *to = b ? __bfloat162float(*p) : 0.f;
      else if constexpr (VEC)
        cp_async16(smem_u32(to), b ? static_cast<const void*>(p) : base, b);
      else
        cp_async4(smem_u32(to), b ? static_cast<const void*>(p) : base, b);
    }
  }
};

// This thread's share of staging an operand as [row][depth] (the forward's
// x, dx's g and W): the element (row i, depth d) lies at src[i * ld + d]
// and goes to [i - r0][d - d0], 16 bytes a copy when VEC; the row mask is
// fixed once.
template <class G, typename T, bool VEC>
struct RowsByDepth {
  static constexpr int kE = VEC ? 4 : 1;
  static constexpr int kPerRow = G::BK / kE;           // copies a row
  static constexpr int kStep = kThreads / kPerRow;     // rows apart
  static constexpr int kN = kBM / kStep;               // copies a slab
  const T* base;
  const T* row;
  long long ld;
  int dd, dst;
  unsigned rows_ok;
  __device__ __forceinline__ RowsByDepth(const T* src, long long ld_, int r0,
                                         int n_rows)
      : base(src), ld(ld_) {
    const int t = threadIdx.x, i0 = t / kPerRow;
    dd = (t % kPerRow) * kE;
    row = src + (r0 + i0) * ld + dd;
    dst = i0 * G::kLdX + dd;
    rows_ok = 0;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      rows_ok |= (r0 + i0 + n * kStep < n_rows ? 1u : 0u) << n;
  }
  __device__ __forceinline__ void copy(float* stage, int d0, int n_depth) {
    const int bytes =
        static_cast<int>(sizeof(T)) * max(0, min(kE, n_depth - d0 - dd));
    const T* p = row + d0;
#pragma unroll
    for (int n = 0; n < kN; ++n, p += kStep * ld) {
      const int b = (rows_ok >> n) & 1u ? bytes : 0;
      float* to = stage + dst + n * kStep * G::kLdX;
      if constexpr (sizeof(T) == 2)
        *to = b ? __bfloat162float(*p) : 0.f;
      else if constexpr (VEC)
        cp_async16(smem_u32(to), b ? static_cast<const void*>(p) : base, b);
      else
        cp_async4(smem_u32(to), b ? static_cast<const void*>(p) : base, b);
    }
  }
};

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc += the slab's rows x columns product, each operand as its Geo lays
// it out; each accumulator takes the slab's depths in order
template <class G>
__device__ __forceinline__ void slab_product(float (&acc)[4][8],
                                             const float* __restrict__ a,
                                             const float* __restrict__ b) {
  if constexpr (G::WR) {
    static_assert(G::XR, "a [column][depth] B pairs with a [row][depth] A");
    const int tr = static_cast<int>(threadIdx.x) / 8;
    const int tc = static_cast<int>(threadIdx.x) % 8;
#pragma unroll
    for (int k4 = 0; k4 < G::BK; k4 += 4) {
      float4 a4[4], b4[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a4[i] = *reinterpret_cast<const float4*>(a + (tr + 16 * i) * G::kLdX +
                                                 k4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b4[j] = *reinterpret_cast<const float4*>(b + (tc + 8 * j) * G::kLdX +
                                                 k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = lane_of(a4[i], kq);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av, lane_of(b4[j], kq), acc[i][j]);
        }
    }
    return;
  }
  const int ar = 4 * (static_cast<int>(threadIdx.x) / 8);
  const int bc = 4 * (static_cast<int>(threadIdx.x) % 8);
  if constexpr (G::XR) {
    const int tr = static_cast<int>(threadIdx.x) / 8;
#pragma unroll
    for (int k4 = 0; k4 < G::BK; k4 += 4) {
      float4 a4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a4[i] = *reinterpret_cast<const float4*>(a + (tr + 16 * i) * G::kLdX +
                                                 k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int kk = k4 + kq;
        const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kLd + bc);
        const float4 b1 =
            *reinterpret_cast<const float4*>(b + kk * kLd + 32 + bc);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = lane_of(a4[i], kq);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int kk = 0; kk < G::BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kLd + ar);
    const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kLd + bc);
    const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kLd + 32 + bc);
    const float av[4] = {a0.x, a0.y, a0.z, a0.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc += L[rows, d] @ R[d, cols] over the depth [d_begin, d_end) through the
// ring of G::ST slabs (L's stages first in `smem`, then R's), one barrier a
// slab
template <class G, class SL, class SR>
__device__ __forceinline__ void mainloop(float (&acc)[4][8], float* smem,
                                         SL& l, SR& r, int d_begin,
                                         int d_end) {
  const int slabs = (d_end - d_begin + G::BK - 1) / G::BK;
  auto issue = [&](int s) {            // slab s into stage s % ST
    if (s < slabs) {
      const int d0 = d_begin + s * G::BK, st = s % G::ST;
      l.copy(smem + st * G::kABuf, d0, d_end);
      r.copy(smem + G::ST * G::kABuf + st * G::kBuf, d0, d_end);
    }
    cp_async_commit();                 // empty groups keep the count uniform
  };
#pragma unroll
  for (int s = 0; s < G::ST - 1; ++s) issue(s);
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<G::ST - 2>();        // slab s has landed
    __syncthreads();                   // ... for all; stage s - 1 is free
    issue(s + G::ST - 1);
    const int st = s % G::ST;
    slab_product<G>(acc, smem + st * G::kABuf,
                    smem + G::ST * G::kABuf + st * G::kBuf);
  }
}

// out[row, col] = acc for the tile's rows < n_rows and columns < n_cols;
// float4 stores where `vec` (f32 out, 16-byte aligned base and row stride,
// and the [4*(t%8)] column map), else one element a store
template <class G, typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, long long ld,
                                           const float (&acc)[4][8],
                                           int row0, int n_rows, int col0,
                                           int n_cols, bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + row_of<G>(i);
    if (row >= n_rows) continue;
    if constexpr (G::WR) {      // a warp stores 4 rows of 8 columns a step
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + col_of<G>(j);
        if (col < n_cols) out[row * ld + col] = from_f32<T>(acc[i][j]);
      }
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + col_of<G>(4 * h);
      T* dst = out + row * ld + col;
      if constexpr (sizeof(T) == 4) {
        if (vec && col + 3 < n_cols) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n_cols) dst[j] = from_f32<T>(acc[i][4 * h + j]);
    }
  }
}

// acc = L (M,r) @ R^T, R (cols,r) at rt[col * col_stride + q * q_stride]:
// the rank-r seed of the forward (R = B^T, strides 1 and ldb) and of dx
// (R = A, strides lda and 1), read from L2 in the factor's own type, rank
// by rank.  With groups, row i reads the R of its group (gr): when the
// tile's rows all lie in one group (one vote of the block), the tile reads
// that group's R as above; a tile that straddles groups reads each row's
// own R (4x the loads, on the tiles at a group's edge only).
template <class G, typename T, typename S>
__device__ __forceinline__ void seed(float (&acc)[4][8],
                                     const T* __restrict__ l, long long ldl,
                                     const S* __restrict__ rt,
                                     long long col_stride, long long q_stride,
                                     const Groups& gr, int row0, int n_rows,
                                     int col0, int n_cols, int r) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int g0 = group_of(gr, row0);
  int grp[4];
  bool one = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + row_of<G>(i);
    grp[i] = row < n_rows ? group_of(gr, row) : g0;
    one = one && grp[i] == g0;
  }
  // gr.idx is a kernel argument, so the whole block takes one branch
  if (gr.idx != nullptr && !__syncthreads_and(one)) {
#pragma unroll 1
    for (int q = 0; q < r; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + row_of<G>(i);
        if (grp[i] < 0) continue;
        const float pv = row < n_rows ? to_f32(l[row * ldl + q]) : 0.f;
        const S* ri = rt + grp[i] * gr.stride;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + col_of<G>(j);
          const float bv =
              col < n_cols ? to_f32(ri[col * col_stride + q * q_stride]) : 0.f;
          acc[i][j] = fmaf(pv, bv, acc[i][j]);
        }
      }
    }
    return;
  }
  if (g0 < 0) return;
  rt += g0 * gr.stride;
#pragma unroll 4
  for (int q = 0; q < r; ++q) {
    float pv[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + row_of<G>(i);
      pv[i] = row < n_rows ? to_f32(l[row * ldl + q]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + col_of<G>(j);
      bv[j] = col < n_cols ? to_f32(rt[col * col_stride + q * q_stride])
                           : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], bv[j], acc[i][j]);
  }
}

// y (M,N) = P (M,r) @ B (r,N) + x (M,K) @ W (K,N): the seed P@B first, read
// from L2 in B's own type, then the slabs of x@W.  VEC: W by 16-byte
// copies; XVEC: x too.
template <typename T, typename S, bool VEC, bool XVEC>
__global__ void __launch_bounds__(kThreads) tri_lora_fwd_simt_kernel(
    const T* __restrict__ x, long long ldx, const T* __restrict__ w,
    long long ldw, const T* __restrict__ p, long long ldp,
    const S* __restrict__ b, long long ldb, Groups gr, T* __restrict__ y,
    long long ldy, bool y_vec, int m, int k, int n, int r) {
  using G = FwdGeo;
  extern __shared__ float4 smem_f4[];
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][8];
  seed<G>(acc, p, ldp, b, 1, ldb, gr, row0, m, col0, n, r);
  RowsByDepth<G, T, XVEC> xs(x, ldx, row0, m);
  AlongRows<G, T, VEC> ws(w, ldw, col0, n);
  mainloop<G>(acc, reinterpret_cast<float*>(smem_f4), xs, ws, 0, k);
  store_tile<G>(y, ldy, acc, row0, m, col0, n, y_vec);
}

// dx (M,K) = Q (M,r) @ A^T + g (M,N) @ W^T: the seed Q@A^T first (A (K,r)
// in its own type), then the slabs of g@W^T with g and W both read in
// place along their rows (N).  GVEC / WVEC: g / W by 16-byte copies.
template <typename T, typename S, bool GVEC, bool WVEC>
__global__ void __launch_bounds__(kThreads) tri_lora_dx_simt_kernel(
    const T* __restrict__ g, long long ldg, const T* __restrict__ w,
    long long ldw, const T* __restrict__ q, long long ldq,
    const S* __restrict__ a, long long lda, Groups gr, T* __restrict__ dx,
    long long lddx, int m, int k, int n, int r) {
  using G = DxGeo;
  extern __shared__ float4 smem_f4[];
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][8];
  seed<G>(acc, q, ldq, a, lda, 1, gr, row0, m, col0, k, r);
  RowsByDepth<G, T, GVEC> gs(g, ldg, row0, m);
  RowsByDepth<G, T, WVEC> ws(w, ldw, col0, k);
  mainloop<G>(acc, reinterpret_cast<float*>(smem_f4), gs, ws, 0, n);
  store_tile<G>(dx, lddx, acc, row0, m, col0, k, false);
}

// dW (K,N) = x^T @ g, x (M,K) read in place; block z runs the M range
// [z*depth, min(M, (z+1)*depth)).  One split (gridDim.z = 1) stores its
// tile.  Otherwise the S blocks of a tile are one cluster (1, 1, S), rank
// z = blockIdx.z: each writes its f32 partial into its own shared memory,
// and rank z sums its share of the tile's float4s over the ranks 0..S-1 in
// that order, casts and stores.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) tri_lora_dw_kernel(
    const T* __restrict__ x, long long ldx, const T* __restrict__ g,
    long long ldg, T* __restrict__ dw, long long lddw, bool o_vec, int m,
    int k, int n, int depth) {
  using G = DwGeo;
  constexpr int kNV = kBM * kBN / 4;             // float4s of a tile
  static_assert(G::kSmem >= kNV * 16, "the partial reuses the ring");
  __shared__ __align__(16) float smem[G::kSmem / 4];
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int d0 = blockIdx.z * depth, d1 = min(m, d0 + depth);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  AlongRows<G, T, VEC> xs(x, ldx, row0, k);
  AlongRows<G, T, VEC> gs(g, ldg, col0, n);
  mainloop<G>(acc, smem, xs, gs, d0, d1);
  if (gridDim.z == 1) {
    store_tile<G>(dw, lddw, acc, row0, k, col0, n, o_vec);
    return;
  }

  cg::cluster_group cluster = cg::this_cluster();
  float* part = smem;                  // [64][64] f32
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the partial
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + row_of<G>(i) * kBN +
                                 col_of<G>(4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  cluster.sync();                      // every partial of the tile is written

  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int share = (kNV + ranks - 1) / ranks;
  const int end = min(kNV, (rank + 1) * share);
  for (int e = rank * share + static_cast<int>(threadIdx.x); e < end;
       e += kThreads) {
    float4 sum = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0))[e];
    for (int z = 1; z < ranks; ++z) {
      const float4 v = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, z))[e];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int row = row0 + e / (kBN / 4), col = col0 + 4 * (e % (kBN / 4));
    if (row >= k) continue;
    T* dst = dw + row * lddw + col;
    if constexpr (sizeof(T) == 4) {
      if (o_vec && col + 3 < n) {
        *reinterpret_cast<float4*>(dst) = sum;
        continue;
      }
    }
    const float f[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < n) dst[j] = from_f32<T>(f[j]);
  }
  cluster.sync();                      // no block leaves while read
}

bool aligned16(const void* ptr, long long ld, int elem) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (ld * elem) % 16 == 0;
}

template <typename T, typename S, bool VEC, bool XVEC>
cudaError_t fwd_launch(const void* x, long long ldx, const void* w,
                       long long ldw, const void* p, long long ldp,
                       const void* b, long long ldb, Groups gr, void* y,
                       long long ldy, int m, int k, int n, int r,
                       cudaStream_t s) {
  constexpr int smem = FwdGeo::kSmem;                  // above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      tri_lora_fwd_simt_kernel<T, S, VEC, XVEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  tri_lora_fwd_simt_kernel<T, S, VEC, XVEC><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(w), ldw,
      static_cast<const T*>(p), ldp, static_cast<const S*>(b), ldb, gr,
      static_cast<T*>(y), ldy, sizeof(T) == 4 && aligned16(y, ldy, 4), m, k,
      n, r);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t fwd(const void* x, long long ldx, const void* w, long long ldw,
                const void* p, long long ldp, const void* b, long long ldb,
                Groups gr, void* y, long long ldy, int m, int k, int n, int r,
                cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (aligned16(w, ldw, 4) && aligned16(x, ldx, 4))
      return fwd_launch<T, S, true, true>(x, ldx, w, ldw, p, ldp, b, ldb, gr,
                                          y, ldy, m, k, n, r, s);
    if (aligned16(w, ldw, 4))
      return fwd_launch<T, S, true, false>(x, ldx, w, ldw, p, ldp, b, ldb, gr,
                                           y, ldy, m, k, n, r, s);
  }
  return fwd_launch<T, S, false, false>(x, ldx, w, ldw, p, ldp, b, ldb, gr, y,
                                        ldy, m, k, n, r, s);
}

template <typename T, typename S, bool GVEC, bool WVEC>
cudaError_t dx_launch(const void* g, long long ldg, const void* w,
                      long long ldw, const void* q, long long ldq,
                      const void* a, long long lda, Groups gr, void* out,
                      long long ldo, int m, int k, int n, int r,
                      cudaStream_t s) {
  constexpr int smem = DxGeo::kSmem;                   // above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      tri_lora_dx_simt_kernel<T, S, GVEC, WVEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((k + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  tri_lora_dx_simt_kernel<T, S, GVEC, WVEC><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(g), ldg, static_cast<const T*>(w), ldw,
      static_cast<const T*>(q), ldq, static_cast<const S*>(a), lda, gr,
      static_cast<T*>(out), ldo, m, k, n, r);
  return cudaGetLastError();
}

// 16-byte copies of g and of W wherever each is aligned (f32); bf16 is
// widened through registers one element a copy
template <typename T, typename S>
cudaError_t dx(const void* g, long long ldg, const void* w, long long ldw,
               const void* q, long long ldq, const void* a, long long lda,
               Groups gr, void* out, long long ldo, int m, int k, int n, int r,
               cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    const bool gv = aligned16(g, ldg, 4), wv = aligned16(w, ldw, 4);
    if (gv && wv)
      return dx_launch<T, S, true, true>(g, ldg, w, ldw, q, ldq, a, lda, gr,
                                         out, ldo, m, k, n, r, s);
    if (gv)
      return dx_launch<T, S, true, false>(g, ldg, w, ldw, q, ldq, a, lda, gr,
                                          out, ldo, m, k, n, r, s);
    if (wv)
      return dx_launch<T, S, false, true>(g, ldg, w, ldw, q, ldq, a, lda, gr,
                                          out, ldo, m, k, n, r, s);
  }
  return dx_launch<T, S, false, false>(g, ldg, w, ldw, q, ldq, a, lda, gr,
                                       out, ldo, m, k, n, r, s);
}

// grid (N/64, K/64, S); with S > 1 a cluster of (1, 1, S) blocks
template <typename T, bool VEC>
cudaError_t dw_launch(const void* x, long long ldx, const void* g,
                      long long ldg, void* out, long long ldo, int m, int k,
                      int n, int splits, int depth, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kBN - 1) / kBN, (k + kBM - 1) / kBM, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tri_lora_dw_kernel<T, VEC>, static_cast<const T*>(x), ldx,
      static_cast<const T*>(g), ldg, static_cast<T*>(out), ldo,
      sizeof(T) == 4 && aligned16(out, ldo, 4), m, k, n, depth);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw(const void* x, long long ldx, const void* g, long long ldg,
               void* out, long long ldo, int m, int k, int n, int splits,
               int depth, cudaStream_t s) {
  if constexpr (sizeof(T) == 4)
    if (aligned16(x, ldx, 4) && aligned16(g, ldg, 4))
      return dw_launch<T, true>(x, ldx, g, ldg, out, ldo, m, k, n, splits,
                                depth, s);
  return dw_launch<T, false>(x, ldx, g, ldg, out, ldo, m, k, n, splits, depth,
                             s);
}

}  // namespace simt

// the grids put 64-row tiles along y, at most 65,535 of them
bool bad_extent(int rows, int cols) {
  return rows < 1 || cols < 1 || (rows + simt::kBM - 1) / simt::kBM > 65535;
}

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores: TMA ring, wgmma consumers
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBK = 64;      // contraction per stage
constexpr int kBox = 64;     // bf16 in one 128-byte swizzled row of a box
constexpr int kStages = 4;
constexpr int kRowBytes = kBox * 2;
constexpr int kSeedQ = 8;    // ranks of the seed staged at a time

// NWG consumer warpgroups of 64 rows each, then one producer warp; BN
// output columns, BN/64 boxes of W a stage
template <int NWG, int BN>
struct Cfg {
  static constexpr int kBM = 64 * NWG;
  static constexpr int kBoxes = BN / kBox;
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kXBytes = kBM * kRowBytes;           // kBM x 64 of x
  static constexpr int kWBytes = kBoxes * kBK * kRowBytes;  // 64 x BN of W
  static constexpr int kStageBytes = kXBytes + kWBytes;
  // the seed's staging: kSeedQ ranks of P (kBM x kSeedQ) and B (kSeedQ x BN)
  static constexpr int kSeedBytes = (kBM + BN) * kSeedQ * 4;
  // stages aligned to the 1024-byte swizzle period, 2*kStages barriers, the
  // seed's staging
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + 16 * kStages + kSeedBytes;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`; a
// phase that never completes (a lost transaction) traps after ~2^26 polls,
// so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
// box at coordinates (c0 inner, c1 outer) of `map` into shared memory,
// completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// barrier 1 over the consumer warpgroups alone (the producer warp has
// left)
template <int THREADS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64x16, K-major) @ B (16x128, N-major), bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_m64nNk16(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64x16, K-major) @ B (16x256, N-major), bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_m64nNk16(float (&d)[128], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Wait for stage kt's tiles, then issue its four m64nBNk16 products onto d
// and commit them as one group
template <int NWG, int BN>
__device__ __forceinline__ void stage_products(float (&d)[BN / 2],
                                               uint32_t base, uint32_t full,
                                               int kt) {
  using C = Cfg<NWG, BN>;
  const int s = kt % kStages;
  mbar_wait(full + 8 * s, (kt / kStages) & 1);
  const uint32_t sx = base + s * C::kStageBytes +
                      (threadIdx.x / 128) * 64 * kRowBytes;
  const uint32_t sw = base + s * C::kStageBytes + C::kXBytes;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    // x: +32 bytes per 16-deep step inside the swizzled row, 8-row groups
    // 1024 bytes apart; W: +16 rows per step, its 64-column boxes kBK rows
    // apart, 8-row groups 1024 bytes apart
    wgmma_m64nNk16(d, smem_desc(sx + 32 * kk, 16, 1024),
                     smem_desc(sw + 16 * kk * kRowBytes, kBK * kRowBytes,
                               1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// y (M,N) = P (M,r) @ B (r,N) + x (M,K) @ W (K,N), bf16 x / W / P / y.
// With groups, the caller guarantees that a tile's kBM rows lie in one
// group (gr.rows a multiple of kBM): the block reads its group once and
// stages that group's B (none for a negative group).
template <int NWG, int BN, typename S>
__global__ void __launch_bounds__(Cfg<NWG, BN>::kThreads, 1)
    tri_lora_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_w,
                              const __nv_bfloat16* __restrict__ p,
                              long long ldp, const S* __restrict__ b,
                              long long ldb, Groups gr,
                              __nv_bfloat16* __restrict__ y, long long ldy,
                              int m, int k, int n, int r) {
  using C = Cfg<NWG, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * C::kStageBytes;   // full[s] +8s
  const uint32_t empty = full + 8 * kStages;               // empty[s] +8s
  const int m0 = blockIdx.y * C::kBM, n0 = blockIdx.x * BN;
  const int nk = (k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {   // the producer warp: one lane
    if (threadIdx.x == C::kConsumers) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        const uint32_t sx = base + s * C::kStageBytes, sw = sx + C::kXBytes;
        mbar_expect_tx(full + 8 * s, C::kStageBytes);
        tma_load(sx, &map_x, full + 8 * s, kt * kBK, m0);
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box)
          tma_load(sw + box * kBK * kRowBytes, &map_w, full + 8 * s,
                   n0 + box * kBox, kt * kBK);
      }
    }
    return;
  }

  // consumers: register i of the m64nBN accumulator holds row
  // 16*warp + lane/4 + 8*((i/2)%2) and column 8*(i/4) + 2*(lane%4) + i%2
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row = m0 + 64 * wgi + 16 * warp + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  // The seed P@B, kSeedQ ranks at a time: the consumers stage P's and B's
  // ranks as f32 in shared memory with one round of loads (zeros beyond M,
  // N and r, which add exactly nothing), then each thread adds them into its
  // registers in rank order
  float* sp = reinterpret_cast<float*>(
      smem_raw + (full + 16 * kStages - smem_u32(smem_raw)));
  float* sb = sp + C::kBM * kSeedQ;
  const int lr = row - m0, lc = col - n0;       // in the tile
  const int g = group_of(gr, m0);               // the block's group
  if (g > 0) b += g * gr.stride;
  const int seed_r = g >= 0 ? r : 0;            // none for a negative group
  for (int q0 = 0; q0 < seed_r; q0 += kSeedQ) {
#pragma unroll
    for (int it = 0; it < C::kBM * kSeedQ / C::kConsumers; ++it) {
      const int e = threadIdx.x + it * C::kConsumers;
      const int i = m0 + e / kSeedQ, q = q0 + e % kSeedQ;
      sp[e] = i < m && q < r ? __bfloat162float(p[i * ldp + q]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kSeedQ * BN / C::kConsumers; ++it) {
      const int e = threadIdx.x + it * C::kConsumers;
      const int q = q0 + e / BN, c = n0 + e % BN;
      sb[e] = q < r && c < n ? to_f32(b[q * ldb + c]) : 0.f;
    }
    consumers_sync<C::kConsumers>();
#pragma unroll
    for (int q = 0; q < kSeedQ; ++q) {
      const float p0 = sp[lr * kSeedQ + q], p1 = sp[(lr + 8) * kSeedQ + q];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bb =
            *reinterpret_cast<const float2*>(sb + q * BN + lc + 8 * j);
        d[4 * j] = fmaf(p0, bb.x, d[4 * j]);
        d[4 * j + 1] = fmaf(p0, bb.y, d[4 * j + 1]);
        d[4 * j + 2] = fmaf(p1, bb.x, d[4 * j + 2]);
        d[4 * j + 3] = fmaf(p1, bb.y, d[4 * j + 3]);
      }
    }
    consumers_sync<C::kConsumers>();
  }

  // The first stage's products accumulate onto the seed; the loop after it
  // carries only accumulators that wgmma defined, so ptxas keeps one stage's
  // products in flight while the next stage is waited for.
  fence_acc(d);
  stage_products<NWG, BN>(d, base, full, 0);
  for (int kt = 1; kt < nk; ++kt) {
    stage_products<NWG, BN>(d, base, full, kt);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);

  const bool pairs = ldy % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = col + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h;
      if (rr >= m || c >= n) continue;
      __nv_bfloat16* dst = y + rr * ldy + c;
      if (pairs && c + 1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      } else {
        dst[0] = __float2bfloat16(d[4 * j + 2 * h]);
        if (c + 1 < n) dst[1] = __float2bfloat16(d[4 * j + 2 * h + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 (rows, cols) operand with row stride
// ld, read in boxes of box_rows x 64 under the 128-byte swizzle; reads
// beyond rows or cols fill zeros
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            long long ld, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {kBox, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int BN, typename S>
cudaError_t fwd(const void* x, long long ldx, const void* w, long long ldw,
                const void* p, long long ldp, const void* b, long long ldb,
                Groups gr, void* y, long long ldy, int m, int k, int n, int r,
                cudaStream_t s) {
  using C = Cfg<NWG, BN>;
  if (gr.idx != nullptr && gr.rows % C::kBM != 0)
    return cudaErrorInvalidValue;           // a tile would straddle groups
  static const cudaError_t attr = cudaFuncSetAttribute(
      tri_lora_fwd_wgmma_kernel<NWG, BN, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_x, map_w;
  if (!encode(&map_x, x, m, k, ldx, C::kBM) ||
      !encode(&map_w, w, k, n, ldw, kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + C::kBM - 1) / C::kBM);
  tri_lora_fwd_wgmma_kernel<NWG, BN, S><<<grid, C::kThreads, C::kSmem, s>>>(
      map_x, map_w, static_cast<const __nv_bfloat16*>(p), ldp,
      static_cast<const S*>(b), ldb, gr, static_cast<__nv_bfloat16*>(y), ldy,
      m, k, n, r);
  return cudaGetLastError();
}

// M <= 64 (decode): one 64-row warpgroup over 128 columns, so W is spread
// over more blocks; otherwise two warpgroups over 128 x 256 (per product
// they read 3/4 of the bytes a 128 x 128 tile reads from L2, which paces
// these tiles)
template <typename S>
cudaError_t fwd(const void* x, long long ldx, const void* w, long long ldw,
                const void* p, long long ldp, const void* b, long long ldb,
                Groups gr, void* y, long long ldy, int m, int k, int n, int r,
                cudaStream_t s) {
  return m <= 64 ? fwd<1, 128, S>(x, ldx, w, ldw, p, ldp, b, ldb, gr, y, ldy,
                                  m, k, n, r, s)
                 : fwd<2, 256, S>(x, ldx, w, ldw, p, ldp, b, ldb, gr, y, ldy,
                                  m, k, n, r, s);
}

}  // namespace wg

}  // namespace

namespace {

// the entry points' dtype dispatch: `dtype` the type of the large operands
// (x, W, P, y / g, W, Q, dx), `small_dtype` that of the rank-r factor
cudaError_t fwd_simt(int dtype, int small_dtype, const void* x, long long ldx,
                     const void* w, long long ldw, const void* p,
                     long long ldp, const void* b, long long ldb, Groups gr,
                     void* y, long long ldy, int m, int k, int n, int r,
                     cudaStream_t s) {
  if (bad_extent(m, n) || k < 1 || r < 1 || r > 64)
    return cudaErrorInvalidValue;
  if (dtype == 0 && small_dtype == 0)
    return simt::fwd<float, float>(x, ldx, w, ldw, p, ldp, b, ldb, gr, y, ldy,
                                   m, k, n, r, s);
  if (dtype == 0 && small_dtype == 1)
    return simt::fwd<float, __nv_bfloat16>(x, ldx, w, ldw, p, ldp, b, ldb, gr,
                                           y, ldy, m, k, n, r, s);
  if (dtype == 1 && small_dtype == 0)
    return simt::fwd<__nv_bfloat16, float>(x, ldx, w, ldw, p, ldp, b, ldb, gr,
                                           y, ldy, m, k, n, r, s);
  if (dtype == 1 && small_dtype == 1)
    return simt::fwd<__nv_bfloat16, __nv_bfloat16>(x, ldx, w, ldw, p, ldp, b,
                                                   ldb, gr, y, ldy, m, k, n,
                                                   r, s);
  return cudaErrorInvalidValue;
}

cudaError_t fwd_wgmma(int dtype, int small_dtype, const void* x,
                      long long ldx, const void* w, long long ldw,
                      const void* p, long long ldp, const void* b,
                      long long ldb, Groups gr, void* y, long long ldy, int m,
                      int k, int n, int r, cudaStream_t s) {
  if (dtype != 1 || bad_extent(m, n) || k < 1 || r < 1 || r > 64 ||
      !simt::aligned16(x, ldx, 2) || !simt::aligned16(w, ldw, 2))
    return cudaErrorInvalidValue;
  if (small_dtype == 0)
    return wg::fwd<float>(x, ldx, w, ldw, p, ldp, b, ldb, gr, y, ldy, m, k, n,
                          r, s);
  if (small_dtype == 1)
    return wg::fwd<__nv_bfloat16>(x, ldx, w, ldw, p, ldp, b, ldb, gr, y, ldy,
                                  m, k, n, r, s);
  return cudaErrorInvalidValue;
}

cudaError_t dx_simt(int dtype, int small_dtype, const void* g, long long ldg,
                    const void* w, long long ldw, const void* q,
                    long long ldq, const void* a, long long lda, Groups gr,
                    void* out, long long ldo, int m, int k, int n, int r,
                    cudaStream_t s) {
  if (bad_extent(m, k) || n < 1 || r < 1 || r > 64)
    return cudaErrorInvalidValue;
  if (dtype == 0 && small_dtype == 0)
    return simt::dx<float, float>(g, ldg, w, ldw, q, ldq, a, lda, gr, out,
                                  ldo, m, k, n, r, s);
  if (dtype == 0 && small_dtype == 1)
    return simt::dx<float, __nv_bfloat16>(g, ldg, w, ldw, q, ldq, a, lda, gr,
                                          out, ldo, m, k, n, r, s);
  if (dtype == 1 && small_dtype == 0)
    return simt::dx<__nv_bfloat16, float>(g, ldg, w, ldw, q, ldq, a, lda, gr,
                                          out, ldo, m, k, n, r, s);
  if (dtype == 1 && small_dtype == 1)
    return simt::dx<__nv_bfloat16, __nv_bfloat16>(g, ldg, w, ldw, q, ldq, a,
                                                  lda, gr, out, ldo, m, k, n,
                                                  r, s);
  return cudaErrorInvalidValue;
}

// the groups of a grouped entry point: `groups` (M / rows int32 entries,
// checked by the caller) and `rows` (> 0); false when they are malformed
bool grouped(const void* groups, int rows, long long stride, Groups* gr) {
  if (groups == nullptr || rows < 1 || stride < 0) return false;
  *gr = Groups{static_cast<const int*>(groups), rows, stride};
  return true;
}

constexpr Groups kOne = {nullptr, 1, 0};

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `dtype` is the type of x, W, P
// and y; `small_dtype` the type of B.  The register-tiled SIMT route.
extern "C" int tri_lora_fwd_launch(int dtype, int small_dtype, const void* x,
                                   long long ldx, const void* w,
                                   long long ldw, const void* p,
                                   long long ldp, const void* b,
                                   long long ldb, void* y, long long ldy,
                                   int m, int k, int n, int r, void* stream) {
  return static_cast<int>(fwd_simt(dtype, small_dtype, x, ldx, w, ldw, p, ldp,
                                   b, ldb, kOne, y, ldy, m, k, n, r,
                                   static_cast<cudaStream_t>(stream)));
}

// The wgmma route, with the arguments of tri_lora_fwd_launch: bf16 x, W, P
// and y (dtype must be 1); x and W need a 16-byte aligned base and row
// stride (TMA), or the call is refused.
extern "C" int tri_lora_fwd_wgmma_launch(int dtype, int small_dtype,
                                         const void* x, long long ldx,
                                         const void* w, long long ldw,
                                         const void* p, long long ldp,
                                         const void* b, long long ldb, void* y,
                                         long long ldy, int m, int k, int n,
                                         int r, void* stream) {
  return static_cast<int>(fwd_wgmma(dtype, small_dtype, x, ldx, w, ldw, p,
                                    ldp, b, ldb, kOne, y, ldy, m, k, n, r,
                                    static_cast<cudaStream_t>(stream)));
}

// The grouped forward (one B per group, B of group g at b + g*b_stride,
// each (r,N) with row stride ldb): row i applies group groups[i / rows], a
// negative group none.  The SIMT route takes any rows; the wgmma route
// refuses rows that are no multiple of its tile (64 rows for M <= 64, else
// 128).
extern "C" int tri_lora_fwd_grouped_launch(
    int dtype, int small_dtype, const void* x, long long ldx, const void* w,
    long long ldw, const void* p, long long ldp, const void* b, long long ldb,
    long long b_stride, const void* groups, int rows, void* y, long long ldy,
    int m, int k, int n, int r, void* stream) {
  Groups gr;
  if (!grouped(groups, rows, b_stride, &gr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd_simt(dtype, small_dtype, x, ldx, w, ldw, p, ldp,
                                   b, ldb, gr, y, ldy, m, k, n, r,
                                   static_cast<cudaStream_t>(stream)));
}

extern "C" int tri_lora_fwd_grouped_wgmma_launch(
    int dtype, int small_dtype, const void* x, long long ldx, const void* w,
    long long ldw, const void* p, long long ldp, const void* b, long long ldb,
    long long b_stride, const void* groups, int rows, void* y, long long ldy,
    int m, int k, int n, int r, void* stream) {
  Groups gr;
  if (!grouped(groups, rows, b_stride, &gr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd_wgmma(dtype, small_dtype, x, ldx, w, ldw, p,
                                    ldp, b, ldb, gr, y, ldy, m, k, n, r,
                                    static_cast<cudaStream_t>(stream)));
}

// `dtype` is the type of g, W, Q and dx; `small_dtype` the type of A.
extern "C" int tri_lora_dx_launch(int dtype, int small_dtype, const void* g,
                                  long long ldg, const void* w, long long ldw,
                                  const void* q, long long ldq, const void* a,
                                  long long lda, void* out, long long ldo,
                                  int m, int k, int n, int r, void* stream) {
  return static_cast<int>(dx_simt(dtype, small_dtype, g, ldg, w, ldw, q, ldq,
                                  a, lda, kOne, out, ldo, m, k, n, r,
                                  static_cast<cudaStream_t>(stream)));
}

// The grouped dx (A of group g at a + g*a_stride, each (K,r) with row
// stride lda): row i applies group groups[i / rows], a negative group none.
extern "C" int tri_lora_dx_grouped_launch(
    int dtype, int small_dtype, const void* g, long long ldg, const void* w,
    long long ldw, const void* q, long long ldq, const void* a, long long lda,
    long long a_stride, const void* groups, int rows, void* out,
    long long ldo, int m, int k, int n, int r, void* stream) {
  Groups gr;
  if (!grouped(groups, rows, a_stride, &gr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dx_simt(dtype, small_dtype, g, ldg, w, ldw, q, ldq,
                                  a, lda, gr, out, ldo, m, k, n, r,
                                  static_cast<cudaStream_t>(stream)));
}

// `dtype` is the type of x, g and dW.  The M contraction runs in `splits`
// ranges of `depth` rows (the last one ragged), at most 8 (the portable
// cluster size): with splits > 1 one cluster of blocks per output tile
// sums the ranges' partials in range order.
extern "C" int tri_lora_dw_launch(int dtype, const void* x, long long ldx,
                                  const void* g, long long ldg, void* out,
                                  long long ldo, int m, int k, int n,
                                  int splits, int depth, void* stream) {
  if (bad_extent(k, n) || m < 1 || splits < 1 || splits > 8 || depth < 1 ||
      static_cast<long long>(splits) * depth < m ||
      static_cast<long long>(splits - 1) * depth >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = simt::dw<float>(x, ldx, g, ldg, out, ldo, m, k, n, splits, depth,
                          s);
  else if (dtype == 1)
    err = simt::dw<__nv_bfloat16>(x, ldx, g, ldg, out, ldo, m, k, n, splits,
                                  depth, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The dW blocks the current device holds at once when they are launched in
// clusters of `splits` blocks (f32, 16-byte route), from the occupancy
// calculator; -1 when it fails.  Clusters of 3 or more blocks reach fewer
// SMs than the card has, so this falls with the cluster size.
extern "C" int tri_lora_dw_capacity(int splits) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(simt::kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (splits < 1 || splits > 8 ||
      cudaOccupancyMaxActiveClusters(
          &clusters, simt::tri_lora_dw_kernel<float, true>, &cfg) !=
          cudaSuccess)
    return -1;
  return clusters * splits;
}

extern "C" const char* tri_lora_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
