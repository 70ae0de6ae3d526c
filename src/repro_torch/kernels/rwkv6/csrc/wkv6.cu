// The WKV6 recurrence of RWKV-6 "Finch" for Hopper (sm_90a), forward only.
//
// Replaces: the Pallas TPU kernel wkv6_kernel of
// src/repro/kernels/rwkv6/rwkv6.py (_kernel, pallas_call grid (B*H, T/L)),
// which blocks time into chunks of L = 32 steps, computes each chunk with
// dense log-space cumulative-decay algebra (the TPU has no cheap serial
// loop) and carries the (hd, hd) f32 state in VMEM across the sequential
// chunk axis.
//
// Computes, for each batch row b and head h, with the state S (hd_k x hd_v,
// f32, key x value) starting from state[b, h]:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// and returns y (B,T,H,hd) f32 and the final S (B,H,hd,hd) f32.  The same
// function as the TPU kernel, computed step by step: multiplying by
// w in [0, 1) can neither overflow nor underflow into NaN, and w = 0
// forgets exactly, so the log-space form is not needed here.
//
// What bounds it on this card: operations.  At the model's shape
// (rwkv6-1.6b prefill: B=8, T=512, H=32, hd=64; r, k, v bf16, w f32, u
// bf16, y and the state f32) the recurrence does 5*hd^2 f32 operations per
// token and head, 2.68 GFLOP over 125.8 MB: 40.06 us at the 67 TFLOP/s of
// f32 FMAs against 37.56 us for the bytes at 3.35 TB/s (kernels/bounds.py).
// The state must stay f32 (it is carried over hundreds of steps), so the
// tensor cores do not apply to the serial update; a chunked tensor-core form
// would spend as many FFMAs (2hd^2 + 2L*hd a token at L = 32) and f32 cannot
// use TF32.  Instruction floor of the step form: each state entry needs 3
// FP32 instructions a step (k*v, the decayed update, r*S into y), so the
// prefill runs 8*512*32*64*64*3/32 = 50.3 M warp instructions, 95.3 k
// cycles of the H100's 132 x 4 schedulers at one a cycle each: 54 us at
// 1.755 GHz (48 us at 1.98 GHz), above the operation bound.  Loads, the bonus and the y sums come on top.
//
// What the design does about it: fill the card with independent work, and
// keep each step's serial chain short.
// * One block a (b, h).  The value columns of the state are independent
//   (S[:, j] reads only v[j]), so its 128 threads split the state into 8
//   key slices x 16 groups of 4 columns: thread (slice, group) holds
//   S[8 slice .. 8 slice + 7][4 group .. 4 group + 3] in 32 registers.  At
//   B=8 that is 256 blocks of 4 warps, two an SM.
// * y leaves the serial chain: per step each thread writes its slice's
//   partial of y[t][j] (8 FMAs a column) to shared memory, and after the
//   chunk the partials are summed in slice order, plus v_t[j] times the
//   bonus sum_i r_t[i] u[i] k_t[i].  A step carries only the state update
//   s = fmaf(w, s, k*v) per entry, so the final state is bitwise that of
//   a kernel holding a whole column a thread; only y's order of summation
//   moved.
// * Time runs in chunks of 32 steps.  The next chunk of r, k, w and v is
//   copied by 16-byte cp.async into the other of two stages in shared
//   memory, in the inputs' own types, while the current chunk runs.  Rows
//   whose base, strides or hd are not 16-byte multiples take the scalar
//   route of the same kernel (one element a load), chosen by the caller:
//   wkv6_scalar_launch.  A thread reads r and k of its 8 keys (bf16)
//   in one 16-byte read each, w (f32) in two and v of its 4 columns in one
//   8-byte read, reads the threads of its slice share (broadcast), and
//   widens them itself.
// * The bonus of all the chunk's steps is summed at once before the steps:
//   thread (step, 8-key segment) sums its keys and the 8 lanes of a step
//   add theirs by 3 shuffles.  (One warp a step with a 5-level shuffle tree
//   put ~100 cycles a step on every warp's path.)
// * What paces it on the H100: 2 warps a scheduler at ~138 SASS
//   instructions a warp-step (96 of them the FP floor, 20 bf16 widenings),
//   dispatched at ~0.56 a cycle: the step's latency, not that floor.
//   More, smaller threads (2 columns each), 32-column blocks or 16-step
//   chunks measured slower (PERF.md).
// * The reads run along hd by the tensors' own strides: the model's
//   (B,T,H,hd) layout and strided views of a wider buffer are read in
//   place, and u is read as (H, hd).
// * Ragged T: the last chunk runs only its real steps, and nothing is
//   padded.  hd < 64: keys and columns beyond hd are staged as zero and
//   never stored, so the inner loop has no branches.
//
// Each entry point launches on the given stream and returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxHd = 64;   // keys and value columns of a block
constexpr int kCpt = 4;       // value columns a thread
constexpr int kSlices = 8;    // key slices a block
constexpr int kKeys = kMaxHd / kSlices;      // keys a thread
constexpr int kGroups = kMaxHd / kCpt;       // column groups a slice
constexpr int kThreads = kSlices * kGroups;  // one (slice, group) a thread
constexpr int kQuads = kMaxHd / 4;           // y is written 4 columns a time
constexpr int kChunk = 32;    // time steps staged per pass
// one block covers every head dim 1..kMaxHd: its slices hold every key and
// its groups every column once
static_assert(kSlices * kKeys == kMaxHd && kGroups * kCpt == kMaxHd &&
                  kKeys == 8 && kCpt == 4 && kThreads == 128,
              "the step loop's shape");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// N (4 or 8) consecutive staged values, aligned to their size, widened to
// f32 in the fewest shared-memory reads
template <int N>
__device__ __forceinline__ void load_f32(float (&out)[N], const float* p) {
  static_assert(N == 4 || N == 8, "16-byte reads");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    out[i] = x.x;
    out[i + 1] = x.y;
    out[i + 2] = x.z;
    out[i + 3] = x.w;
  }
}
template <int N>
__device__ __forceinline__ void load_f32(float (&out)[N],
                                         const __nv_bfloat16* p) {
  static_assert(N == 4 || N == 8, "one 8- or 16-byte read");
  __nv_bfloat162 h[N / 2];
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
  else
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of a block, in bytes: two stages of one chunk of r, k, v
// and w in the inputs' types, the y partials [slice][step][column] and the
// bonus of each step.
template <typename TR, typename TW>
struct Smem {
  static constexpr int kRawR = kChunk * kMaxHd * sizeof(TR);
  static constexpr int kRawW = kChunk * kMaxHd * sizeof(TW);
  static constexpr int kRaw = 3 * kRawR + kRawW;
  static constexpr int kPart = kSlices * kChunk * kMaxHd * 4;
  static constexpr int kBytes = 2 * kRaw + kPart + kChunk * 4;
};

// n steps of one (b, h) row of a (B,T,H,hd) tensor (src at the first step,
// step stride st) into dst[step][kMaxHd] in the input's type; elements at
// or beyond hd are zero.  VEC: 16-byte cp.async (base, strides and hd are
// 16-byte multiples); else one element a load.
template <bool VEC, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long st,
                                      int n, int hd) {
  if constexpr (VEC) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    constexpr int kPerRow = kMaxHd / E;
    for (int e = threadIdx.x; e < n * kPerRow; e += kThreads) {
      const int t = e / kPerRow, c = (e % kPerRow) * E;
      const bool ok = c < hd;
      cp_async16(dst + t * kMaxHd + c, ok ? src + t * st + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * kMaxHd; e += kThreads) {
      const int t = e / kMaxHd, c = e % kMaxHd;
      dst[e] = c < hd ? src[t * st + c] : zero<T>();
    }
  }
}

template <bool VEC, typename TR, typename TW, typename TU>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const TR* __restrict__ r, long long rb, long long rt, long long rh,
            const TR* __restrict__ k, long long kb, long long kt, long long kh,
            const TR* __restrict__ v, long long vb, long long vt, long long vh,
            const TW* __restrict__ w, long long wb, long long wt, long long wh,
            const TU* __restrict__ u, long long uh,
            const float* __restrict__ s0, long long sb, long long sh,
            long long si, float* __restrict__ y, float* __restrict__ s_out,
            int T, int H, int hd) {
  using S = Smem<TR, TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* __restrict__ part = reinterpret_cast<float*>(smem + 2 * S::kRaw);
  float* __restrict__ bonus = part + kSlices * kChunk * kMaxHd;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int group = threadIdx.x % kGroups, slice = threadIdx.x / kGroups;
  const int key0 = slice * kKeys, col = kCpt * group;

  const TR* rp = r + b * rb + h * rh;
  const TR* kp = k + b * kb + h * kh;
  const TR* vp = v + b * vb + h * vh;
  const TW* wp = w + b * wb + h * wh;

  // stage st of the raw chunks: r, k, v, w
  auto raw_r = [&](int st) {
    return reinterpret_cast<TR*>(smem + st * S::kRaw);
  };
  auto raw_k = [&](int st) {
    return reinterpret_cast<TR*>(smem + st * S::kRaw + S::kRawR);
  };
  auto raw_v = [&](int st) {
    return reinterpret_cast<TR*>(smem + st * S::kRaw + 2 * S::kRawR);
  };
  auto raw_w = [&](int st) {
    return reinterpret_cast<TW*>(smem + st * S::kRaw + 3 * S::kRawR);
  };
  auto stage_chunk = [&](int st, int t0, int n) {
    stage<VEC>(raw_r(st), rp + t0 * rt, rt, n, hd);
    stage<VEC>(raw_k(st), kp + t0 * kt, kt, n, hd);
    stage<VEC>(raw_w(st), wp + t0 * wt, wt, n, hd);
    stage<VEC>(raw_v(st), vp + t0 * vt, vt, n, hd);
  };

  float s[kKeys][kCpt];
#pragma unroll
  for (int i = 0; i < kKeys; ++i)
#pragma unroll
    for (int c = 0; c < kCpt; ++c)
      s[i][c] = key0 + i < hd && col + c < hd
                    ? s0[b * sb + h * sh + (key0 + i) * si + col + c]
                    : 0.f;
  // u of the keys whose share of the bonus this thread sums
  const int seg = threadIdx.x % kKeys;
  float u_seg[kKeys];
#pragma unroll
  for (int i = 0; i < kKeys; ++i)
    u_seg[i] = seg * kKeys + i < hd ? to_f32(u[h * uh + seg * kKeys + i])
                                    : 0.f;

  const int n_chunks = (T + kChunk - 1) / kChunk;
  stage_chunk(0, 0, min(kChunk, T));
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0), st = c & 1;
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed for all; the last one's y is out
    if (c + 1 < n_chunks) {
      stage_chunk(st ^ 1, t0 + kChunk, min(kChunk, T - t0 - kChunk));
      cp_async_commit();
    }
    // (the partials' stores never alias the chunk's reads)
    const TR* __restrict__ rr = raw_r(st);
    const TR* __restrict__ kr = raw_k(st);
    const TW* __restrict__ wr = raw_w(st);
    const TR* __restrict__ vr = raw_v(st);

    // the bonus sum_i r u k of every step of the chunk, read only after
    // it: thread (step, 8-key segment) sums its keys, then the 8 lanes of
    // a step add theirs by shuffles, all steps at once
#pragma unroll
    for (int e0 = 0; e0 < kChunk * kKeys; e0 += kThreads) {
      const int tt = (e0 + static_cast<int>(threadIdx.x)) / kKeys;
      float x = 0.f;
      if (tt < n) {
        float rs[kKeys], ks[kKeys];
        load_f32(rs, rr + tt * kMaxHd + seg * kKeys);
        load_f32(ks, kr + tt * kMaxHd + seg * kKeys);
#pragma unroll
        for (int i = 0; i < kKeys; ++i) x = fmaf(rs[i] * u_seg[i], ks[i], x);
      }
#pragma unroll
      for (int off = kKeys / 2; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (seg == 0 && tt < n) bonus[tt] = x;
    }

    // the steps: the state update, and this slice's partial of y
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      float rc[kKeys], kc[kKeys], wc[kKeys], vc[kCpt];
      load_f32(rc, rr + tt * kMaxHd + key0);
      load_f32(kc, kr + tt * kMaxHd + key0);
      load_f32(wc, wr + tt * kMaxHd + key0);
      load_f32(vc, vr + tt * kMaxHd + col);
      float yp[kCpt];
#pragma unroll
      for (int j = 0; j < kCpt; ++j) yp[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
#pragma unroll
        for (int j = 0; j < kCpt; ++j) {
          yp[j] = fmaf(rc[i], s[i][j], yp[j]);
          s[i][j] = fmaf(wc[i], s[i][j], kc[i] * vc[j]);
        }
      *reinterpret_cast<float4*>(part + (slice * kChunk + tt) * kMaxHd +
                                 col) = make_float4(yp[0], yp[1], yp[2], yp[3]);
    }
    __syncthreads();

    // y of the chunk, a (step, quad) at a time, all of a thread's at once:
    // the slices' partials summed in order, plus v times the bonus
#pragma unroll
    for (int e0 = 0; e0 < kChunk * kQuads; e0 += kThreads) {
      const int e = e0 + static_cast<int>(threadIdx.x);
      const int tt = e / kQuads, q = (e % kQuads) * 4;
      if (e >= kChunk * kQuads || tt >= n || q >= hd) continue;
      float4 sum = *reinterpret_cast<const float4*>(part + tt * kMaxHd + q);
#pragma unroll
      for (int sl = 1; sl < kSlices; ++sl) {
        const float4 x = *reinterpret_cast<const float4*>(
            part + (sl * kChunk + tt) * kMaxHd + q);
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      const float bo = bonus[tt];
      float vq[4];
      load_f32(vq, vr + tt * kMaxHd + q);
      const float out[4] = {fmaf(vq[0], bo, sum.x), fmaf(vq[1], bo, sum.y),
                            fmaf(vq[2], bo, sum.z), fmaf(vq[3], bo, sum.w)};
      float* yrow =
          y + ((static_cast<long long>(b) * T + t0 + tt) * H + h) * hd + q;
      if (hd % 4 == 0) {
        *reinterpret_cast<float4*>(yrow) =
            make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q + j < hd) yrow[j] = out[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kKeys; ++i)
#pragma unroll
    for (int c = 0; c < kCpt; ++c)
      if (key0 + i < hd && col + c < hd)
        s_out[((static_cast<long long>(b) * H + h) * hd + key0 + i) * hd +
              col + c] = s[i][c];
}

// the 16-byte copies read rows whose base, strides and hd are multiples of
// 16 bytes
bool rows16(const void* p, long long sb, long long st, long long sh,
            int elem, int hd) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0 &&
         (sb * elem) % 16 == 0 && (st * elem) % 16 == 0 &&
         (sh * elem) % 16 == 0 && (hd * elem) % 16 == 0;
}

template <bool VEC, typename TR, typename TW, typename TU>
cudaError_t launch(const void* r, long long rb, long long rt, long long rh,
                   const void* k, long long kb, long long kt, long long kh,
                   const void* v, long long vb, long long vt, long long vh,
                   const void* w, long long wb, long long wt, long long wh,
                   const void* u, long long uh, const void* s0, long long sb,
                   long long sh, long long si, void* y, void* s_out, int B,
                   int T, int H, int hd, cudaStream_t stream) {
  auto kernel = wkv6_kernel<VEC, TR, TW, TU>;
  constexpr int smem = Smem<TR, TW>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const TR*>(r), rb, rt, rh, static_cast<const TR*>(k), kb,
      kt, kh, static_cast<const TR*>(v), vb, vt, vh,
      static_cast<const TW*>(w), wb, wt, wh, static_cast<const TU*>(u), uh,
      static_cast<const float*>(s0), sb, sh, si, static_cast<float*>(y),
      static_cast<float*>(s_out), T, H, hd);
  return cudaGetLastError();
}

template <bool VEC, typename TR, typename TW>
cudaError_t launch_u(int u_dtype, const void* r, long long rb, long long rt,
                     long long rh, const void* k, long long kb, long long kt,
                     long long kh, const void* v, long long vb, long long vt,
                     long long vh, const void* w, long long wb, long long wt,
                     long long wh, const void* u, long long uh,
                     const void* s0, long long sb, long long sh, long long si,
                     void* y, void* s_out, int B, int T, int H, int hd,
                     cudaStream_t stream) {
  if (u_dtype == 0)
    return launch<VEC, TR, TW, float>(r, rb, rt, rh, k, kb, kt, kh, v, vb,
                                      vt, vh, w, wb, wt, wh, u, uh, s0, sb,
                                      sh, si, y, s_out, B, T, H, hd, stream);
  if (u_dtype == 1)
    return launch<VEC, TR, TW, __nv_bfloat16>(
        r, rb, rt, rh, k, kb, kt, kh, v, vb, vt, vh, w, wb, wt, wh, u, uh,
        s0, sb, sh, si, y, s_out, B, T, H, hd, stream);
  return cudaErrorInvalidValue;
}

int elem_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

template <bool VEC>
int entry(int rkv_dtype, int w_dtype, int u_dtype, const void* r,
          long long rb, long long rt, long long rh, const void* k,
          long long kb, long long kt, long long kh, const void* v,
          long long vb, long long vt, long long vh, const void* w,
          long long wb, long long wt, long long wh, const void* u,
          long long uh, const void* s0, long long sb, long long sh,
          long long si, void* y, void* s_out, int B, int T, int H, int hd,
          void* stream) {
  if (B < 1 || T < 1 || H < 1 || hd < 1 || hd > kMaxHd ||
      static_cast<long long>(B) * H > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int er = elem_size(rkv_dtype), ew = elem_size(w_dtype);
  if (VEC && !(rows16(r, rb, rt, rh, er, hd) &&
               rows16(k, kb, kt, kh, er, hd) &&
               rows16(v, vb, vt, vh, er, hd) &&
               rows16(w, wb, wt, wh, ew, hd)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV6_ARGS                                                           \
  u_dtype, r, rb, rt, rh, k, kb, kt, kh, v, vb, vt, vh, w, wb, wt, wh, u,   \
      uh, s0, sb, sh, si, y, s_out, B, T, H, hd, st
  cudaError_t err;
  if (rkv_dtype == 0 && w_dtype == 0)
    err = launch_u<VEC, float, float>(WKV6_ARGS);
  else if (rkv_dtype == 0 && w_dtype == 1)
    err = launch_u<VEC, float, __nv_bfloat16>(WKV6_ARGS);
  else if (rkv_dtype == 1 && w_dtype == 0)
    err = launch_u<VEC, __nv_bfloat16, float>(WKV6_ARGS);
  else if (rkv_dtype == 1 && w_dtype == 1)
    err = launch_u<VEC, __nv_bfloat16, __nv_bfloat16>(WKV6_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef WKV6_ARGS
  return static_cast<int>(err);
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16.  `rkv_dtype` is the type of r,
// k and v; `w_dtype` of w; `u_dtype` of u.  The state in and out and y are
// float32.  Strides are in elements: (batch, time, head) for r/k/v/w, the
// head stride of u, (batch, head, key) of the state; the last axis of
// every input has unit stride, and y (B,T,H,hd) and the final state
// (B,H,hd,hd) are written contiguous.  wkv6_launch stages r, k, v and w
// 16 bytes a copy and refuses (cudaErrorInvalidValue) any of them whose
// base, strides or hd are no multiple of 16 bytes; wkv6_scalar_launch
// takes any strides.
#define WKV6_PARAMS                                                         \
  int rkv_dtype, int w_dtype, int u_dtype, const void *r, long long rb,     \
      long long rt, long long rh, const void *k, long long kb, long long kt, \
      long long kh, const void *v, long long vb, long long vt, long long vh, \
      const void *w, long long wb, long long wt, long long wh, const void *u, \
      long long uh, const void *s0, long long sb, long long sh, long long si, \
      void *y, void *s_out, int B, int T, int H, int hd, void *stream
#define WKV6_ENTRY_ARGS                                                     \
  rkv_dtype, w_dtype, u_dtype, r, rb, rt, rh, k, kb, kt, kh, v, vb, vt, vh, \
      w, wb, wt, wh, u, uh, s0, sb, sh, si, y, s_out, B, T, H, hd, stream

extern "C" int wkv6_launch(WKV6_PARAMS) {
  return entry<true>(WKV6_ENTRY_ARGS);
}
extern "C" int wkv6_scalar_launch(WKV6_PARAMS) {
  return entry<false>(WKV6_ENTRY_ARGS);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
