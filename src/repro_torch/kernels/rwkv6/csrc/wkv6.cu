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
// tensor cores do not apply to the serial update.
//
// What the design does about it (a simple kernel; a chunked tensor-core
// form is later work):
// * One block of 64 threads per (b, h); thread j owns value column j and
//   keeps the whole column S[:, j] (64 f32) in registers, so the state is
//   read from and written to device memory once and y_t[j] needs no
//   reduction across threads.
// * Every thread of a step reads the same r_t, k_t and w_t: they are staged
//   in shared memory as f32 and read as 16-byte loads that all threads of
//   a warp share.
// * Time runs in chunks of 16 steps.  The next chunk's global loads are
//   issued into registers before the current chunk's steps run, so their
//   latency hides behind the recurrence.  The reads run along hd,
//   coalesced, by the tensors' own strides: the model's (B,T,H,hd) layout
//   and strided views of a wider buffer are read in place, and u is read
//   as (H, hd).
// * The bonus sum_i r_t[i] u[i] k_t[i] does not depend on the column: each
//   warp computes it for half of the chunk's steps once the chunk is
//   staged.  Per step and state entry that leaves one FMA for y and a
//   multiply and an FMA for S; y is summed in four partial accumulators.
// * Ragged T: the last chunk runs only its real steps, and nothing is
//   padded.  hd < 64: keys and columns beyond hd are staged as zero and
//   never stored, so the inner loop has no branches.
//
// The entry point launches on the given stream and returns the cudaError_t
// of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHd = 64;
constexpr int kChunk = 16;     // time steps staged per pass
constexpr int kThreads = 64;   // one value column per thread
constexpr int kPer = kChunk * kMaxHd / kThreads;  // staged values a thread

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

// Issue the loads of steps [t0, t0 + n) of one (b, h) row of a (B,T,H,hd)
// tensor into registers, in the input's type: value m of this thread is
// step m, key tid.  Positions at or beyond n steps or hd keys hold zero.
template <typename T>
__device__ __forceinline__ void fetch(T (&reg)[kPer], const T* src,
                                      long long st, int t0, int n, int hd) {
  const int i = threadIdx.x;
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    reg[m] = (m < n && i < hd) ? src[(long long)(t0 + m) * st + i]
                               : zero<T>();
}

// Store fetched values into dst[step * 64 + key] as f32.
template <typename T>
__device__ __forceinline__ void put(float* dst, const T (&reg)[kPer]) {
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    dst[m * kMaxHd + threadIdx.x] = to_f32(reg[m]);
}

template <typename TR, typename TW, typename TU>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const TR* __restrict__ r, long long rb, long long rt, long long rh,
            const TR* __restrict__ k, long long kb, long long kt, long long kh,
            const TR* __restrict__ v, long long vb, long long vt, long long vh,
            const TW* __restrict__ w, long long wb, long long wt, long long wh,
            const TU* __restrict__ u, long long uh,
            const float* __restrict__ s0, long long sb, long long sh,
            long long si, float* __restrict__ y, float* __restrict__ s_out,
            int T, int H, int hd) {
  __shared__ __align__(16) float r_s[kChunk * kMaxHd];
  __shared__ __align__(16) float k_s[kChunk * kMaxHd];
  __shared__ __align__(16) float w_s[kChunk * kMaxHd];
  __shared__ float v_s[kChunk * kMaxHd];
  __shared__ float u_s[kMaxHd];
  __shared__ float bonus_s[kChunk];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool col = j < hd;

  const TR* rp = r + b * rb + h * rh;
  const TR* kp = k + b * kb + h * kh;
  const TR* vp = v + b * vb + h * vh;
  const TW* wp = w + b * wb + h * wh;
  float* yp = y + ((long long)b * T * H + h) * hd + j;

  float s[kMaxHd];
#pragma unroll
  for (int i = 0; i < kMaxHd; ++i)
    s[i] = (col && i < hd) ? s0[b * sb + h * sh + i * si + j] : 0.f;
  u_s[j] = col ? to_f32(u[h * uh + j]) : 0.f;

  TR r_f[kPer], k_f[kPer], v_f[kPer];
  TW w_f[kPer];
  fetch(r_f, rp, rt, 0, min(kChunk, T), hd);
  fetch(k_f, kp, kt, 0, min(kChunk, T), hd);
  fetch(w_f, wp, wt, 0, min(kChunk, T), hd);
  fetch(v_f, vp, vt, 0, min(kChunk, T), hd);
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    put(r_s, r_f);
    put(k_s, k_f);
    put(w_s, w_f);
    put(v_s, v_f);
    __syncthreads();
    const int t1 = t0 + kChunk;
    if (t1 < T) {                 // the next chunk's loads, in flight
      const int n1 = min(kChunk, T - t1);
      fetch(r_f, rp, rt, t1, n1, hd);
      fetch(k_f, kp, kt, t1, n1, hd);
      fetch(w_f, wp, wt, t1, n1, hd);
      fetch(v_f, vp, vt, t1, n1, hd);
    }
    for (int tt = warp; tt < n; tt += kThreads / 32) {
      float x = 0.f;
#pragma unroll
      for (int i = lane; i < kMaxHd; i += 32)
        x = fmaf(r_s[tt * kMaxHd + i] * u_s[i], k_s[tt * kMaxHd + i], x);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) bonus_s[tt] = x;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt * kMaxHd + j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s + tt * kMaxHd);
      const float4* k4 = reinterpret_cast<const float4*>(k_s + tt * kMaxHd);
      const float4* w4 = reinterpret_cast<const float4*>(w_s + tt * kMaxHd);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < kMaxHd / 4; ++m) {
        const float4 rr = r4[m], kk = k4[m], ww = w4[m];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * m + c;
          acc[c] = fmaf(rv[c], s[i], acc[c]);
          s[i] = fmaf(wv[c], s[i], kv[c] * vj);
        }
      }
      const float out = fmaf(vj, bonus_s[tt], (acc[0] + acc[1]) +
                                                  (acc[2] + acc[3]));
      if (col) yp[(long long)(t0 + tt) * H * hd] = out;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMaxHd; ++i)
    if (col && i < hd)
      s_out[(((long long)b * H + h) * hd + i) * hd + j] = s[i];
}

template <typename TR, typename TW, typename TU>
cudaError_t launch(const void* r, long long rb, long long rt, long long rh,
                   const void* k, long long kb, long long kt, long long kh,
                   const void* v, long long vb, long long vt, long long vh,
                   const void* w, long long wb, long long wt, long long wh,
                   const void* u, long long uh, const void* s0, long long sb,
                   long long sh, long long si, void* y, void* s_out, int B,
                   int T, int H, int hd, cudaStream_t stream) {
  wkv6_kernel<TR, TW, TU><<<B * H, kThreads, 0, stream>>>(
      static_cast<const TR*>(r), rb, rt, rh, static_cast<const TR*>(k), kb,
      kt, kh, static_cast<const TR*>(v), vb, vt, vh,
      static_cast<const TW*>(w), wb, wt, wh, static_cast<const TU*>(u), uh,
      static_cast<const float*>(s0), sb, sh, si, static_cast<float*>(y),
      static_cast<float*>(s_out), T, H, hd);
  return cudaGetLastError();
}

template <typename TR, typename TW>
cudaError_t launch_u(int u_dtype, const void* r, long long rb, long long rt,
                     long long rh, const void* k, long long kb, long long kt,
                     long long kh, const void* v, long long vb, long long vt,
                     long long vh, const void* w, long long wb, long long wt,
                     long long wh, const void* u, long long uh,
                     const void* s0, long long sb, long long sh, long long si,
                     void* y, void* s_out, int B, int T, int H, int hd,
                     cudaStream_t stream) {
  if (u_dtype == 0)
    return launch<TR, TW, float>(r, rb, rt, rh, k, kb, kt, kh, v, vb, vt, vh,
                                 w, wb, wt, wh, u, uh, s0, sb, sh, si, y,
                                 s_out, B, T, H, hd, stream);
  if (u_dtype == 1)
    return launch<TR, TW, __nv_bfloat16>(r, rb, rt, rh, k, kb, kt, kh, v, vb,
                                         vt, vh, w, wb, wt, wh, u, uh, s0, sb,
                                         sh, si, y, s_out, B, T, H, hd,
                                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16.  `rkv_dtype` is the type of r,
// k and v; `w_dtype` of w; `u_dtype` of u.  The state in and out and y are
// float32.  Strides are in elements: (batch, time, head) for r/k/v/w, the
// head stride of u, (batch, head, key) of the state; the last axis of
// every input has unit stride, and y (B,T,H,hd) and the final state
// (B,H,hd,hd) are written contiguous.
extern "C" int wkv6_launch(int rkv_dtype, int w_dtype, int u_dtype,
                           const void* r, long long rb, long long rt,
                           long long rh, const void* k, long long kb,
                           long long kt, long long kh, const void* v,
                           long long vb, long long vt, long long vh,
                           const void* w, long long wb, long long wt,
                           long long wh, const void* u, long long uh,
                           const void* s0, long long sb, long long sh,
                           long long si, void* y, void* s_out, int B, int T,
                           int H, int hd, void* stream) {
  if (B < 1 || T < 1 || H < 1 || hd < 1 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV6_ARGS                                                           \
  u_dtype, r, rb, rt, rh, k, kb, kt, kh, v, vb, vt, vh, w, wb, wt, wh, u,   \
      uh, s0, sb, sh, si, y, s_out, B, T, H, hd, st
  cudaError_t err;
  if (rkv_dtype == 0 && w_dtype == 0)
    err = launch_u<float, float>(WKV6_ARGS);
  else if (rkv_dtype == 0 && w_dtype == 1)
    err = launch_u<float, __nv_bfloat16>(WKV6_ARGS);
  else if (rkv_dtype == 1 && w_dtype == 0)
    err = launch_u<__nv_bfloat16, float>(WKV6_ARGS);
  else if (rkv_dtype == 1 && w_dtype == 1)
    err = launch_u<__nv_bfloat16, __nv_bfloat16>(WKV6_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef WKV6_ARGS
  return static_cast<int>(err);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
