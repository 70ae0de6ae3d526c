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
// What bounds it on this card: bytes.  Each (row, head) reads its valid K and
// V slots once (2 * n_valid * hd * sizeof(T)) and does 4 flops per element
// read, far below the ~295 flop/byte at which the H100's tensor cores would
// become the limit.  At LLaMA-7B width (B=8, H=K=32, hd=128, ring 160, bf16)
// K+V are 10.5 MB: ~3 us at 3.35 TB/s, so launch overhead dominates.
//
// What the design does about it: one block per (query head, row); its 8
// warps stride over the valid slots, 4 slots per warp per step with all K/V
// loads issued before any arithmetic, each warp lane holding hd/32 channels
// (lane-interleaved, so every load instruction is coalesced).  Each warp
// keeps its own online-softmax state (m, l, acc) in registers and the warps
// merge once through shared memory.  Valid slots are a prefix of the ring
// [0, min(idx+1, ring)), so the loop stops there: masked slots are never
// read, which is what masking their logits to -1e30 computes.  The ring is
// read in the model's (B, R, K, hd) layout through its strides, so no
// transposed or padded copy of the cache is ever made; a ring that is not a
// multiple of any tile needs no padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ idx, int idx_stride, T* __restrict__ out,
    int n_heads, int group, int ring, long long k_sb, long long k_sr,
    long long k_sh, long long v_sb, long long v_sr, long long v_sh,
    float sm_scale) {
  constexpr int E = HD / 32;  // channels per lane: d = e * 32 + lane
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_idx = idx[b * idx_stride];
  T* o = out + (static_cast<long long>(b) * n_heads + h) * HD;
  if (row_idx < 0) {  // masked batch slot: exactly zero
    for (int d = threadIdx.x; d < HD; d += kThreads) o[d] = from_f32<T>(0.f);
    return;
  }
  const int n_valid = row_idx >= ring ? ring : row_idx + 1;
  const int kvh = h / group;
  const T* qp = q + (static_cast<long long>(b) * n_heads + h) * HD;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  float qr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] = to_f32(qp[e * 32 + lane]);

  float m = kNegInf, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int s0 = warp * kUnroll; s0 < n_valid; s0 += kWarps * kUnroll) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      const bool ok = s < n_valid;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = ok ? to_f32(kb[s * k_sr + e * 32 + lane]) : 0.f;
        vr[u][e] = ok ? to_f32(vb[s * v_sr + e * 32 + lane]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part += qr[e] * kr[u][e];
      const float score = warp_sum(part) * sm_scale;
      if (s0 + u < n_valid) {  // uniform across the warp
        const float m_new = fmaxf(m, score);
        const float alpha = expf(m - m_new);
        const float p = expf(score - m_new);
        l = l * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] * alpha + p * vr[u][e];
        m = m_new;
      }
    }
  }

  // merge the warps' (m, l, acc); a warp that saw no slot has l = acc = 0
  // and m = -1e30, so its weight exp(m - max) is exactly zero
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][e * 32 + lane] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);
      lsum += sm_l[w] * c;
      a += sm_acc[w][d] * c;
    }
    o[d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* idx,
            int idx_stride, void* out, int batch, int n_heads, int group,
            int ring, long long k_sb, long long k_sr, long long k_sh,
            long long v_sb, long long v_sr, long long v_sh, float sm_scale,
            cudaStream_t stream) {
  const dim3 grid(n_heads, batch);
  decode_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx), idx_stride,
      static_cast<T*>(out), n_heads, group, ring, k_sb, k_sr, k_sh, v_sb,
      v_sr, v_sh, sm_scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and out are contiguous (B, 1, H, hd);
// k and v are (B, R, K, hd) with unit channel stride and the given element
// strides for the batch, slot and head axes; idx is int32, read at
// idx[b * idx_stride] (stride 0 broadcasts one position to every row).
// Returns the cudaError_t of the launch.
extern "C" int decode_attention_launch(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* idx, int idx_stride, void* out, int batch, int n_heads,
    int n_kv_heads, int ring, long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh, float sm_scale,
    void* stream) {
  if (batch < 1 || batch > 65535 || n_kv_heads < 1 || ring < 1 ||
      n_heads % n_kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = n_heads / n_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    launch<float, 64>(q, k, v, idx, idx_stride, out, batch, n_heads, group,
                      ring, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, sm_scale, s);
  else if (dtype == 0 && hd == 128)
    launch<float, 128>(q, k, v, idx, idx_stride, out, batch, n_heads, group,
                       ring, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, sm_scale, s);
  else if (dtype == 1 && hd == 64)
    launch<__nv_bfloat16, 64>(q, k, v, idx, idx_stride, out, batch, n_heads,
                              group, ring, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh,
                              sm_scale, s);
  else if (dtype == 1 && hd == 128)
    launch<__nv_bfloat16, 128>(q, k, v, idx, idx_stride, out, batch, n_heads,
                               group, ring, k_sb, k_sr, k_sh, v_sb, v_sr,
                               v_sh, sm_scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
