// Windowed multi-head attention for Swin, forward (kernel K5), sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `_attn_kernel_nomask`
// (miseg_tpu/ops/pallas/window_attention.py:64-85, called from
// `_pallas_forward`).  Per window w and head h:
//     out = softmax(q k^T * hd^-1/2 + bias[h] + (-100 where ids differ)) v
// with region ids taken from row `w % n_ids_windows`.
//
// What bounds it on an H100: at stage 1 of the 96^3 flagship a call moves
// about 45 MB (q, k, v, out, the bias) and does 7.75 GFLOP, so the
// bf16 tensor-core bound is ~8 us and the memory bound ~14 us.  This first
// version is deliberately simple and runs the products on the CUDA cores
// in f32, so it is bound by shared-memory reads of K and V (one per FMA),
// far above both bounds.  Design: one CTA per (window, head); K and V of
// the window (N <= 343 tokens, head dim <= 64) are staged once in shared
// memory as f32 (K rows padded to hd+1 so the score loop is free of bank
// conflicts), and each warp walks query rows.  A lane holds the scores of
// the keys j = lane + 32 t in registers, the softmax runs in f32 with warp
// shuffles, and P.V splits the keys between lane groups of `hd` lanes.
// The score matrix never leaves the SM.  Tensor-core (mma/wgmma) tiles are
// the later optimisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxN = 343;
constexpr int kMaxT = (kMaxN + 31) / 32;  // score slots per lane
constexpr int kMaxHd = 64;
constexpr float kMaskValue = -100.0f;     // additive, as ops/window.py

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int n, int hd) {
  size_t floats = (size_t)n * (hd + 1)   // K, padded rows
                + (size_t)n * hd          // V
                + (size_t)kWarps * n      // one probability row per warp
                + (size_t)kWarps * hd     // one query row per warp
                + (size_t)kWarps * 32;    // P.V partial sums per warp
  return floats * sizeof(float) + (size_t)n * sizeof(int);  // + region ids
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, long long stride_w,
                        long long stride_n, const float* __restrict__ bias,
                        const int* __restrict__ ids, int n_ids_windows,
                        T* __restrict__ out, int n, int heads, int hd,
                        float scale) {
  extern __shared__ float smem[];
  const int kstride = hd + 1;
  float* ks = smem;
  float* vs = ks + n * kstride;
  float* ps = vs + n * hd;
  float* qs = ps + kWarps * n;
  float* red = qs + kWarps * hd;
  int* id_s = reinterpret_cast<int*>(red + kWarps * 32);

  const int w = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int c = heads * hd;
  const long long base = (long long)w * stride_w + (long long)h * hd;

  for (int e = threadIdx.x; e < n * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    const long long off = base + (long long)j * stride_n + d;
    ks[j * kstride + d] = to_f32(k[off]);
    vs[j * hd + d] = to_f32(v[off]);
  }
  const bool masked = ids != nullptr;
  if (masked) {
    const int* row = ids + (long long)(w % n_ids_windows) * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) id_s[j] = row[j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * n;
  float* qw = qs + warp * hd;
  float* rw = red + warp * 32;
  const float* bias_h = bias + (long long)h * n * n;
  const int groups = hd >= 32 ? 1 : 32 / hd;
  T* out_w = out + (long long)w * n * c + (long long)h * hd;

  for (int i = warp; i < n; i += kWarps) {
    const long long qoff = base + (long long)i * stride_n;
    for (int d = lane; d < hd; d += 32) qw[d] = to_f32(q[qoff + d]);
    __syncwarp();

    const int id_i = masked ? id_s[i] : 0;
    const float* bias_i = bias_h + (long long)i * n;
    float s[kMaxT];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < n) {
        const float* kr = ks + j * kstride;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qw[d], kr[d], acc);
        float val = acc * scale + bias_i[j];
        if (masked && id_s[j] != id_i) val += kMaskValue;
        s[t] = val;
        mx = fmaxf(mx, val);
      }
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        const float e = expf(s[t] - mx);
        p[j] = e;
        sum += e;
      }
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv_sum = 1.0f / sum;
    __syncwarp();

    T* out_i = out_w + (long long)i * c;
    if (hd <= 32) {
      // lane = g * hd + d: lane group g sums keys j = g, g + groups, ...
      const int d = lane % hd, g = lane / hd;
      float acc = 0.0f;
      if (g < groups)
        for (int j = g; j < n; j += groups) acc = fmaf(p[j], vs[j * hd + d], acc);
      rw[lane] = acc;
      __syncwarp();
      if (lane < hd) {
        float tot = 0.0f;
        for (int gg = 0; gg < groups; ++gg) tot += rw[gg * hd + lane];
        out_i[lane] = from_f32<T>(tot * inv_sum);
      }
    } else {
      for (int d = lane; d < hd; d += 32) {
        float acc = 0.0f;
        for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * hd + d], acc);
        out_i[d] = from_f32<T>(acc * inv_sum);
      }
    }
    __syncwarp();  // qw, p and rw are rewritten for the next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   long long stride_w, long long stride_n, const void* bias,
                   const void* ids, int n_ids_windows, void* out, int bw,
                   int n, int heads, int hd, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, hd);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_kernel<T><<<bw * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), stride_w, stride_n,
      static_cast<const float*>(bias), static_cast<const int*>(ids),
      n_ids_windows, static_cast<T*>(out), n, heads, hd,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/k/v are [bw, n, heads*hd] views
// sharing strides (stride_w between windows, stride_n between tokens, unit
// stride over channels); bias is f32 [heads, n, n]; ids is int32
// [n_ids_windows, n] or null; out is a contiguous [bw, n, heads*hd].
// Returns the CUDA error code of the launch (0 on success).
extern "C" int miseg_window_attention(const void* q, const void* k,
                                      const void* v, long long stride_w,
                                      long long stride_n, const void* bias,
                                      const void* ids, int n_ids_windows,
                                      void* out, int bw, int n, int heads,
                                      int hd, int dtype, void* stream) {
  if (n < 1 || n > kMaxN || hd < 1 || hd > kMaxHd || bw < 1 || heads < 1 ||
      (ids != nullptr && n_ids_windows < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, stride_w, stride_n, bias, ids, n_ids_windows,
                        out, bw, n, heads, hd, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, stride_w, stride_n, bias, ids,
                                n_ids_windows, out, bw, n, heads, hd, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
