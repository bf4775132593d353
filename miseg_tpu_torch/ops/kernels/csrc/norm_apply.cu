// Norm columns applied in one streaming pass (kernels K2 and K3), sm_90a.
//
// Replaces the Pallas TPU kernels of miseg_tpu/ops/pallas/fused_norm.py:
//   K2 `_apply_kernel` / `_apply_add_kernel` (:90, :98; `_apply` :131):
//        y = leaky(x * scale[b, c] + shift[b, c] (+ add)),
//   K3 `_apply2_kernel` (:278; `_apply2` :290), the UnetResBlock tail:
//        y = leaky((x * sx[b, c] + hx[b, c]) + (r * sr[b, c] + hr[b, c])),
// over x (and add / r) viewed [B, n] with n = S * C elements a sample and
// f32 columns [B, C]; f32 math, rounded once to x's type.
//
// What bounds it on an H100: bytes.  Each element costs a few operations
// and 4 bytes (K2), 6 (K2 with add) or 6 (K3) bytes in bf16: K3 at
// [1, 96^3, 48] moves 255 MB, 76 us at 3.35 TB/s.  The columns are a few
// KB and are read once a thread.
//
// Design.  One templated streaming body, <T, V, MODE, SLOPE>, with MODE
// apply, apply + add or two-branch; `miseg_k2_apply` runs the first two,
// `miseg_k3_apply2` the third.  A sample is cut into rows of `threads`
// vectors of V elements (16 bytes: 8 bf16/f16 or 4 f32); thread t takes
// vectors t, t + threads, ... so every warp access is coalesced.  A step
// is `unroll` consecutive rows, and the grid's (CTAs a sample, B) CTAs
// stride over the steps.  Each step issues all its 16-byte loads (up to 4
// vectors a thread, of x and of r) before any math, so tens of KB are in
// flight on every SM, what HBM needs to reach its bandwidth.  With
// C % V == 0 a vector holds V channels of one row, and since the thread
// count is a multiple of g = C / V, thread t's channel group is t % g on
// every step: it loads its V (scale, shift) pairs (and K3's residual
// pair) into registers once, as float4s.  Stores are plain: the next op
// reads y soon and may find it in L2.  No shared memory, no atomics.
// C % V != 0, an operand not 16-byte aligned, or more channel groups than
// a CTA's threads take the scalar variant (V = 1): one element a thread a
// load, its columns read per element through the read-only path.  A
// sample's base offset is 64-bit (B * n may pass 2^31), offsets inside a
// sample 32-bit, which the launcher checks.  The grid is planned by
// `fused_norm.apply_grid` from the CTAs an SM holds at once
// (`miseg_k23_resident`; the registers decide): a tensor of many waves
// takes one step of 4 rows a CTA, short CTAs that the card schedules as
// SMs free up; a smaller one at most one wave of CTAs striding over steps
// of 2 rows, which spares the partial last wave (measured against both on
// the H100 at the main-path shapes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxUnroll = 4;   // vectors a thread loads at once

enum Mode { kApply = 0, kAdd = 1, kTwo = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

struct ApplyArgs {
  const void* x;        // [B, n] of T
  const void* r;        // [B, n] of T: the add (K2) or the residual (K3); null in apply mode
  const float* sx;      // [B, C]: x's scale and shift
  const float* hx;
  const float* sr;      // [B, C]: the residual's scale and shift (K3); else null
  const float* hr;
  void* y;              // [B, n] of T
  long long n;          // elements a sample, S * C
  int C, unroll;
  float slope;
};

template <int MODE, bool SLOPE>
__device__ __forceinline__ float apply1(float x, float s, float h, float r, float sr, float hr,
                                        float slope) {
  float y = fmaf(x, s, h);
  if constexpr (MODE == kAdd) y += r;
  if constexpr (MODE == kTwo) y += fmaf(r, sr, hr);
  if constexpr (SLOPE) y = y >= 0.0f ? y : slope * y;
  return y;
}

// V consecutive f32 columns from a 16-byte boundary (V a multiple of 4; the
// launcher checks the columns' alignment), as float4s: lanes read them 32
// bytes apart, and scalar loads would cost the L1 four times the wavefronts
template <int V>
__device__ __forceinline__ void columns(const float* p, float (&out)[V]) {
#pragma unroll
  for (int k = 0; k < V; k += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + k));
    out[k] = q.x;
    out[k + 1] = q.y;
    out[k + 2] = q.z;
    out[k + 3] = q.w;
  }
}

// V elements of T as loaded: one 16-byte vector when V > 1
template <typename T, int V>
using Raw = typename std::conditional<(V > 1), uint4, T>::type;

template <typename T, int V, int MODE, bool SLOPE>
__device__ __forceinline__ void stream(const ApplyArgs& a) {
  static_assert(V == 1 || V * sizeof(T) == 16, "a vector is 16 bytes");
  const int b = blockIdx.y;
  const unsigned threads = blockDim.x;
  const long long off = (long long)b * a.n;
  const Raw<T, V>* x = reinterpret_cast<const Raw<T, V>*>(static_cast<const T*>(a.x) + off);
  const Raw<T, V>* r =
      reinterpret_cast<const Raw<T, V>*>(MODE != kApply ? static_cast<const T*>(a.r) + off : nullptr);
  Raw<T, V>* y = reinterpret_cast<Raw<T, V>*>(static_cast<T*>(a.y) + off);
  const float* sx = a.sx + (long long)b * a.C;
  const float* hx = a.hx + (long long)b * a.C;
  const float* sr = MODE == kTwo ? a.sr + (long long)b * a.C : nullptr;
  const float* hr = MODE == kTwo ? a.hr + (long long)b * a.C : nullptr;
  // this thread's columns: threads and steps are whole multiples of C / V
  float s[V], h[V], s2[V], h2[V];
  if constexpr (V > 1) {
    const int c0 = (threadIdx.x % (a.C / V)) * V;
    columns<V>(sx + c0, s);
    columns<V>(hx + c0, h);
    if constexpr (MODE == kTwo) {
      columns<V>(sr + c0, s2);
      columns<V>(hr + c0, h2);
    }
  }
  // in-sample indices are 32-bit (the launcher checks they fit); the
  // sample's base above is 64-bit
  const unsigned nvec = (unsigned)(a.n / V), step = threads * a.unroll;
  for (unsigned v0 = blockIdx.x * step + threadIdx.x; v0 < nvec; v0 += gridDim.x * step) {
    Raw<T, V> xv[kMaxUnroll], rv[kMaxUnroll];
#pragma unroll
    for (int u = 0; u < kMaxUnroll; ++u) {   // every load of the step in flight at once
      const unsigned v = v0 + u * threads;
      if (u < a.unroll && v < nvec) {
        xv[u] = __ldg(x + v);
        if constexpr (MODE != kApply) rv[u] = __ldg(r + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxUnroll; ++u) {
      const unsigned v = v0 + u * threads;
      if (!(u < a.unroll && v < nvec)) continue;
      if constexpr (V > 1) {
        const T* xe = reinterpret_cast<const T*>(&xv[u]);
        const T* re = reinterpret_cast<const T*>(&rv[u]);
        Raw<T, V> out;
        T* ye = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float rk = 0.0f, srk = 0.0f, hrk = 0.0f;
          if constexpr (MODE != kApply) rk = to_f32(re[k]);
          if constexpr (MODE == kTwo) srk = s2[k], hrk = h2[k];
          ye[k] = from_f32<T>(apply1<MODE, SLOPE>(to_f32(xe[k]), s[k], h[k], rk, srk, hrk,
                                                  a.slope));
        }
        y[v] = out;
      } else {
        const int c = (int)(v % (unsigned)a.C);
        float rk = 0.0f, srk = 0.0f, hrk = 0.0f;
        if constexpr (MODE != kApply) rk = to_f32(rv[u]);
        if constexpr (MODE == kTwo) srk = __ldg(sr + c), hrk = __ldg(hr + c);
        y[v] = from_f32<T>(apply1<MODE, SLOPE>(to_f32(xv[u]), __ldg(sx + c), __ldg(hx + c), rk,
                                               srk, hrk, a.slope));
      }
    }
  }
}

template <typename T, int V, int MODE, bool SLOPE>
__global__ void __launch_bounds__(kMaxThreads) miseg_k2_apply(ApplyArgs a) {
  stream<T, V, MODE, SLOPE>(a);
}

template <typename T, int V, bool SLOPE>
__global__ void __launch_bounds__(kMaxThreads) miseg_k3_apply2(ApplyArgs a) {
  stream<T, V, kTwo, SLOPE>(a);
}

using Kernel = void (*)(ApplyArgs);

template <typename T, int V>
Kernel select_v(int mode, bool slope) {
  if (mode == kApply)
    return slope ? &miseg_k2_apply<T, V, kApply, true> : &miseg_k2_apply<T, V, kApply, false>;
  if (mode == kAdd)
    return slope ? &miseg_k2_apply<T, V, kAdd, true> : &miseg_k2_apply<T, V, kAdd, false>;
  return slope ? &miseg_k3_apply2<T, V, true> : &miseg_k3_apply2<T, V, false>;
}

template <typename T>
Kernel select_t(int mode, int vec, bool slope) {
  return vec > 1 ? select_v<T, 16 / sizeof(T)>(mode, slope) : select_v<T, 1>(mode, slope);
}

// the instance for mode, dtype (0 f32, 1 bf16, 2 f16), vec and slope
Kernel select(int mode, int dtype, int vec, bool slope) {
  if (dtype == 0) return select_t<float>(mode, vec, slope);
  if (dtype == 1) return select_t<__nv_bfloat16>(mode, vec, slope);
  return select_t<__half>(mode, vec, slope);
}

bool variant_ok(int mode, int dtype, int vec, int threads) {
  const int width = dtype == 0 ? 4 : 8;
  return mode >= kApply && mode <= kTwo && dtype >= 0 && dtype <= 2 &&
         (vec == 1 || vec == width) && threads >= 1 && threads <= kMaxThreads;
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int run(const ApplyArgs& a, int mode, int dtype, int vec, int has_slope, int B, int threads,
        int ctas, void* stream) {
  if (!variant_ok(mode, dtype, vec, threads) || B < 1 || B > 65535 || a.n < 1 || a.C < 1 ||
      a.n % a.C || ctas < 1 || a.unroll < 1 || a.unroll > kMaxUnroll || a.x == nullptr ||
      a.y == nullptr || a.sx == nullptr || a.hx == nullptr || (mode != kApply && a.r == nullptr) ||
      (mode == kTwo && (a.sr == nullptr || a.hr == nullptr)) ||
      a.n / vec + (long long)ctas * threads * a.unroll >= (1LL << 32))   // 32-bit indices
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && (a.C % vec || threads % (a.C / vec) || !aligned(a.x) || !aligned(a.r) ||
                  !aligned(a.y) || !aligned(a.sx) || !aligned(a.hx) || !aligned(a.sr) ||
                  !aligned(a.hr)))
    return (int)cudaErrorInvalidValue;
  const Kernel k = select(mode, dtype, vec, has_slope != 0);
  k<<<dim3((unsigned)ctas, (unsigned)B), threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

ApplyArgs make_args(const void* x, const void* r, const void* sx, const void* hx, const void* sr,
                    const void* hr, void* y, long long n, int C, int unroll, float slope) {
  ApplyArgs a;
  a.x = x;
  a.r = r;
  a.sx = static_cast<const float*>(sx);
  a.hx = static_cast<const float*>(hx);
  a.sr = static_cast<const float*>(sr);
  a.hr = static_cast<const float*>(hr);
  a.y = y;
  a.n = n;
  a.C = C;
  a.unroll = unroll;
  a.slope = slope;
  return a;
}

}  // namespace

// K2.  x, add (null for none) and y: contiguous [B, n] of dtype 0 =
// float32, 1 = bfloat16, 2 = float16, n = S * C; scale, shift: f32 [B, C].
// vec: elements a load, 16 bytes' worth (C % vec == 0, x, add, y and the
// columns 16-byte aligned, threads a multiple of C / vec) or 1.  The grid (see
// fused_norm.apply_grid): `ctas` CTAs a sample of `threads` threads (at
// most 512), each loading `unroll` (at most 4) vectors at once.  slope is
// used when has_slope != 0.  Returns the CUDA error of the launch.
extern "C" int miseg_k2_apply(const void* x, const void* add, const void* scale, const void* shift,
                              void* y, int dtype, int vec, int has_slope, float slope, int B,
                              long long n, int C, int threads, int ctas, int unroll,
                              void* stream) {
  const ApplyArgs a = make_args(x, add, scale, shift, nullptr, nullptr, y, n, C, unroll, slope);
  return run(a, add != nullptr ? kAdd : kApply, dtype, vec, has_slope, B, threads, ctas, stream);
}

// K3.  x, r (the residual) and y as K2's x, add and y; sx, hx (x's
// columns) and sr, hr (r's): f32 [B, C].  The rest as miseg_k2_apply.
extern "C" int miseg_k3_apply2(const void* x, const void* sx, const void* hx, const void* r,
                               const void* sr, const void* hr, void* y, int dtype, int vec,
                               int has_slope, float slope, int B, long long n, int C,
                               int threads, int ctas, int unroll, void* stream) {
  const ApplyArgs a = make_args(x, r, sx, hx, sr, hr, y, n, C, unroll, slope);
  return run(a, kTwo, dtype, vec, has_slope, B, threads, ctas, stream);
}


// The CTAs of `threads` threads an SM holds at once of the instance that
// miseg_k2_apply (mode 0, or 1 with an add) or miseg_k3_apply2 (mode 2)
// launches for dtype, vec and has_slope, into *ctas (their registers
// decide it).  Returns the CUDA error.
extern "C" int miseg_k23_resident(int mode, int dtype, int vec, int has_slope, int threads,
                                  int* ctas) {
  if (!variant_ok(mode, dtype, vec, threads) || ctas == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, select(mode, dtype, vec, has_slope != 0), threads, 0);
}
