// Windowed multi-head attention for Swin, forward (kernel K5), sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `_attn_kernel_nomask`
// (miseg_tpu/ops/pallas/window_attention.py:64-85, called from
// `_pallas_forward`).  Per window w and head h:
//     out = softmax(q k^T * hd^-1/2 + bias[h] + (-100 where ids differ)) v
// with region ids taken from row `w % n_ids_windows`.
//
// Two kernels, chosen by dtype:
//
// miseg_k5_attn_mma (bf16, the served path).  What bounds it on an H100:
// at stage 1 of the 96^3 flagship (343 windows x 343 tokens, 3 heads of
// dim 16) a call moves 45 MB of q, k, v, out, bias and ids from device
// memory and does 7.75 GFLOP of products, a bound of ~14 us by bytes
// (~8 us by bf16 tensor-core operations).  The work around the products
// is larger: 121 M scores (139 M with the padding to 64-row query blocks
// and 352 keys), each with a scale, a bias, a mask, an exp and a
// normalisation, against the SM's 16 exps and 128 lane operations a
// clock.  The first version (CUDA cores, f32, one CTA per
// (window, head)) also read each head's whole f32 bias once per window:
// 470 KB per CTA, 484 MB per stage-1 call from L2.
// Design:
//   * Products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//     accumulators) fed by ldmatrix.  A warp owns 16 query rows; at head
//     dim 16 one MMA makes a 16x8 score tile.  N is padded to a multiple
//     of 16 in shared memory (343 -> 352); padded keys score -inf against
//     zero K/V rows.  Head dims that are not a multiple of 16 are zero-
//     padded in shared memory (HDP = 16, 32, 48, 64).
//   * Softmax in f32, exact: P is normalised before it is rounded to
//     bf16, as the Pallas kernel rounds it (and as the plain version does
//     in bf16), then fed register to register as the A operand of P.V, as
//     FlashAttention-2 does.  At head dim 16 with N = 343 or 216 (every
//     main-path call) a thread keeps all its 2 x 8 x NKB scores in
//     registers: one pass, one exp per score, and every loop over key
//     blocks unrolled (a kernel per NKB and per mask), so addresses are a
//     base plus immediates and only the last block tests for padded keys.
//     At ~210 registers a thread, two CTAs (8 warps) fit an SM, so the
//     kernel is bound by latency at that occupancy rather than by issue
//     or bytes.  Other shapes take two passes, recomputing the scores.
//   * A window whose region ids are all one region (216 of stage 1's 343
//     shifted windows, 27 of stage 2's 64) takes the unmasked code: the
//     -100 would never be added there.
//   * The bias is read once per group of windows: one CTA per (head,
//     block of 64 query rows, group of G windows) stages its 64 bias rows
//     (88 KB of f32) once with cp.async and walks the G windows, staging
//     each window's Q, K and V (swizzled against ldmatrix bank conflicts
//     at HDP 16).  G is chosen so that a call makes about 8 CTAs per SM
//     (two resident), at least 1.  Bias bytes per call as designed: heads
//     x ceil(bw / G) x N^2 x 4 from L2; on 132 SMs stage 1 (G = 5) 3 x 69
//     x 471 KB = 97 MB, stage 2 (G = 2) 90 MB, stage 3 (G = 1) 45 MB and
//     stage 4 4.5 MB, against 484, 181, 45 and 4.5 MB before.
//   * q, k and v may be strided views of one qkv projection; rows of 8
//     aligned bf16 copy 16 bytes a thread, anything else element-wise.
//
// window_attention_kernel (f32).  CUDA cores in f32, no TF32, as the f32
// model check on the card needs 1e-4: one CTA per (window, head); K and V
// staged once in shared memory as f32 (K rows padded to hd+1 so the score
// loop is free of bank conflicts); each warp walks query rows, a lane
// holds the scores of keys j = lane + 32 t in registers, the softmax runs
// in f32 with warp shuffles, and P.V splits the keys between lane groups.
// It is bound by shared-memory reads of K and V (one per FMA).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

#include <type_traits>

namespace {

using miseg::ldmatrix_x4;
using miseg::ldmatrix_x4_trans;
using miseg::mma_bf16;
using miseg::smem_u32;

constexpr int kWarps = 8;
constexpr int kMaxN = 343;
constexpr int kMaxT = (kMaxN + 31) / 32;  // score slots per lane
constexpr int kMaxHd = 64;
constexpr float kMaskValue = -100.0f;     // additive, as ops/window.py

// ---------------------------------------------------------------------------
// f32: CUDA cores.

size_t smem_bytes(int n, int hd) {
  size_t floats = (size_t)n * (hd + 1)   // K, padded rows
                + (size_t)n * hd          // V
                + (size_t)kWarps * n      // one probability row per warp
                + (size_t)kWarps * hd     // one query row per warp
                + (size_t)kWarps * 32;    // P.V partial sums per warp
  return floats * sizeof(float) + (size_t)n * sizeof(int);  // + region ids
}

__global__ void __launch_bounds__(kWarps * 32)
window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, long long stride_w,
                        long long stride_n, const float* __restrict__ bias,
                        const int* __restrict__ ids, int n_ids_windows,
                        float* __restrict__ out, int n, int heads, int hd,
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
    ks[j * kstride + d] = k[off];
    vs[j * hd + d] = v[off];
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
  float* out_w = out + (long long)w * n * c + (long long)h * hd;

  for (int i = warp; i < n; i += kWarps) {
    const long long qoff = base + (long long)i * stride_n;
    for (int d = lane; d < hd; d += 32) qw[d] = q[qoff + d];
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

    float* out_i = out_w + (long long)i * c;
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
        out_i[lane] = tot * inv_sum;
      }
    } else {
      for (int d = lane; d < hd; d += 32) {
        float acc = 0.0f;
        for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * hd + d], acc);
        out_i[d] = acc * inv_sum;
      }
    }
    __syncwarp();  // qw, p and rw are rewritten for the next row
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       long long stride_w, long long stride_n, const void* bias,
                       const void* ids, int n_ids_windows, void* out, int bw,
                       int n, int heads, int hd, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, hd);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_kernel<<<bw * heads, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), stride_w, stride_n,
      static_cast<const float*>(bias), static_cast<const int*>(ids),
      n_ids_windows, static_cast<float*>(out), n, heads, hd,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16).

constexpr int kQRows = 64;                 // query rows per CTA
constexpr int kKeyPad = (kMaxN + 15) / 16 * 16;  // 352
constexpr int kBiasLd = 344;               // smem bias row stride: = 24 mod 32 banks
constexpr int kMmaThreads = kQRows / 16 * 32;  // a warp per 16 query rows
constexpr int kCtasPerSm = 8;              // G is chosen for about this many

template <int HDP>
struct MmaSmem {
  static constexpr int KV_LD = HDP == 16 ? 16 : HDP + 8;  // bf16 per Q/K/V row
  static constexpr size_t BIAS = (size_t)kQRows * kBiasLd * sizeof(float);
  static constexpr size_t KV = (size_t)kKeyPad * KV_LD * sizeof(__nv_bfloat16);
  static constexpr size_t Q = (size_t)kQRows * KV_LD * sizeof(__nv_bfloat16);
  static constexpr size_t BYTES = BIAS + 2 * KV + Q + kKeyPad * sizeof(int);
};

// bf16 offset of the 8-element chunk `chunk` of K/V row `row`.  At HDP 16
// a row is 32 bytes and the chunks of rows 4..7 of every 8 swap places, so
// the 8 rows of an ldmatrix phase hit 8 distinct groups of 4 banks; wider
// rows are padded by 16 bytes instead.
template <int HDP>
__device__ __forceinline__ int kv_off(int row, int chunk) {
  if (HDP == 16) return row * 16 + ((chunk ^ ((row >> 2) & 1)) << 3);
  return row * (HDP + 8) + (chunk << 3);
}

// Asynchronous global -> shared copies: a staging loop issues all of its
// loads before any of them lands, instead of waiting on each.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (m, l) of a row part: running max and the sum of exp(s - m)
__device__ __forceinline__ void online(float& m, float& l, float tile_max) {
  if (tile_max > m) {
    l *= __expf(m - tile_max);  // m = -inf: l is 0 and stays 0
    m = tile_max;
  }
}

__device__ __forceinline__ void merge_quad(float& m, float& l) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, mo);
    const float base = mn == -INFINITY ? 0.0f : mn;
    l = l * __expf(m - base) + lo * __expf(mo - base);
    m = mn;
  }
}

// Grid: x = (window group * heads + head) * query blocks + query block; a
// warp per 16 query rows.  Fragment notation: g = lane / 4, t = lane % 4; a
// thread holds query rows g and g + 8 of its warp's 16, and columns 2t,
// 2t + 1 of each 8-column tile.
//
// NKB > 0 (HDP 16, N in (16 (NKB - 1), 16 NKB]): one pass, this thread's
// 2 x 8 NKB scores stay in registers; every loop over key blocks unrolls,
// so addresses are a base plus immediates and only the last block checks
// for padded keys.  NKB = 0 (any other shape): two passes, recomputing
// the scores: pass 1 takes each row's max and sum, pass 2 normalises.
template <int HDP, int NKB, bool MASKED>
__global__ void __launch_bounds__(kMmaThreads, 2)
miseg_k5_attn_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, long long stride_w,
                  long long stride_n, const float* __restrict__ bias,
                  const int* __restrict__ ids, int n_ids_windows,
                  __nv_bfloat16* __restrict__ out, int bw, int n, int heads,
                  int hd, int group, int vec, float scale) {
  static_assert(NKB == 0 || HDP == 16, "the one-pass kernel is for head dim 16");
  using Sh = MmaSmem<HDP>;
  constexpr int KSTEPS = HDP / 16, DT = HDP / 8, CH = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* bias_s = reinterpret_cast<float*>(smem_mma);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma + Sh::BIAS);
  __nv_bfloat16* vs = ks + kKeyPad * Sh::KV_LD;
  __nv_bfloat16* qs = vs + kKeyPad * Sh::KV_LD;
  int* id_s = reinterpret_cast<int*>(qs + kQRows * Sh::KV_LD);

  const int qblocks = (n + kQRows - 1) / kQRows;
  const int qb = blockIdx.x % qblocks;
  const int h = (blockIdx.x / qblocks) % heads;
  const int w0 = blockIdx.x / (qblocks * heads) * group;
  const int w1 = min(bw, w0 + group);
  const int row0 = qb * kQRows, nrows = min(kQRows, n - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nkb = NKB > 0 ? NKB : (n + 15) / 16;
  const int c = heads * hd;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // the bias rows of this query block, once for the whole group: a warp
  // per row, lanes along it
  const float* bias_h = bias + ((long long)h * n + row0) * n;
  for (int r = warp; r < nrows; r += kMmaThreads / 32)
    for (int j = lane; j < n; j += 32)
      cp_async4(bias_s + r * kBiasLd + j, bias_h + (long long)r * n + j);
  // padded key rows, and the query rows past N, stay zero for every window
  for (int e = tid; e < (nkb * 16 - n) * HDP; e += kMmaThreads) {
    const int j = n + e / HDP, d = e % HDP;
    ks[kv_off<HDP>(j, d >> 3) + (d & 7)] = zero;
    vs[kv_off<HDP>(j, d >> 3) + (d & 7)] = zero;
  }
  for (int e = tid; e < (kQRows - nrows) * HDP; e += kMmaThreads) {
    const int r = nrows + e / HDP, d = e % HDP;
    qs[kv_off<HDP>(r, d >> 3) + (d & 7)] = zero;
  }

  const int wrow = warp * 16;                  // the warp's rows in the block
  const bool active = wrow < nrows;
  const int rl = wrow + g, rh = rl + 8;        // this thread's rows in the block
  const int ql = row0 + rl, qh = row0 + rh;    // ... and in the window
  // per-lane bases; key block kb adds kb * 16 rows (the HDP 16 swizzle
  // depends on row / 4 mod 2 only, which kb * 16 keeps)
  const float* brl = bias_s + rl * kBiasLd + 2 * t;
  const float* brh = bias_s + rh * kBiasLd + 2 * t;
  const int* idc = id_s + 2 * t;
  const __nv_bfloat16* kp = ks + kv_off<HDP>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const __nv_bfloat16* vp = vs + kv_off<HDP>((lane & 7) + (((lane >> 3) & 1) << 3), lane >> 4);
  constexpr int KV_BLOCK = 16 * Sh::KV_LD;     // bf16 per 16 key rows

  for (int w = w0; w < w1; ++w) {
    __syncthreads();  // the bias is staged; every warp left the last window
    const long long base = (long long)w * stride_w + (long long)h * hd;
    const __nv_bfloat16* qw = q + base + (long long)row0 * stride_n;
    if (vec) {        // 16-byte copies: hd % 8 == 0 and aligned rows
      for (int e = tid; e < n * CH; e += kMmaThreads) {
        const int j = e / CH, ch = e - j * CH;
        if (ch * 8 < hd) {
          const long long off = base + (long long)j * stride_n + ch * 8;
          cp_async16(ks + kv_off<HDP>(j, ch), k + off);
          cp_async16(vs + kv_off<HDP>(j, ch), v + off);
        } else {
          *reinterpret_cast<uint4*>(ks + kv_off<HDP>(j, ch)) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vs + kv_off<HDP>(j, ch)) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      for (int e = tid; e < nrows * CH; e += kMmaThreads) {
        const int r = e / CH, ch = e - r * CH;
        if (ch * 8 < hd)
          cp_async16(qs + kv_off<HDP>(r, ch), qw + (long long)r * stride_n + ch * 8);
        else
          *reinterpret_cast<uint4*>(qs + kv_off<HDP>(r, ch)) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < n * HDP; e += kMmaThreads) {
        const int j = e / HDP, d = e - j * HDP;
        const long long off = base + (long long)j * stride_n + d;
        ks[kv_off<HDP>(j, d >> 3) + (d & 7)] = d < hd ? k[off] : zero;
        vs[kv_off<HDP>(j, d >> 3) + (d & 7)] = d < hd ? v[off] : zero;
      }
      for (int e = tid; e < nrows * HDP; e += kMmaThreads) {
        const int r = e / HDP, d = e - r * HDP;
        qs[kv_off<HDP>(r, d >> 3) + (d & 7)] = d < hd ? qw[(long long)r * stride_n + d] : zero;
      }
    }
    if (MASKED) {
      const int* row = ids + (long long)(w % n_ids_windows) * n;
      for (int j = tid; j < n; j += kMmaThreads) cp_async4(id_s + j, row + j);
    }
    cp_async_wait_all();
    // a window whose ids are all one region (most of a shifted block's)
    // needs no mask: those take the unmasked code
    bool mine = false;
    if (MASKED) {
      const int* row = ids + (long long)(w % n_ids_windows) * n;
      const int first = __ldg(row);
      for (int j = tid; j < n; j += kMmaThreads) mine |= id_s[j] != first;
    }
    const bool mixed = __syncthreads_or(mine);
    if (!active) continue;

    auto attend = [&](auto mask_tag) {
      constexpr bool M = decltype(mask_tag)::value;
      // this warp's A fragments of Q
      uint32_t qa[KSTEPS][4];
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        ldmatrix_x4(qa[s], qs + kv_off<HDP>(wrow + (lane & 15), 2 * s + (lane >> 4)));
      const int id_l = M && ql < n ? id_s[ql] : 0;
      const int id_h = M && qh < n ? id_s[qh] : 0;

      // scores of key block kb: sc[nt][i], nt = 8-key tile, i = (row g: 0, 1;
      // row g + 8: 2, 3) x (column 2t, 2t + 1).  The scale and the bias are
      // one FMA: exact when hd^-1/2 is a power of two (hd 16), else it
      // differs from the plain version's two roundings in the last f32 bit.
      // Keys past N (only in the last block, `edge`) score -inf.
      auto scores = [&](int kb, bool edge, float (&sc)[2][4]) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] = 0.0f;
#pragma unroll
        for (int s = 0; s < KSTEPS; ++s) {
          uint32_t b[4];
          ldmatrix_x4(b, kp + kb * KV_BLOCK + s * 16);
          mma_bf16(sc[0], qa[s], b[0], b[1]);
          mma_bf16(sc[1], qa[s], b[2], b[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int off = kb * 16 + nt * 8;        // + 2t in the bases
          const int col = off + 2 * t;             // col + 1 < kBiasLd when col < n
          const bool v0 = !edge || col < n, v1 = !edge || col + 1 < n;
          float2 bl = make_float2(0.0f, 0.0f), bh = bl;
          int2 idv = make_int2(id_l, id_l);
          if (v0) {
            bl = *reinterpret_cast<const float2*>(brl + off);
            bh = *reinterpret_cast<const float2*>(brh + off);
            if (M) idv = *reinterpret_cast<const int2*>(idc + off);
          }
          float* x = sc[nt];
          x[0] = fmaf(x[0], scale, bl.x);
          x[1] = fmaf(x[1], scale, bl.y);
          x[2] = fmaf(x[2], scale, bh.x);
          x[3] = fmaf(x[3], scale, bh.y);
          if (M) {
            x[0] += idv.x != id_l ? kMaskValue : 0.0f;
            x[1] += idv.y != id_l ? kMaskValue : 0.0f;
            x[2] += idv.x != id_h ? kMaskValue : 0.0f;
            x[3] += idv.y != id_h ? kMaskValue : 0.0f;
          }
          if (edge) {
            x[0] = v0 ? x[0] : -INFINITY;
            x[1] = v1 ? x[1] : -INFINITY;
            x[2] = v0 ? x[2] : -INFINITY;
            x[3] = v1 ? x[3] : -INFINITY;
          }
        }
      };

      // acc += P.V over key block kb, P's A fragment in registers.  Two
      // accumulator sets, alternating by block, so consecutive blocks' MMAs
      // do not wait on each other.
      float o[2][DT][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[a][dt][i] = 0.0f;
      auto pv = [&](int kb, const uint32_t (&pa)[4], float (&acc)[DT][4]) {
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vp + kb * KV_BLOCK + dp * 16);
          mma_bf16(acc[2 * dp], pa, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
        }
      };

      if constexpr (NKB > 0) {
        float sc[NKB][2][4];
        float ml = -INFINITY, mh = -INFINITY;
#pragma unroll
        for (int kb = 0; kb < NKB; ++kb) {
          scores(kb, kb == NKB - 1, sc[kb]);
          ml = fmaxf(ml, fmaxf(fmaxf(sc[kb][0][0], sc[kb][0][1]),
                               fmaxf(sc[kb][1][0], sc[kb][1][1])));
          mh = fmaxf(mh, fmaxf(fmaxf(sc[kb][0][2], sc[kb][0][3]),
                               fmaxf(sc[kb][1][2], sc[kb][1][3])));
        }
        ml = quad_max(ml);
        mh = quad_max(mh);
        const float nl = -ml * kLog2e, nh = -mh * kLog2e;
        float ll[2] = {0.0f, 0.0f}, lh[2] = {0.0f, 0.0f};
#pragma unroll
        for (int kb = 0; kb < NKB; ++kb)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* x = sc[kb][nt];
            x[0] = exp2_approx(fmaf(x[0], kLog2e, nl));
            x[1] = exp2_approx(fmaf(x[1], kLog2e, nl));
            x[2] = exp2_approx(fmaf(x[2], kLog2e, nh));
            x[3] = exp2_approx(fmaf(x[3], kLog2e, nh));
            ll[nt] += x[0] + x[1];
            lh[nt] += x[2] + x[3];
          }
        const float il = 1.0f / quad_sum(ll[0] + ll[1]);
        const float ih = 1.0f / quad_sum(lh[0] + lh[1]);
#pragma unroll
        for (int kb = 0; kb < NKB; ++kb) {
          const float(&x)[2][4] = sc[kb];
          const uint32_t pa[4] = {pack_bf16(x[0][0] * il, x[0][1] * il),
                                  pack_bf16(x[0][2] * ih, x[0][3] * ih),
                                  pack_bf16(x[1][0] * il, x[1][1] * il),
                                  pack_bf16(x[1][2] * ih, x[1][3] * ih)};
          pv(kb, pa, o[kb & 1]);
        }
      } else {
        float ml = -INFINITY, mh = -INFINITY, ll = 0.0f, lh = 0.0f;
        for (int kb = 0; kb < nkb; ++kb) {
          float sc[2][4];
          scores(kb, kb == nkb - 1, sc);
          online(ml, ll, fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1])));
          online(mh, lh, fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3])));
          const float bl = ml == -INFINITY ? 0.0f : ml, bh = mh == -INFINITY ? 0.0f : mh;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            ll += __expf(sc[nt][0] - bl) + __expf(sc[nt][1] - bl);
            lh += __expf(sc[nt][2] - bh) + __expf(sc[nt][3] - bh);
          }
        }
        merge_quad(ml, ll);
        merge_quad(mh, lh);
        const float il = 1.0f / ll, ih = 1.0f / lh;
        for (int kb = 0; kb < nkb; ++kb) {
          float sc[2][4];
          scores(kb, kb == nkb - 1, sc);
          const uint32_t pa[4] = {
              pack_bf16(__expf(sc[0][0] - ml) * il, __expf(sc[0][1] - ml) * il),
              pack_bf16(__expf(sc[0][2] - mh) * ih, __expf(sc[0][3] - mh) * ih),
              pack_bf16(__expf(sc[1][0] - ml) * il, __expf(sc[1][1] - ml) * il),
              pack_bf16(__expf(sc[1][2] - mh) * ih, __expf(sc[1][3] - mh) * ih)};
          pv(kb, pa, o[0]);
        }
      }

      __nv_bfloat16* out_w = out + (long long)w * n * c + (long long)h * hd;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int d = dt * 8 + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? ql : qh, dd = d + (i & 1);
          if (row < n && dd < hd)
            out_w[(long long)row * c + dd] = __float2bfloat16(o[0][dt][i] + o[1][dt][i]);
        }
      }
    };
    if constexpr (MASKED) {
      if (mixed)
        attend(std::true_type{});
      else
        attend(std::false_type{});
    } else {
      attend(std::false_type{});
    }
  }
}

// Windows per CTA: about kCtasPerSm CTAs per SM over the call, at least 1.
int window_group(int bw, int n, int heads) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_window = (long long)heads * ((n + kQRows - 1) / kQRows);
  const long long want = (long long)kCtasPerSm * sms;
  const long long grp = (long long)bw * per_window / want;
  return (int)(grp < 1 ? 1 : grp > bw ? bw : grp);
}

template <int HDP, int NKB, bool MASKED>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       long long stride_w, long long stride_n, const void* bias,
                       const void* ids, int n_ids_windows, void* out, int bw,
                       int n, int heads, int hd, cudaStream_t stream) {
  const size_t smem = MmaSmem<HDP>::BYTES;
  auto kernel = miseg_k5_attn_mma<HDP, NKB, MASKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int group = window_group(bw, n, heads);
  const long long ctas =
      (long long)((bw + group - 1) / group) * heads * ((n + kQRows - 1) / kQRows);
  const int vec = hd % 8 == 0 && stride_w % 8 == 0 && stride_n % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  kernel<<<(unsigned)ctas, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), stride_w, stride_n,
      static_cast<const float*>(bias), static_cast<const int*>(ids), n_ids_windows,
      static_cast<__nv_bfloat16*>(out), bw, n, heads, hd, group, vec,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <int HDP, int NKB>
cudaError_t launch_masked(const void* q, const void* k, const void* v,
                          long long stride_w, long long stride_n, const void* bias,
                          const void* ids, int n_ids_windows, void* out, int bw,
                          int n, int heads, int hd, cudaStream_t stream) {
  return ids != nullptr
             ? launch_mma<HDP, NKB, true>(q, k, v, stride_w, stride_n, bias, ids,
                                          n_ids_windows, out, bw, n, heads, hd, stream)
             : launch_mma<HDP, NKB, false>(q, k, v, stride_w, stride_n, bias, ids,
                                           n_ids_windows, out, bw, n, heads, hd, stream);
}

}  // namespace

// Windows per CTA that a bf16 call of this shape makes on this device.
extern "C" int miseg_window_attention_group(int bw, int n, int heads) {
  return window_group(bw, n, heads);
}

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
  if (dtype == 0)
    return (int)launch_f32(q, k, v, stride_w, stride_n, bias, ids, n_ids_windows,
                           out, bw, n, heads, hd, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int hdp = (hd + 15) / 16 * 16, nkb = (n + 15) / 16;
#define MISEG_K5_LAUNCH(HDP, NKB)                                                    \
  return (int)launch_masked<HDP, NKB>(q, k, v, stride_w, stride_n, bias, ids,        \
                                      n_ids_windows, out, bw, n, heads, hd, s)
  // the main path's shapes: head dim 16 with N = 343 (7^3) or 216 (6^3)
  if (hdp == 16 && nkb == 22) MISEG_K5_LAUNCH(16, 22);
  if (hdp == 16 && nkb == 14) MISEG_K5_LAUNCH(16, 14);
  switch (hdp) {
    case 16: MISEG_K5_LAUNCH(16, 0);
    case 32: MISEG_K5_LAUNCH(32, 0);
    case 48: MISEG_K5_LAUNCH(48, 0);
    default: MISEG_K5_LAUNCH(64, 0);
  }
#undef MISEG_K5_LAUNCH
}
