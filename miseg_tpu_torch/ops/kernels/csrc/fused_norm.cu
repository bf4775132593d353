// Instance-norm statistics folded into norm columns (kernel K1), sm_90a.
//
// Replaces the Pallas TPU kernel `_stats_kernel` (miseg_tpu/ops/pallas/
// fused_norm.py:78-87, called from `_stats` :115-128) with the fold that
// follows it (`norm_columns` :181-190), which also turns K4's statistics
// (`conv3_norm_stats`, fused_conv.py:215) into the next norm's columns.
// Two entry points, each one launch:
//   miseg_k1_stats: x [B, S, C] -> f32 (scale, shift) [B, C];
//   miseg_k1_fold:  K4's per-tile (mean, M2) partials [2, B * n_tiles, C]
//                   -> the same columns,
// with scale = gamma * rsqrt(var + eps), shift = beta - mean * scale, and
// gamma/beta none, [C], or the [n_styles, C] bank row of the clamped style
// id of each sample.  In moments mode (`moments` != 0; no gamma/beta) both
// write the sample's f32 (mean, M2) [2, B, C] in place of the columns: the
// same reduction with another tail, for spatial partitioning, where each
// rank holds a D slab of the volume and the ranks' moments are merged
// (Chan's formula, `parallel/spatial.py` `merge_moments`) before the
// columns are folded on the host side.
//
// What bounds it on an H100: reading x once, 85 MB at [1, 96^3, 48] bf16,
// 25 us at 3.35 TB/s; the arithmetic is a few operations an element.  The
// TPU kernel folds (sum, sum^2) to a ONE-pass variance, which loses digits
// when var << mean^2; here every statistic is taken two-pass over a tile
// held in registers and tiles are merged with Chan's formula.
//
// Design.  miseg_k1_stats runs a grid of (row chunk, channel block,
// sample) CTAs, about three per SM (the planner is `fused_norm.stats_grid`).
// In [B, S, C] a row chunk of a whole-row channel block is one contiguous
// range, which the CTA sweeps linearly: with 16-byte loads (C a multiple of
// 8 bf16 or 4 f32 channels), thread t keeps channel group t % G of the G =
// block_c / V groups of V channels and row lane t / G, so one step of the
// CTA reads kUnroll * lanes consecutive rows and each thread has kUnroll
// loads in flight (96 KB an SM at C = 48).  Other channel counts load one
// element at a time.  A thread takes the (mean, M2) of its kUnroll x V
// sub-tile two-pass and merges it into its running (mean, M2); the last
// step of a chunk loads only the rows left, at once.  The CTA merges the
// lanes that saw rows in shared memory up a fixed tree and writes one
// partial per (chunk, channel).  The planner sizes the chunks to the fewest dependent
// memory round trips a thread waits for: its steps plus the last CTA's
// merge.  Then it adds one to the integer arrival counter of
// its (sample, channel block): the last CTA to arrive merges the sample's
// partials in chunk order (lane l takes chunks l, l + lanes, ..., four
// channels a load, then the lanes merge up the same tree), folds in
// gamma/beta, writes the columns
// and resets the counter to 0.  No float atomics, and a fixed merge order:
// a repeated call is bit-identical whatever the order of arrival.  A block
// holds at most 8 load groups (64 bf16 channels), so a CTA has at least 32
// row lanes and the last CTA's merge at least 16 lanes a column: wider
// channels take several blocks.  Short rows under wide channels ([1, 27,
// 3072]) narrow the blocks further instead of splitting rows, and a sample
// of one chunk folds in its own CTA with no counter.
// miseg_k1_fold merges K4's partials in groups of `group` consecutive
// tiles, one CTA per (group, channel block, sample), into one partial per
// group; the last CTA to arrive merges the group partials in order and
// folds.  At 96^3 a sample's 3456 bricks are 54 groups of 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxEntries = 2048;   // (lane, channel) pairs a CTA merges: threads x V
constexpr int kUnroll = 8;          // rows a thread of miseg_k1_stats loads at once
constexpr int kFoldLoads = 8;       // items a lane of the merge loads at once (half as many as float4s)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// V consecutive elements of T as loaded: one 16-byte load when V > 1
template <typename T, int V>
using Raw = typename std::conditional<(V > 1), uint4, T>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  if constexpr (V > 1) {
    static_assert(V * sizeof(T) == 16, "a vector load is 16 bytes");
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return *p;
  }
}

// element k of a loaded vector, as f32
template <typename T, int V>
__device__ __forceinline__ float element(const Raw<T, V>& r, int k) {
  if constexpr (V > 1)
    return to_f32(reinterpret_cast<const T*>(&r)[k]);
  else
    return to_f32(r);
}

// (n, mean, m2) += (nb, mb, m2b) by Chan's formula
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.0f) return;
  const float tot = n + nb, f = nb / tot, d = mb - mean;
  mean = fmaf(d, f, mean);
  m2 = m2 + m2b + d * d * (n * f);
  n = tot;
}

struct Affine {
  const void* gamma;    // null, [C] or [n_styles, C]
  const void* beta;
  const int* styles;    // [B] style ids (mode 2), clamped here
  int dtype;            // of gamma and beta: 0 f32, 1 bf16, 2 f16
  int mode;             // 0 none, 1 [C], 2 [n_styles, C]
  int n_styles;
};

__device__ __forceinline__ float param(const void* p, int dtype, long long i) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

struct Entries {
  float n[kMaxEntries], mean[kMaxEntries], m2[kMaxEntries];
};

// Merge lanes [0, width) of entries laid out [lane][stride] into lane 0 for
// columns [0, ncols), up a fixed tree: at each level lane l takes lane
// l + half.  Starts and ends synchronised.
__device__ void merge_lanes(Entries& e, int width, int stride, int ncols) {
  __syncthreads();
  while (width > 1) {
    const int half = (width + 1) / 2, pairs = width - half;
    for (int i = threadIdx.x; i < pairs * ncols; i += blockDim.x) {
      const int l = i / ncols, c = i - l * ncols;
      const int dst = l * stride + c, src = (l + half) * stride + c;
      chan(e.n[dst], e.mean[dst], e.m2[dst], e.n[src], e.mean[src], e.m2[src]);
    }
    __syncthreads();
    width = half;
  }
}

// Voxels of item k of a sample whose items hold `rows` voxels, only the
// last one short.
__device__ __forceinline__ float item_count(int k, int rows, int S) {
  return (float)min((long long)rows, (long long)S - (long long)k * rows);
}

// Merge items [k_begin, k_end) of one sample for channels c0 .. c0 + ncols
// - 1, Q channels a load.  Item k's (mean, M2) are at src[(base + k) * C +
// c] and src[(n_src + base + k) * C + c]; they were written by other CTAs of
// this launch, so they are read from L2.  Lane l of a column of Q channels
// takes items k_begin + l, + lanes, ... in order, U items' loads in
// flight, then the lanes merge up the tree; each channel's (n, mean, M2)
// ends in lane 0's entries.
template <int Q>
__device__ void merge_items_q(Entries& e, const float* src, long long n_src, long long base,
                              int k_begin, int k_end, int rows, int S, int C, int c0,
                              int ncols) {
  using Vec = typename std::conditional<Q == 4, float4, float>::type;
  constexpr int U = Q == 4 ? kFoldLoads / 2 : kFoldLoads;
  const int nq = ncols / Q, lanes = max(1, (int)blockDim.x / nq);
  for (int i = threadIdx.x; i < lanes * nq; i += blockDim.x) {
    const int l = i / nq, c = (i - l * nq) * Q;
    const float* mp = src + base * C + c0 + c;
    const float* qp = mp + n_src * C;
    float n = 0.0f, mean[Q], m2[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) mean[j] = m2[j] = 0.0f;
    auto merge = [&](int k, const Vec& mv, const Vec& qv) {
      const float nk = item_count(k, rows, S);
      const float* mk = reinterpret_cast<const float*>(&mv);
      const float* qk = reinterpret_cast<const float*>(&qv);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        float nj = n;
        chan(nj, mean[j], m2[j], nk, mk[j], qk[j]);
      }
      n += nk;
    };
    auto load = [&](const float* p, int k) {
      return __ldcg(reinterpret_cast<const Vec*>(p + (long long)k * C));
    };
    int k = k_begin + l;
    for (; k + (U - 1) * lanes < k_end; k += U * lanes) {
      Vec mv[U], qv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        mv[u] = load(mp, k + u * lanes);
        qv[u] = load(qp, k + u * lanes);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) merge(k + u * lanes, mv[u], qv[u]);
    }
    for (; k < k_end; k += lanes) merge(k, load(mp, k), load(qp, k));
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      e.n[l * ncols + c + j] = n;
      e.mean[l * ncols + c + j] = mean[j];
      e.m2[l * ncols + c + j] = m2[j];
    }
  }
  merge_lanes(e, lanes, ncols, ncols);
}

__device__ void merge_items(Entries& e, const float* src, long long n_src, long long base,
                            int k_begin, int k_end, int rows, int S, int C, int c0,
                            int ncols) {
  if (ncols % 4 == 0 && C % 4 == 0 && c0 % 4 == 0)
    merge_items_q<4>(e, src, n_src, base, k_begin, k_end, rows, S, C, c0, ncols);
  else
    merge_items_q<1>(e, src, n_src, base, k_begin, k_end, rows, S, C, c0, ncols);
}

// Write one merged partial per channel (lane 0's entries) as item `item`
// of a [2, n_items, C] array.
__device__ void write_partial(const Entries& e, float* dst, long long n_items, long long item,
                              int C, int c0, int ncols) {
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    dst[item * C + c0 + c] = e.mean[c];
    dst[(n_items + item) * C + c0 + c] = e.m2[c];
  }
}

// Fold lane 0's entries (a sample's S voxels) with gamma/beta into the
// columns of sample b: out[0][b][c], out[1][b][c]; in moments mode the
// entries' (mean, M2) themselves.
__device__ void write_columns(const Entries& e, const Affine& af, float* out, int B, int b, int S,
                              int C, int c0, int ncols, float eps, int moments) {
  const int row = af.mode == 2 ? min(max(af.styles[b], 0), af.n_styles - 1) : 0;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const float mean = e.mean[c];
    if (moments) {
      out[(long long)b * C + c0 + c] = mean;
      out[((long long)B + b) * C + c0 + c] = e.m2[c];
      continue;
    }
    const float inv = 1.0f / sqrtf(fmaxf(e.m2[c] / (float)S, 0.0f) + eps);
    float scale = inv, shift = -mean * inv;
    if (af.mode != 0) {
      const long long i = (long long)row * C + c0 + c;
      scale = inv * param(af.gamma, af.dtype, i);
      shift = param(af.beta, af.dtype, i) - mean * scale;
    }
    out[(long long)b * C + c0 + c] = scale;
    out[((long long)B + b) * C + c0 + c] = shift;
  }
}

// Called by every thread once this CTA's partial is written: true in the
// last of `expected` CTAs sharing *counter, which resets it to 0.
__device__ bool arrive_last(int* counter, int expected) {
  __shared__ int last;
  __threadfence();   // this CTA's partial is visible device-wide before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;   // every CTA has arrived: ready for the next launch
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

struct StatsArgs {
  const void* x;        // [B, S, C]
  float* part;          // [2, B * n_chunks, C]: (mean, M2) per (chunk, channel); null for one chunk
  float* out;           // [2, B, C]: scale, shift
  int* counters;        // [B * n_cblocks], all 0 between launches; null for one chunk
  Affine af;
  int B, S, C, rows, n_chunks, block_c, n_cblocks;
  float eps;
  int moments;          // write (mean, M2) in place of the columns
};

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 3)
miseg_k1_stats(StatsArgs a) {
  __shared__ Entries e;
  const int chunk = blockIdx.x, cblk = blockIdx.y, b = blockIdx.z;
  const int c0 = cblk * a.block_c, ncols = min(a.block_c, a.C - c0);
  const int groups = a.block_c / V, lanes = blockDim.x / groups;
  const int g = threadIdx.x % groups, lane = threadIdx.x / groups;
  const long long r0 = (long long)chunk * a.rows;
  const long long r1 = min((long long)a.S, r0 + a.rows);
  float n = 0.0f, mean[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.0f;
  if (g * V < ncols) {
    const T* x = static_cast<const T*>(a.x) + (long long)b * a.S * a.C + c0 + g * V;
    // a step: this lane's next kUnroll rows (fewer at the chunk's end), all
    // loads in flight at once; their sub-tile's mean and M2 two-pass per
    // channel, then Chan's merge into the running (mean, M2)
    for (long long r = r0 + lane; r < r1; r += (long long)kUnroll * lanes) {
      const int cnt = (int)min((long long)kUnroll, (r1 - r + lanes - 1) / lanes);
      Raw<T, V> raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < cnt) raw[u] = load_raw<T, V>(x + (r + (long long)u * lanes) * a.C);
      const float fc = (float)cnt, f = fc / (n + fc), w = n * f, inv = 1.0f / fc;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float v[kUnroll], s = 0.0f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = u < cnt ? element<T, V>(raw[u], k) : 0.0f;
          s += v[u];
        }
        const float tm = s * inv;
        float tm2 = 0.0f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float d = u < cnt ? v[u] - tm : 0.0f;
          tm2 = fmaf(d, d, tm2);
        }
        const float d = tm - mean[k];
        mean[k] = fmaf(d, f, mean[k]);
        m2[k] = m2[k] + tm2 + d * d * w;
      }
      n += fc;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {   // entries [lane][block_c]
    const int i = lane * a.block_c + g * V + k;
    e.n[i] = n;
    e.mean[i] = mean[k];
    e.m2[i] = m2[k];
  }
  merge_lanes(e, (int)min((long long)lanes, r1 - r0), a.block_c, ncols);   // lanes that saw rows
  if (a.n_chunks == 1) {
    write_columns(e, a.af, a.out, a.B, b, a.S, a.C, c0, ncols, a.eps, a.moments);
    return;
  }
  const long long n_parts = (long long)a.B * a.n_chunks;
  write_partial(e, a.part, n_parts, (long long)b * a.n_chunks + chunk, a.C, c0, ncols);
  if (!arrive_last(a.counters + (long long)b * a.n_cblocks + cblk, a.n_chunks)) return;
  merge_items(e, a.part, n_parts, (long long)b * a.n_chunks, 0, a.n_chunks, a.rows, a.S, a.C,
              c0, ncols);
  write_columns(e, a.af, a.out, a.B, b, a.S, a.C, c0, ncols, a.eps, a.moments);
}

struct FoldArgs {
  const float* part;    // [2, B * n_tiles, C]: K4's (mean, M2) per tile
  float* work;          // [2, B * n_groups, C]: one partial per group; null for one group
  float* out;           // [2, B, C]: scale, shift
  int* counters;        // [B * n_cblocks], all 0 between launches; null for one group
  Affine af;
  int B, S, C, rows, n_tiles, group, n_groups, block_c, n_cblocks;
  float eps;
  int moments;          // write (mean, M2) in place of the columns
};

__global__ void __launch_bounds__(kMaxThreads)
miseg_k1_fold(FoldArgs a) {
  __shared__ Entries e;
  const int grp = blockIdx.x, cblk = blockIdx.y, b = blockIdx.z;
  const int c0 = cblk * a.block_c, ncols = min(a.block_c, a.C - c0);
  const int first = grp * a.group, end = min(a.n_tiles, first + a.group);
  merge_items(e, a.part, (long long)a.B * a.n_tiles, (long long)b * a.n_tiles, first, end, a.rows,
              a.S, a.C, c0, ncols);
  if (a.n_groups == 1) {
    write_columns(e, a.af, a.out, a.B, b, a.S, a.C, c0, ncols, a.eps, a.moments);
    return;
  }
  const long long n_work = (long long)a.B * a.n_groups;
  write_partial(e, a.work, n_work, (long long)b * a.n_groups + grp, a.C, c0, ncols);
  if (!arrive_last(a.counters + (long long)b * a.n_cblocks + cblk, a.n_groups)) return;
  merge_items(e, a.work, n_work, (long long)b * a.n_groups, 0, a.n_groups, a.rows * a.group, a.S,
              a.C, c0, ncols);
  write_columns(e, a.af, a.out, a.B, b, a.S, a.C, c0, ncols, a.eps, a.moments);
}

template <typename T>
cudaError_t launch_stats(const StatsArgs& a, int vec, int threads, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const dim3 grid((unsigned)a.n_chunks, (unsigned)a.n_cblocks, (unsigned)a.B);
  if (vec == W)
    miseg_k1_stats<T, W><<<grid, threads, 0, stream>>>(a);
  else
    miseg_k1_stats<T, 1><<<grid, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool affine_ok(const Affine& af) {
  if (af.mode == 0) return true;
  if (af.gamma == nullptr || af.beta == nullptr || af.dtype < 0 || af.dtype > 2) return false;
  return af.mode == 1 || (af.mode == 2 && af.styles != nullptr && af.n_styles >= 1);
}

Affine make_affine(const void* gamma, const void* beta, int gamma_dtype, int gamma_mode,
                   const void* styles, int n_styles) {
  Affine af;
  af.gamma = gamma;
  af.beta = beta;
  af.styles = static_cast<const int*>(styles);
  af.dtype = gamma_dtype;
  af.mode = gamma_mode;
  af.n_styles = n_styles;
  return af;
}

}  // namespace

// x: a contiguous [B, S, C] of dtype 0 = float32, 1 = bfloat16, 2 =
// float16, 16-byte aligned when vec > 1; vec: channels a load (16 bytes'
// worth, dividing C and block_c) or 1.  The grid (see
// fused_norm.stats_grid): row chunks of `rows` rows, channel blocks of
// block_c channels, `threads` a CTA, a multiple of block_c / vec, at most
// 256, with threads * vec <= 2048.  part: f32 [2, B * n_chunks, C], and
// counters: B * ceil(C / block_c) ints, all 0 (both null when n_chunks ==
// 1).  gamma/beta: null (mode 0), [C] (mode 1) or [n_styles, C] (mode 2,
// with int32 styles [B], clamped) of gamma_dtype (0, 1, 2 as x).  out: f32
// [2, B, C], scale then shift; with moments != 0 (gamma_mode 0) the mean
// and M2 instead.  Returns the CUDA error of the launch.
extern "C" int miseg_k1_stats(const void* x, int dtype, int vec, void* part, const void* gamma,
                              const void* beta, int gamma_dtype, int gamma_mode,
                              const void* styles, int n_styles, void* out, void* counters, int B,
                              int S, int C, int rows, int n_chunks, int block_c, int threads,
                              float eps, int moments, void* stream) {
  const int width = dtype == 0 ? 4 : 8;
  const Affine af = make_affine(gamma, beta, gamma_dtype, gamma_mode, styles, n_styles);
  if (B < 1 || S < 1 || C < 1 || rows < 1 || n_chunks < 1 || block_c < 1 || dtype < 0 ||
      dtype > 2 || (vec != 1 && vec != width) || block_c % vec || (vec > 1 && C % vec) ||
      threads < 1 || threads > kMaxThreads || threads % (block_c / vec) ||
      threads * vec > kMaxEntries || block_c > kMaxEntries ||
      (long long)(n_chunks - 1) * rows >= S || (long long)n_chunks * rows < S ||
      (n_chunks > 1 && (part == nullptr || counters == nullptr)) || !affine_ok(af) ||
      (moments && af.mode != 0))
    return (int)cudaErrorInvalidValue;
  StatsArgs a;
  a.x = x;
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  a.counters = static_cast<int*>(counters);
  a.af = af;
  a.B = B;
  a.S = S;
  a.C = C;
  a.rows = rows;
  a.n_chunks = n_chunks;
  a.block_c = block_c;
  a.n_cblocks = (C + block_c - 1) / block_c;
  a.eps = eps;
  a.moments = moments;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_stats<float>(a, vec, threads, st);
  if (dtype == 1) return (int)launch_stats<__nv_bfloat16>(a, vec, threads, st);
  return (int)launch_stats<__half>(a, vec, threads, st);
}

// part: K4's f32 [2, B * n_tiles, C] (mean, M2) of tiles of `rows` voxels,
// only a sample's last tile short.  Groups of `group` tiles, block_c
// channels a CTA (see fused_norm.fold_grid).  work: f32 [2, B * n_groups,
// C] and counters: B * ceil(C / block_c) ints, all 0 (both null when
// n_groups == 1).  gamma/beta/styles, out and moments as miseg_k1_stats.
extern "C" int miseg_k1_fold(const void* part, void* work, const void* gamma, const void* beta,
                             int gamma_dtype, int gamma_mode, const void* styles, int n_styles,
                             void* out, void* counters, int B, int S, int C, int rows,
                             int n_tiles, int group, int block_c, float eps, int moments,
                             void* stream) {
  const Affine af = make_affine(gamma, beta, gamma_dtype, gamma_mode, styles, n_styles);
  if (B < 1 || S < 1 || C < 1 || rows < 1 || n_tiles < 1 || group < 1 || block_c < 1 ||
      block_c > kMaxEntries || (long long)(n_tiles - 1) * rows >= S ||
      (long long)n_tiles * rows < S || !affine_ok(af) || (moments && af.mode != 0))
    return (int)cudaErrorInvalidValue;
  FoldArgs a;
  a.part = static_cast<const float*>(part);
  a.work = static_cast<float*>(work);
  a.out = static_cast<float*>(out);
  a.counters = static_cast<int*>(counters);
  a.af = af;
  a.B = B;
  a.S = S;
  a.C = C;
  a.rows = rows;
  a.n_tiles = n_tiles;
  a.group = group;
  a.n_groups = (n_tiles + group - 1) / group;
  a.block_c = block_c;
  a.n_cblocks = (C + block_c - 1) / block_c;
  a.eps = eps;
  a.moments = moments;
  if (a.n_groups > 1 && (work == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.n_groups, (unsigned)a.n_cblocks, (unsigned)B);
  miseg_k1_fold<<<grid, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
